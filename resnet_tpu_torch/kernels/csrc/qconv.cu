// The int8 (W8A8) serving kernels of quantize.py, neither of which has a
// Pallas counterpart: JAX leaves both to XLA.
//
// Q1, rt_qconv_s8: an int8 NHWC conv (or the FC, as a 1x1 conv over a
// (N, 1, 1, K) view) with int32 accumulation and its dequantizing epilogue.
// Replaces resnet_tpu/quantize.py::_qconv (:218, XLA's conv_general_dilated
// or dot_general with preferred_element_type int32), the dequantization of
// _qsite (:243-247) and the FC's dot_general and dequantization
// (:279-287). PyTorch has no int8 convolution on CUDA, so the port needs
// this kernel whatever it costs.
//
//   acc[m, co] = sum_k A[m, k] * w[co, k]            (int32, exact)
//   v = __fadd_rn(__fmul_rn(__int2float_rn(acc), dq[co]), bias[co])
//   mode 0: bf16(v); mode 1: clip(relu(bf16(v)), cap); mode 2: v (fp32)
//
// dq = ws * scale is the wrapper's fp32 row, as JAX orders it; the
// multiply and add are written as intrinsics so nvcc cannot contract them
// into an FMA, which would change the bits against the plain version. ReLU
// and the cap act on the bf16 value (quantize.py's _relu after _qsite).
//
// The GEMM is an implicit im2col: row m is output pixel (n, oy, ox), and
// the window's kernel row di is the KW * Cin bytes x[n, s*oy - pad_top + di,
// s*ox - pad_left + [0, KW), :], which lie next to each other in NHWC, so K
// is KH kernel rows of Rp = KW * Cin rounded up to 16 bytes (the same as
// the plain (di, dj, ci) order wherever Cin % 16 == 0; the stem's 21-byte
// rows take 32), 0 outside the image, past a row's KW * Cin and past K.
// The reference's centred windows (the stem's (3, 2)) and a 1x1/s2 conv
// (JAX's subsample-then-dot) take one path. The weight is packed in the
// same K order, (Cout, Kp) K-major, zero in the rows' padding and from K =
// KH * Rp up to Kp, a multiple of 64 (quant.pack_weight, once per site).
//
// On wgb_gemm.cuh's warp-specialized loop (wgb::specialized) under its s8
// policy: copying warpgroups gather A and ask TMA for B, two multiplying
// warpgroups take 64 rows each of a 128-row tile. Both operands lie K-major
// in 128-byte-swizzled shared memory, a slice 128 int8 deep (one swizzle
// row), four wgmma.mma_async.m64nBNk32.s32.s8.s8 a slice chained into the
// int32 accumulator. Tiles 128 x BN, BN = 64, 128 or 256 (build.qconv_plan):
// at 64 and 128 two warpgroups copy (512 threads, 128 registers each); at
// 256 one does (384 threads), so that the multipliers may hold m64n256's
// 128 accumulator registers (wgb::WsRegs). Ring slots: 8, 5 and 3, beside
// the staged output tile. The copiers' A: where Cin % 16 == 0 and x is
// 16-byte aligned, a 16-byte chunk is 16 channels of one tap, one cp.async
// (zeros outside the image); else (the stem, ragged Cin, a misaligned x) a
// chunk is 16 bytes of one kernel row, read as the aligned words that hold
// its bytes inside the image (four rows' words loaded before any is used),
// shifted into place, masked and stored: no per-byte loop. B, the packed
// weight, comes by TMA, one 128 x BN box a slice (zeros past Kp and Cout);
// where every unit takes the same B slices (one tile column, one split)
// and they fit the ring, each block loads them once, in its first unit,
// and keeps them in the ring's B regions (resident_b). On wgb::persistent,
// whose one thread stream copies and multiplies in turn, every case
// measured was slower (PERF.md).
//
// Persistent with K splits: one block per SM walks the units (m tile, n
// tile, K split), n tile fastest, and the ring runs across unit boundaries.
// The tile width and split count are the wrapper's (build.qconv_plan, a
// function of the shapes fitted to the card's times: each split whole
// slices, none empty). Integer sums are exact in any order, so neither the
// tiling nor the splits change a bit: a split unit stores its int32 partial
// tile into its slot of the scratch ws (coalesced 16-byte stores), then
// takes its tile's ticket; the unit that takes it last adds the other
// splits' partials to its own, zeroes the ticket and runs the epilogue. A
// call is one launch, and the tickets are zero again when it ends.
//
// The epilogue (the multiplying warpgroups, while the copiers fill the ring
// for the next unit) stages the unit's dq and bias columns and a bf16 tile
// in shared memory (128-byte swizzled rows); the tile leaves by TMA where
// Cout % 8 == 0 and the output is 16-byte aligned, else in row stores; the
// FC's fp32 logits go straight from the registers. Bound: the int8
// tensor-core rate (1,979 TOP/s dense) for the 3x3s and the deep 1x1s, the
// bytes written for the 1x1s at 56^2 and the stem; in practice a 128-row
// tile's operands through the L2, the per-slice handoffs and the epilogue
// share the time (PERF.md, q1_variants).
//
// Q3, rt_qconv_grouped_s8: Q1 for a grouped conv (ResNeXt's 3x3s, groups
// > 1). Replaces _qconv with feature_group_count (quantize.py:218-238)
// and _qsite's dequantization, as Q1 does for the rest. A group's problem
// (M x Cout/g over kh * kw * Cin/g: ResNeXt-50 32x4d's K 36-288, N 4-32)
// is far narrower than a wgmma tile, so Q3 runs on the CUDA cores: __dp4a
// sums 4 channels a word in int32, one thread per (4 pixels, 4 outputs of
// a group), Q1's epilogue bit for bit. Bound by bytes (x read, the bf16
// output written) at ResNeXt's widths; this first design does not reach
// it (PERF.md).
//
// Q2, rt_quant_act_{f32,bf16}: q = clip(rint(__fmul_rn(x, inv)), -127, 127)
// as int8, inv = 1 / scale in fp32 (the wrapper's). Replaces
// resnet_tpu/quantize.py::_quant_act (:213); rintf rounds half to even, as
// jnp.round does. Bound by device memory (4 or 2 bytes read and 1 written
// a value): 16 values a thread through 16-byte loads and one 16-byte
// store where the pointers allow, one value at a time for the rest.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

#include "rowwise.cuh"
#include "wgb_gemm.cuh"

namespace {

constexpr int BM = wgb::BM;
constexpr int SK = 2 * wgb::BK;  // int8 a slice: one 128-byte swizzle row
constexpr int THREADS = wgb::THREADS;
constexpr int RUN = 16;          // a kernel row's bytes in K are padded to a multiple of it
constexpr int KP_ALIGN = 64;     // the packed weight's row length is a multiple of it

enum Mode { OUT_BF16 = 0, OUT_BF16_RELU = 1, OUT_F32 = 2 };

// ring slots by tile width (the ring, the staged bf16 tile and the copies'
// record, here the unit's dq and bias columns, fit the 232,448 bytes a
// block may take), and the copying threads: two warpgroups, or at BN = 256
// one (wgb::WsRegs)
template <int BN>
struct QTile {
  static constexpr int S = BN == 256 ? 3 : BN == 128 ? 5 : 8;
  static constexpr int SMEM = wgb::PTile<BN, S>::SMEM;
  static_assert(SMEM + 1024 <= 232448, "Q1's shared memory");
  static constexpr int NC = BN == 256 ? 128 : wgb::COPIERS;
  static constexpr int THREADS_ALL = NC + THREADS;
};

struct QConv {
  const int8_t* x;
  const float* dq;
  const float* bias;  // null: no bias (the FC without one)
  void* out;
  int* ws;       // int32 split partials, tiles x splits x BM x BN (splits > 1)
  int* tickets;  // one per tile, zero at rest (splits > 1)
  int64_t M;
  int H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, HoWo, Wo;
  int Rp;  // a kernel row's bytes in K: KW * Cin rounded up to RUN
  int K;   // KH * Rp
  int n_tiles, splits, mode, has_cap;
  float cap;
  // every unit of the launch takes the same B slices (one tile column, one
  // split) and they fit the ring: each block keeps them (resident_b)
  int resident_b;
};

// the bf16 bits of v0 (low half) and v1 (high half), each rounded to
// nearest even, then in mode 1 ReLU and the cap on the bf16 value: a value
// below 0 becomes +0, then one above the cap the cap's bf16 (capb); NaN and
// -0 pass, as the plain version's comparisons let them
__device__ __forceinline__ uint32_t to_act2(const QConv& p, float v0, float v1, float capf,
                                            uint32_t capb) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  uint32_t lo = __bfloat16_as_ushort(h2.x), hi = __bfloat16_as_ushort(h2.y);
  if (p.mode == OUT_BF16_RELU) {
    auto act = [&](uint32_t& h) {
      float f = __uint_as_float(h << 16);
      if (f < 0.f) {
        f = 0.f;
        h = 0u;
      }
      if (p.has_cap && f > capf) h = capb;
    };
    act(lo);
    act(hi);
  }
  return lo | hi << 16;
}

// bytes [lo, hi) of a 4-byte word kept, the rest zero (lo, hi clamped to [0, 4])
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, int lo, int hi) {
  lo = lo < 0 ? 0 : lo > 4 ? 4 : lo;
  hi = hi < 0 ? 0 : hi > 4 ? 4 : hi;
  if (hi <= lo) return 0u;
  const uint32_t m = (uint32_t)((1ull << (8 * hi)) - 1) & ~(uint32_t)((1ull << (8 * lo)) - 1);
  return v & m;
}

// One block's copies for qconv_kernel (wgb::specialized's Block), by NC
// copying threads. Thread t copies 16-byte chunk column cc = t % 8 of rows
// t / 8 + (NC / 8) i, i < 1024 / NC, of each 128 x 128 slice of A into the
// swizzled slot; thread 0 asks TMA for B's box. kVec: a chunk is 16
// channels of one tap, a cp.async. Otherwise a chunk is 16 bytes of one
// kernel row of the window (K's padded rows): the aligned words that hold
// its bytes inside the image, funnel-shifted into place, the bytes outside
// (left or right of the image, past KW * Cin) zeroed, one 16-byte shared
// store.
template <int BN, bool kVec, int NC>
struct QGather {
  static constexpr int R = BM * 8 / NC;  // the thread's rows: rlo + (NC / 8) i, i < R
  const QConv& p;
  const CUtensorMap* wmap;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  const int cc, rlo;
  int col0 = 0;
  int64_t k_lo = 0;
  int64_t off[R];  // kVec: x's offset of the row's image; else of its window's top-left byte
  int iy[R];       // the window's first image row (-2^29: a row past M)
  int ix[R];       // kVec: its first image column; else the row's bytes [ix >> 16, ix & 0xffff)
                   // of a kernel row inside the image
  int64_t k;       // the K column of the thread's chunk in the next slice
  int di, dj, ci;  // kVec: its tap and channel; else di, and dj the chunk's byte in the row
  int units = 0;   // units started

  __device__ QGather(const QConv& p_, const CUtensorMap* wmap_, const wgb::Smem<BN>& sm_,
                     uint64_t* full_)
      : p(p_), wmap(wmap_), sm(sm_), full(full_), cc(threadIdx.x & 7), rlo(threadIdx.x >> 3) {}

  __device__ void start(int64_t row0, int c, int64_t k0, int64_t, int) {
    col0 = c;
    k_lo = k0;
    ++units;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t m = row0 + rlo + NC / 8 * i;
      off[i] = 0;
      iy[i] = -(1 << 29);
      ix[i] = 0;
      if (m < p.M) {  // M < 2^31 (rt_qconv_s8): 32-bit divisions
        const int n = (int)m / p.HoWo;
        const int rem = (int)m - n * p.HoWo;
        const int oy = rem / p.Wo;
        const int x0 = p.stride * (rem - oy * p.Wo) - p.pad_left;
        iy[i] = p.stride * oy - p.pad_top;
        off[i] = (int64_t)n * p.H * p.W * p.Cin;
        if constexpr (kVec) {
          ix[i] = x0;
        } else {
          off[i] += ((int64_t)iy[i] * p.W + x0) * p.Cin;
          const int lo = (x0 < 0 ? -x0 : 0) * p.Cin;
          const int hi = (p.W - x0 < p.KW ? p.W - x0 : p.KW) * p.Cin;
          ix[i] = lo << 16 | (hi > lo ? hi : lo);
        }
      }
    }
    k = k0 + RUN * cc;
    if constexpr (kVec) {
      const int tap = (int)(k / p.Cin);
      ci = (int)(k - (int64_t)tap * p.Cin);
      di = tap / p.KW;
      dj = tap - di * p.KW;
    } else {
      di = (int)(k / p.Rp);
      dj = (int)(k - (int64_t)di * p.Rp);
    }
  }

  __device__ void load(int slot, int kt) {
    uint8_t* st = sm.slot(slot);
    const uint32_t sa = rt::tc::smem_u32(st);
    if constexpr (kVec) {
      const bool kin = k < p.K;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int y = iy[i] + di, xx = ix[i] + dj;
        const bool ok = kin && (unsigned)y < (unsigned)p.H && (unsigned)xx < (unsigned)p.W;
        const int8_t* src = ok ? p.x + off[i] + ((int64_t)y * p.W + xx) * p.Cin + ci : p.x;
        wgb::cp16(sa + wgb::swz(rlo + NC / 8 * i, cc), src, ok);
      }
      for (ci += SK; ci >= p.Cin; ci -= p.Cin)
        if (++dj == p.KW) {
          dj = 0;
          ++di;
        }
    } else {
      const bool kin = k < p.K && di < p.KH;
      const int64_t krow = (int64_t)di * p.W * p.Cin + dj;  // the chunk's offset in a window
      // four rows at a time, their words all loaded before any is shifted or stored
#pragma unroll
      for (int i0 = 0; i0 < R; i0 += 4) {
        uint32_t wd[4][5];
        int vlo[4], vhi[4], sh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j;
          const int y = iy[i] + di;
          // the chunk's bytes inside the image: [vlo, vhi) of [0, 16)
          vlo[j] = (ix[i] >> 16) - dj;
          vhi[j] = (ix[i] & 0xffff) - dj;
          if (!(kin && (unsigned)y < (unsigned)p.H)) vhi[j] = vlo[j];
          // chunk byte b is x's byte at + b
          const uintptr_t at = (uintptr_t)(p.x + off[i] + krow);
          const uint32_t* w4 = reinterpret_cast<const uint32_t*>(at & ~(uintptr_t)3);
          sh[j] = (int)(at & 3);
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            // word q holds the chunk's bytes [4q - sh, 4q - sh + 4)
            const bool need = 4 * q - sh[j] < vhi[j] && 4 * q - sh[j] + 4 > vlo[j] &&
                              vlo[j] < vhi[j];
            wd[j][q] = need ? __ldg(w4 + q) : 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t out[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            out[q] = keep_bytes(__funnelshift_r(wd[j][q], wd[j][q + 1], 8 * sh[j]),
                                vlo[j] - 4 * q, vhi[j] - 4 * q);
          *reinterpret_cast<uint4*>(st + wgb::swz(rlo + NC / 8 * (i0 + j), cc)) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
      for (dj += SK; dj >= p.Rp; dj -= p.Rp) ++di;
    }
    k += SK;
    if (threadIdx.x == 0) {
      if (p.resident_b && units > 1) {  // B is in the ring since the first unit
        rt::wg::mbar_expect_tx(&full[slot], 0);
      } else {
        const uint32_t bar = rt::tc::smem_u32(&full[slot]);
        rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::B_BYTES);
        wgb::tma_2d(sa + wgb::Tile<BN>::A_BYTES, wmap, bar, (int)(k_lo + (int64_t)kt * SK),
                    col0);
      }
    }
  }

  // the slot whose B region holds slice kt's: with resident_b, the first
  // unit's slot kt (its slices took the ring's slots 0 .. nk - 1 in turn,
  // and no later unit loads B)
  __device__ int b_slot(int slot, int kt) const { return p.resident_b ? kt : slot; }

  __device__ void fix(int = 0, int = 0) const {}

  // wgb::specialized: the thread's part of a slot handed over once its
  // copies have landed (the byte path's shared stores fenced into the async
  // proxy first)
  __device__ void publish(uint64_t* bar) const {
    if constexpr (kVec) {
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       rt::tc::smem_u32(bar))
                   : "memory");
    } else {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgb::mbar_arrive(bar);
    }
  }
};

// Unit (row0, col0, split z)'s epilogue, acc its sum over the unit's K
// range, run by the crew C (the 256 threads that hold the accumulators). A
// split unit stores its int32 partial tile into ws (split z's slot of the
// tile, each thread's values as int4 vectors, vector v of thread t at v *
// 256 + t) and takes its tile's ticket; only the last goes on, adding the
// other splits' partials to its own (exact in any order) and zeroing the
// ticket. A thread whose rows are all past M stores and reads nothing (its
// sums are 0). Then the dequantization with the unit's dq and bias columns
// staged in `table` (loaded again only when the block's tile column moves:
// table_col0), and bf16 through the staged tile `stage` (by TMA
// through ymap where there is one, else in row stores) or fp32 from the
// registers.
template <int BN, class C>
__device__ __forceinline__ void qconv_epilogue(const QConv& p, const CUtensorMap* ymap,
                                               const int (&acc)[BN / 2], uint8_t* stage,
                                               float* table, int* table_col0, int* last,
                                               int64_t row0, int col0, int z) {
  constexpr int NACC = BN / 2;
  const int tid = C::tid(), warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t r0 = row0 + warp * 16 + gid;  // the thread's rows r0 and r0 + 8
  int a[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) a[i] = acc[i];
  if (p.splits > 1) {
    const int tile = (int)(row0 / BM) * p.n_tiles + col0 / BN;
    int4* part = reinterpret_cast<int4*>(p.ws) + (int64_t)tile * p.splits * (BM * BN / 4);
    constexpr int V = NACC / 4;  // int4 vectors a thread
    if (r0 < p.M)
#pragma unroll
      for (int v = 0; v < V; ++v)
        __stcg(part + ((int64_t)z * V + v) * THREADS + tid,
               make_int4(a[4 * v], a[4 * v + 1], a[4 * v + 2], a[4 * v + 3]));
    __threadfence();
    C::sync();
    if (tid == 0) *last = atomicAdd(p.tickets + tile, 1) == p.splits - 1;
    C::sync();
    if (!*last) return;
    __threadfence();
    if (r0 < p.M)
      for (int s2 = 0; s2 < p.splits; ++s2) {
        if (s2 == z) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int4 q = __ldcg(part + ((int64_t)s2 * V + v) * THREADS + tid);
          a[4 * v] += q.x;
          a[4 * v + 1] += q.y;
          a[4 * v + 2] += q.z;
          a[4 * v + 3] += q.w;
        }
      }
    if (tid == 0) p.tickets[tile] = 0;
  }
  // the previous unit's tile has left the stage (its TMA store has read it)
  if (ymap && tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  C::sync();
  if (*table_col0 != col0) {  // the table holds another tile's columns
    for (int c = tid; c < BN; c += THREADS) {
      const bool in = col0 + c < p.Cout;
      table[c] = in ? __ldg(p.dq + col0 + c) : 0.f;
      table[BN + c] = in && p.bias ? __ldg(p.bias + col0 + c) : 0.f;
    }
    C::sync();
    if (tid == 0) *table_col0 = col0;
  }
  const float2* dq2 = reinterpret_cast<const float2*>(table);
  const float2* b2 = reinterpret_cast<const float2*>(table + BN);
  const bool has_bias = p.bias != nullptr;
  // f32(acc) * dq, + bias, each step rounded (no FMA)
  auto deq = [&](int v, float d, float bb) {
    const float f = __fmul_rn(__int2float_rn(v), d);
    return has_bias ? __fadd_rn(f, bb) : f;
  };
  if (p.mode == OUT_F32) {
    float* y = static_cast<float*>(p.out);
    const bool pairs = p.Cout % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = r0 + 8 * h;
      if (gm >= p.M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gc = col0 + 8 * j + 2 * tig;
        const float2 d = dq2[4 * j + tig], bb = b2[4 * j + tig];
        const float v0 = deq(a[4 * j + 2 * h], d.x, bb.x);
        const float v1 = deq(a[4 * j + 2 * h + 1], d.y, bb.y);
        float* o = y + gm * p.Cout + gc;
        if (pairs && gc + 1 < p.Cout) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (gc < p.Cout) o[0] = v0;
          if (gc + 1 < p.Cout) o[1] = v1;
        }
      }
    }
    return;
  }
  const __nv_bfloat16 caph = __float2bfloat16_rn(p.cap);
  const float capf = __bfloat162float(caph);
  const uint32_t capb = __bfloat16_as_ushort(caph);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 d = dq2[4 * j + tig], bb = b2[4 * j + tig];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + gid + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + (j / 8) * BM * 128 + wgb::swz(r, j % 8) + 4 * tig) =
          to_act2(p, deq(a[4 * j + 2 * h], d.x, bb.x), deq(a[4 * j + 2 * h + 1], d.y, bb.y),
                  capf, capb);
    }
  }
  if (ymap) {  // the staged tile out by TMA (rows past M and columns past Cout clipped)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    C::sync();
    if (tid == 0) {
#pragma unroll
      for (int hb = 0; hb < BN / 64; ++hb)
        asm volatile(
            "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                (uint64_t)ymap),
            "r"(rt::tc::smem_u32(stage + hb * BM * 128)), "r"(col0 + 64 * hb), "r"((int)row0)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    return;
  }
  C::sync();
  constexpr int CH = BN / 8;  // 16-byte chunks a row
  uint16_t* y = static_cast<uint16_t*>(p.out);
  const bool vec = p.Cout % 8 == 0 && rt::aligned16(y);
  const int j = tid % CH, c = col0 + 8 * j;
#pragma unroll 4
  for (int i = 0; i < BM * CH / THREADS; ++i) {
    const int r = tid / CH + THREADS / CH * i;
    const int64_t gm = row0 + r;
    if (gm >= p.M || c >= p.Cout) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + (j / 8) * BM * 128 + wgb::swz(r, j % 8));
    if (vec) {
      *reinterpret_cast<uint4*>(y + gm * p.Cout + c) = v;
    } else {
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < p.Cout) y[gm * p.Cout + c + e] = (uint16_t)(w4[e / 2] >> (16 * (e % 2)));
    }
  }
}

// Q1 over the units of un on wgb::specialized: the (Cout, Kp) weight through
// wmap, a bf16 output through ymap where `tma`
template <int BN, bool kVec>
__global__ void __launch_bounds__(QTile<BN>::THREADS_ALL, 1)
qconv_kernel(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap ymap,
             const __grid_constant__ QConv p, const wgb::Units un, int tma) {
  constexpr int S = QTile<BN>::S, NC = QTile<BN>::NC;
  using C = wgb::Crew<NC>;
  extern __shared__ __align__(1024) uint8_t qconv_smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ int last, table_col0;
  const wgb::Smem<BN> sm = wgb::psmem_layout<BN, S>(qconv_smem);
  if (threadIdx.x == 0) table_col0 = -1;
  wgb::init_ws_barriers<S, NC>(full, empty);
  QGather<BN, kVec, NC> blk(p, &wmap, sm, full);
  uint8_t* stage = wgb::p_out<BN, S>(sm);
  float* table = reinterpret_cast<float*>(sm.info);  // the unit's dq, bias columns
  const CUtensorMap* y = tma ? &ymap : nullptr;
  wgb::specialized<BN, S, false, wgb::OP_S8, NC>(
      blk, sm, full, empty, un, [&](const int (&acc)[BN / 2], int64_t row0, int col0, int z) {
        qconv_epilogue<BN, C>(p, y, acc, stage, table, &table_col0, &last, row0, col0, z);
      });
  if (tma) wgb::store_tma_wait<C>();
}

template <int BN, bool kVec>
int qconv_launch(const CUtensorMap& wmap, const CUtensorMap& ymap, int tma, const QConv& p,
                 const wgb::Units& un, cudaStream_t s) {
  auto* kernel = qconv_kernel<BN, kVec>;
  constexpr int smem = QTile<BN>::SMEM;
  // the smem attribute and the SM count, once per device (bit d of ready)
  static std::atomic<uint32_t> ready{0};
  static int sms_of[32];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(ready.load(std::memory_order_acquire) >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(1u << dev, std::memory_order_release);
  }
  const int64_t units = un.count();
  kernel<<<(unsigned)(units < sms_of[dev] ? units : sms_of[dev]), QTile<BN>::THREADS_ALL, smem,
           s>>>(wmap, ymap, p, un, tma);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ Q3

// Q3, the grouped int8 conv (ResNeXt's 3x3s): output channel o of group
// g = o / Ng sums, over the window, input channels [g Cg, (g + 1) Cg) of
// x by row (tap, o) of the packed weight w (KH * KW, Cout, Cgp): Cg
// bytes, zero up to Cgp = Cg rounded up to 4 (quant.pack_weight(w, g)).
// Then Q1's epilogue step for step. A thread owns QP pixels in a row of M
// and QO neighbouring output channels of one group (a group's Ng in
// ceil(Ng / QO) chunks), so each x word it loads serves QO outputs and
// each w word QP pixels; the lanes of a warp are 32 neighbouring chunks,
// whose x words (one group's shared) and w rows lie side by side. A
// block's rows are Q3_ROWS pixel quads; grid x the quads' blocks, y the
// chunks' warps. Sums by __dp4a, 4 channels a word. Indices are 32-bit
// (the entry checks the extents): a 64-bit division is a long software
// sequence, and the first design, which decoded each pixel by one, spent
// most of its time there (PERF.md).
constexpr int QP = 4;       // pixels a thread
constexpr int QO = 4;       // output channels a thread
constexpr int Q3_ROWS = 8;  // pixel quads a block (warps)

struct QGrouped {
  const int8_t* x;
  const int8_t* w;  // (KH * KW, Cout, Cgp)
  const float* dq;
  const float* bias;  // null: no bias
  void* out;
  int M, H, W, Cin, Cout, Cg, Ng, Cgp, chunks, KH, KW, stride, pad_top, pad_left, Ho, Wo,
      mode, has_cap;
  float cap;
};

// loads of VEC bytes (16, 8 or 4: aligned words of 4 channels each), or,
// at VEC = 1, the bytes [0, min(4, left)) one at a time, zero past them
template <int VEC>
struct QWords {
  static constexpr int N = VEC >= 4 ? VEC / 4 : 1;
};

template <int VEC>
__device__ __forceinline__ void load_words(const int8_t* p, int left,
                                           int (&v)[QWords<VEC>::N]) {
  if constexpr (VEC == 16) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VEC == 8) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else if constexpr (VEC == 4) {
    v[0] = __ldg(reinterpret_cast<const int*>(p));
  } else {
    uint32_t u = 0;
    for (int b = 0; b < 4 && b < left; ++b) u |= (uint32_t)(uint8_t)__ldg(p + b) << (8 * b);
    v[0] = (int)u;
  }
}

// one bf16 value of the epilogue, as to_act2 makes each of its pair
__device__ __forceinline__ uint16_t to_act1(const QGrouped& p, float v, float capf,
                                            uint16_t capb) {
  uint16_t h = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  if (p.mode == OUT_BF16_RELU) {
    float f = __uint_as_float((uint32_t)h << 16);
    if (f < 0.f) {
      f = 0.f;
      h = 0;
    }
    if (p.has_cap && f > capf) h = capb;
  }
  return h;
}

// VEC: x's and w's loads (16, 8 or 4 bytes where Cg is a multiple of VEC
// and x is aligned to it; 1: x by bytes, w by words of its padded rows)
template <int VEC>
__global__ void __launch_bounds__(32 * Q3_ROWS) qconv_grouped_kernel(const QGrouped p) {
  constexpr int NW = QWords<VEC>::N;
  constexpr int STEP = 4 * NW;              // channels a step
  constexpr int WVEC = VEC == 1 ? 4 : VEC;  // w's rows are padded to words
  const int chunk = blockIdx.y * 32 + threadIdx.x;
  const int m0 = (blockIdx.x * Q3_ROWS + threadIdx.y) * QP;
  if (chunk >= p.chunks || m0 >= p.M) return;
  const int per_group = (p.Ng + QO - 1) / QO;
  const int g = chunk / per_group;
  const int u0 = (chunk - g * per_group) * QO;  // the chunk's first output in its group
  const int o0 = g * p.Ng + u0;
  const int nu = min(QO, p.Ng - u0);  // its outputs
  // the quad's pixels: (n, oy, ox) of m0 by one division each, then stepped
  int n = m0 / (p.Ho * p.Wo);
  int r = m0 - n * p.Ho * p.Wo;
  int oy = r / p.Wo, ox = r - oy * p.Wo;
  int iy0[QP], ix0[QP];
  const int8_t* xg[QP];  // the pixel's image at the group's first channel
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    iy0[q] = oy * p.stride - p.pad_top;
    ix0[q] = ox * p.stride - p.pad_left;
    xg[q] = m0 + q < p.M ? p.x + (int64_t)n * p.H * p.W * p.Cin + g * p.Cg : nullptr;
    if (++ox == p.Wo) {
      ox = 0;
      if (++oy == p.Ho) {
        oy = 0;
        ++n;
      }
    }
  }
  int acc[QP][QO];
#pragma unroll
  for (int q = 0; q < QP; ++q)
#pragma unroll
    for (int u = 0; u < QO; ++u) acc[q][u] = 0;
  const int tap_bytes = p.Cout * p.Cgp;
  for (int di = 0; di < p.KH; ++di)
    for (int dj = 0; dj < p.KW; ++dj) {
      const int8_t* wt = p.w + (di * p.KW + dj) * tap_bytes + o0 * p.Cgp;
      const int8_t* xp[QP];
#pragma unroll
      for (int q = 0; q < QP; ++q) {
        const int iy = iy0[q] + di, ix = ix0[q] + dj;
        xp[q] = xg[q] && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W
                    ? xg[q] + (iy * p.W + ix) * p.Cin
                    : nullptr;
      }
      for (int c = 0; c < p.Cg; c += STEP) {
        int wv[QO][NW];
#pragma unroll
        for (int u = 0; u < QO; ++u) {
          if (u < nu) {
            load_words<WVEC>(wt + u * p.Cgp + c, 4, wv[u]);
          } else {
#pragma unroll
            for (int j = 0; j < NW; ++j) wv[u][j] = 0;
          }
        }
#pragma unroll
        for (int q = 0; q < QP; ++q) {
          if (!xp[q]) continue;
          int xv[NW];
          load_words<VEC>(xp[q] + c, p.Cg - c, xv);
#pragma unroll
          for (int u = 0; u < QO; ++u)
#pragma unroll
            for (int j = 0; j < NW; ++j) acc[q][u] = __dp4a(xv[j], wv[u][j], acc[q][u]);
        }
      }
    }
  // Q1's epilogue: f32(acc) * dq, + bias, each step rounded (no FMA)
  float d[QO], bb[QO];
#pragma unroll
  for (int u = 0; u < QO; ++u) {
    d[u] = u < nu ? __ldg(p.dq + o0 + u) : 0.f;
    bb[u] = u < nu && p.bias ? __ldg(p.bias + o0 + u) : 0.f;
  }
  const __nv_bfloat16 caph = __float2bfloat16_rn(p.cap);
  const float capf = __bfloat162float(caph);
  const uint16_t capb = __bfloat16_as_ushort(caph);
#pragma unroll
  for (int q = 0; q < QP; ++q) {
    if (!xg[q]) continue;
    const int64_t at = (int64_t)(m0 + q) * p.Cout + o0;
#pragma unroll
    for (int u = 0; u < QO; ++u) {
      if (u >= nu) continue;
      const float f = __fmul_rn(__int2float_rn(acc[q][u]), d[u]);
      const float v = p.bias ? __fadd_rn(f, bb[u]) : f;
      if (p.mode == OUT_F32)
        static_cast<float*>(p.out)[at + u] = v;
      else
        static_cast<uint16_t*>(p.out)[at + u] = to_act1(p, v, capf, capb);
    }
  }
}

// ------------------------------------------------------------------ Q2

__device__ __forceinline__ uint32_t quant1(float v, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(r);
}

// 16 values a step: 16 / Vec16<T>::N loads of 16 bytes in (four fp32 or
// two bf16), one 16-byte store of int8 out
template <class T>
__global__ void quant_act_vec(const T* __restrict__ x, uint4* __restrict__ q, float inv,
                              int64_t n16) {
  using V = rt::Vec16<T>;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16 / V::N; ++j) {
      float v[V::N];
      V::load(x + 16 * i + V::N * j, v);
#pragma unroll
      for (int t = 0; t < V::N; ++t) out[(V::N * j + t) / 4] |= quant1(v[t], inv) << 8 * (t % 4);
    }
    q[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

template <class T>
__global__ void quant_act_scalar(const T* __restrict__ x, int8_t* __restrict__ q, float inv,
                                 int64_t begin, int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    q[i] = (int8_t)quant1(rt::ld(x + i), inv);
}

// the 16-byte path where x and q are 16-byte aligned, then the tail
template <class T>
int quant_act(const T* x, int8_t* q, float inv, int64_t n, cudaStream_t s) {
  const int64_t n16 = rt::aligned16(x) && rt::aligned16(q) ? n / 16 : 0;
  if (n16 > 0)
    quant_act_vec<T><<<rt::ew_blocks(n16), rt::EW_THREADS, 0, s>>>(x, (uint4*)q, inv, n16);
  if (16 * n16 < n)
    quant_act_scalar<T><<<rt::ew_blocks(n - 16 * n16), rt::EW_THREADS, 0, s>>>(x, q, inv,
                                                                               16 * n16, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Q1. x (N, H, W, Cin) int8; w (Cout, Kp) int8 K-major as quant.pack_weight
// lays it out (KH kernel rows of Rp = KW * Cin rounded up to 16 bytes, zero
// in the padding and from KH * Rp up to Kp, a multiple of 64), 16-byte
// aligned; dq and bias (Cout,) fp32, bias may be null; out (N, Ho, Wo,
// Cout) bf16 (mode 0, 1) or fp32 (mode 2). Tiles 128 x bn (64 or 128) and
// `splits` K splits of whole 128-deep slices, none empty
// (build.qconv_plan); with splits > 1, ws (tiles x splits x 128 x bn int32
// partials, 16-byte aligned) and tickets (one per tile, zero; the launch
// leaves them zero).
extern "C" int rt_qconv_s8(const int8_t* x, const int8_t* w, const float* dq,
                           const float* bias, void* out, int* ws, int* tickets, int N, int H,
                           int W, int Cin, int Cout, int KH, int KW, int stride, int pad_top,
                           int pad_left, int Ho, int Wo, int Kp, int mode, int has_cap, float cap,
                           int bn, int splits, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || stride <= 0 || mode < OUT_BF16 || mode > OUT_F32 || ((uintptr_t)w % 16) != 0 ||
      (bn != 64 && bn != 128 && bn != 256) || (int64_t)KW * Cin >= (1 << 15))
    return (int)cudaErrorInvalidValue;
  const int Rp = (KW * Cin + RUN - 1) / RUN * RUN;
  const int64_t K = (int64_t)KH * Rp, M = (int64_t)N * Ho * Wo;
  const int64_t slices = (K + SK - 1) / SK;
  const int64_t m_tiles = (M + BM - 1) / BM, n_tiles = (Cout + bn - 1) / bn;
  if (Kp < K || Kp % KP_ALIGN != 0 || K >= INT32_MAX || M >= INT32_MAX || splits < 1 ||
      splits > slices ||
      m_tiles * n_tiles * splits >= INT32_MAX || M * Cout >= ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  const int64_t chunk = (slices + splits - 1) / splits;  // slices a split
  if ((slices + chunk - 1) / chunk != splits ||
      (splits > 1 && (ws == nullptr || tickets == nullptr || (uintptr_t)ws % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, ymap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&ymap, 0, sizeof(ymap));
  // a bf16 output whose rows TMA can address leaves by TMA stores
  const int tma = mode != OUT_F32 && Cout % 8 == 0 && rt::aligned16(out);
  int status = wgb::cached_matrix_map(&wmap, w, Cout, Kp, bn, 1);
  if (status == 0 && tma) status = wgb::cached_matrix_map(&ymap, out, M, Cout, BM);
  if (status != 0) return status;
  QConv p;
  p.x = x;
  p.dq = dq;
  p.bias = bias;
  p.out = out;
  p.ws = ws;
  p.tickets = tickets;
  p.M = M;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.KH = KH;
  p.KW = KW;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.HoWo = Ho * Wo;
  p.Wo = Wo;
  p.Rp = Rp;
  p.K = (int)K;
  p.n_tiles = (int)n_tiles;
  p.splits = splits;
  p.mode = mode;
  p.has_cap = has_cap;
  p.cap = cap;
  p.resident_b = n_tiles == 1 && splits == 1 &&
                 slices <= (bn == 64 ? QTile<64>::S : bn == 128 ? QTile<128>::S : QTile<256>::S);
  const wgb::Units un{m_tiles, (int)n_tiles, splits, K, chunk * SK};
  const bool vec = Cin % 16 == 0 && rt::aligned16(x);
  cudaStream_t s = (cudaStream_t)stream;
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&, int, const QConv&,
                         const wgb::Units&, cudaStream_t);
  static const Launch runs[3][2] = {{qconv_launch<64, false>, qconv_launch<64, true>},
                                    {qconv_launch<128, false>, qconv_launch<128, true>},
                                    {qconv_launch<256, false>, qconv_launch<256, true>}};
  return runs[bn / 128][vec](wmap, ymap, tma, p, un, s);
}

// Q3. x (N, H, W, Cin) int8; w (KH * KW, Cout, Cgp) int8 as
// quant.pack_weight(w, groups) lays it out (Cgp = Cin / groups rounded up
// to 4, zero past Cin / groups), 16-byte aligned; dq and bias (Cout,)
// fp32, bias may be null; out (N, Ho, Wo, Cout) bf16 (mode 0, 1) or fp32
// (mode 2). One launch; 32-bit indices, so M, one image of x and w below
// 2^31 bytes.
extern "C" int rt_qconv_grouped_s8(const int8_t* x, const int8_t* w, const float* dq,
                                   const float* bias, void* out, int N, int H, int W, int Cin,
                                   int Cout, int groups, int KH, int KW, int stride,
                                   int pad_top, int pad_left, int Ho, int Wo, int mode,
                                   int has_cap, float cap, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 || KH <= 0 ||
      KW <= 0 || stride <= 0 || groups < 2 || Cin % groups != 0 || Cout % groups != 0 ||
      mode < OUT_BF16 || mode > OUT_F32 || ((uintptr_t)w % 16) != 0)
    return (int)cudaErrorInvalidValue;
  QGrouped p;
  p.Cg = Cin / groups;
  p.Ng = Cout / groups;
  p.Cgp = (p.Cg + 3) / 4 * 4;
  const int64_t M = (int64_t)N * Ho * Wo;
  const int64_t chunks = (int64_t)groups * ((p.Ng + QO - 1) / QO);
  const int64_t quad_blocks = ((M + QP - 1) / QP + Q3_ROWS - 1) / Q3_ROWS;
  if (M + QP >= INT32_MAX || (int64_t)H * W * Cin >= INT32_MAX ||
      (int64_t)KH * KW * Cout * p.Cgp >= INT32_MAX || quad_blocks >= INT32_MAX ||
      (chunks + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.w = w;
  p.dq = dq;
  p.bias = bias;
  p.out = out;
  p.M = (int)M;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.chunks = (int)chunks;
  p.KH = KH;
  p.KW = KW;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.Ho = Ho;
  p.Wo = Wo;
  p.mode = mode;
  p.has_cap = has_cap;
  p.cap = cap;
  const uintptr_t a = (uintptr_t)x;
  const int vec = p.Cg % 16 == 0 && a % 16 == 0 ? 16
                  : p.Cg % 8 == 0 && a % 8 == 0 ? 8
                  : p.Cg % 4 == 0 && a % 4 == 0 ? 4
                                                : 1;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)quad_blocks, (unsigned)((chunks + 31) / 32)), block(32, Q3_ROWS);
  if (vec == 16)
    qconv_grouped_kernel<16><<<grid, block, 0, s>>>(p);
  else if (vec == 8)
    qconv_grouped_kernel<8><<<grid, block, 0, s>>>(p);
  else if (vec == 4)
    qconv_grouped_kernel<4><<<grid, block, 0, s>>>(p);
  else
    qconv_grouped_kernel<1><<<grid, block, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Q2 on fp32 (the images) and bf16 (every other site) inputs; q int8, n
// values
extern "C" int rt_quant_act_f32(const float* x, int8_t* q, float inv, int64_t n,
                                void* stream) {
  return quant_act(x, q, inv, n, (cudaStream_t)stream);
}

extern "C" int rt_quant_act_bf16(const uint16_t* x, int8_t* q, float inv, int64_t n,
                                 void* stream) {
  return quant_act(reinterpret_cast<const __nv_bfloat16*>(x), q, inv, n, (cudaStream_t)stream);
}
