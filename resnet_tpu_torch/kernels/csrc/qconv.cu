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
// > 1). Replaces _qconv with feature_group_count (quantize.py:218-238) and
// _qsite's dequantization, as Q1 does for the rest. Bound by bytes at every
// ResNeXt site once the tensor cores do the products (3.7 G int8 ops a
// batch-128 site, ~2 us at 1,979 TOP/s, against 6-46 us of x read and
// bf16 written at 3.35 TB/s). So it is built to move each byte once:
// mma.sync m16n8k32 s8 products (not the CUDA cores' dp4a, ~1/60 of the
// rate), a group's problem packed into 8-column blocks (whole groups block
// diagonally where Ng < 8); x staged once a tile in shared memory as a halo
// (its 9 taps then read shared memory, not device memory 9 times), two
// buffers so the next tile's copies fly while this one multiplies; the
// weight staged once a persistent block, in fragment order; the output
// staged and stored as 16-byte row chunks. Details at the kernel (Q3 below).
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

#include <algorithm>
#include <atomic>
#include <type_traits>

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

// Q3, the grouped int8 conv on the tensor cores: mma.sync m16n8k32 s8 over
// an implicit im2col read from a halo tile staged in shared memory.
// mma.sync and not wgmma: its A fragment comes from registers that each
// lane loads from any shared address, so the im2col never exists (wgmma's
// shared A would need it laid out, or its register A the same loads), and a
// group's columns are 8 to 64 wide; the products are ~5% of a batch-128
// site's byte time at the int8 peak.
//
// Column blocks. Output channels go in blocks of 8 (an mma's N). Block cb
// reads the window of input groups [glo, glo + WG) with glo = 8 cb / Ng and
// WG the most groups any block touches (1 where Ng % 8 == 0; 2 at
// ResNeXt-50's stage 1, Ng = 4). Its K is taps x the window's bytes; the
// weight of an output channel against a channel of another group is zero
// (block-diagonal packing: at Ng = 4 two groups share a block and half the
// products are zeros). Where Ng % 8 == 0 the NB = 2 or 4 blocks of one group
// that an item takes share one window, so one A fragment feeds NB mmas.
//
// K order. A k-step is 32 bytes, eight 4-byte words; word r of a step is
// the mma's k = 4r .. 4r + 3 (r < 4: a0/a1 and b0; r >= 4: a2/a3 and b1).
// Q3_PAIR (an 8-byte window, stages 1 and 2 of ResNeXt-50): a step holds 4
// taps of one kernel row (3 and a padding slot for a 3x3), word r the
// window's word r / 4 of the row's tap r % 4, so a thread's a0 and a2 are
// one 8-byte load, and the 16 lanes of a half warp read 6 neighbouring
// pixels of one halo row, in 6 distinct bank groups. Q3_LDSM (a window of
// 16-byte multiples): word 8 ks + r is word u % WW of tap u / WW (u = 8 ks
// + r, WW the window's words), so each half of a step is 16 bytes of one
// tap and one ldmatrix.x4 gives a 16-row fragment. Padding words (past the
// taps) have zero weights. Integer sums are exact in any order, so the
// order changes no bit.
//
// Shared memory. The halo: for a tile of output pixels (tr whole output rows
// of one image, or ti whole images) the input rows and columns its windows
// reach, at the span's channels (the groups of the block's column blocks,
// SPB bytes, at a pixel stride `pitch` that is an odd multiple of 16 so that
// 8 pixels' 16-byte rows fall in 8 distinct bank groups), zero outside the
// image: the padding. x is read from device memory once a tile, and its 9
// taps from shared memory. Two halo buffers: the next tile's copies are in
// flight while the block multiplies the current one. x comes by 16-byte
// cp.async (each thread's chunks decoded once per block, since every tile
// has the same geometry) where the layout is x's own (Cin % 16 == 0, Cg % 4
// == 0, x 16-byte aligned, windows aligned); else (ragged Cg, a misaligned
// x) word by word, each group in a slot of Cg rounded up to 16 bytes. The
// weight: the span's column blocks in fragment order, zeros off the
// diagonal, copied once per block from pack_weight's (KH * KW, Cout, Cgp).
// The dq and bias columns, the taps' offsets and the pixels' halo offsets,
// once per block. The output tile: Q1's epilogue writes it as bf16 (or
// fp32), then the block stores it as 16-byte row chunks where Cout allows.
//
// Persistent: block b takes the span b % spans and the tiles b / spans,
// + P, ... (P blocks a span, at most two blocks a SM in all), so each block
// builds its weight once. The plan (sb sets a span, ti images or tr rows a
// tile) is build.q3_plan's, a function of the shapes; q3_geometry here and
// build.q3_geometry there lay out the same shared memory. Warps take (MT
// m16 tiles, NB column blocks) items of the tile in turn.
//
// What holds it (PERF.md, Findings): at batch 128 the block's multiply phase
// (A fragments from shared memory, the epilogue's per-output steps) and its
// copy phase each take about as long as the site's bound alone, and
// overlap only in part; at batch 8 a block's single tile leaves the launch,
// the first copies and the store in series.
constexpr int Q3_THREADS = 256;  // 8 warps
constexpr int Q3_WARPS = Q3_THREADS / 32;
constexpr int Q3_CHUNKS = 8;      // a thread's 16-byte halo copies a tile, at most
constexpr int Q3_SMEM = 115712;   // a block's shared memory: two blocks a SM
constexpr int Q3_BUFS = 2;        // halo buffers: the next tile in flight while one multiplies
constexpr int Q3_NB_MAX = 4;      // column blocks an item's A fragments feed, at most
enum Q3Loads { Q3_PAIR = 0, Q3_LDSM = 1 };

struct QGrouped {
  const int8_t* x;
  const int8_t* w;  // (KH * KW, Cout, Cgp)
  const float* dq;
  const float* bias;  // null: no bias
  void* out;
  int N, H, W, Cin, Cout, G, Cg, Ng, Cgp, KH, KW, T, stride, pad_top, pad_left, Ho, Wo, mode,
      has_cap;
  float cap;
  // q3_geometry's
  int dense;   // x by 16-byte cp.async in x's own layout (a group's slot Cg bytes)
  int wvec;    // the weight by 16-byte cp.async (Q3_LDSM, dense, a window one group)
  int Cgs;     // a group's slot in the halo, in bytes
  int WB, WW;  // a window's bytes and words
  int loads;   // Q3Loads
  int KS;      // 32-byte k-steps a column block
  int NCB, NB, MT;
  int cbs, spans;  // column blocks a span, spans
  int SPB, pitch;  // a halo pixel's bytes, and its stride
  int TI, TR, RT, tiles, HR, HC, HPX, TP, MTILES, NCOLS, esize, opitch, ovec;
  int o_halo1, o_w, o_out, o_cols, o_tab, o_pb, smem;
};

__host__ __device__ __forceinline__ int q3_glo(const QGrouped& p, int cb) {
  return 8 * cb / p.Ng;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q3_PAIR's tap of k-step ks, slot tig: step ks holds 4 taps of one kernel
// row (ks / ceil(KW / 4)); a slot past the row's taps is padding: -1, or
// with `pad_first` the row's first tap of the step (for its address)
__host__ __device__ __forceinline__ int q3_pair_tap(const QGrouped& p, int ks, int tig,
                                                    bool pad_first) {
  const int qw = (p.KW + 3) / 4, di = ks / qw, dj0 = (ks - di * qw) * 4, dj = dj0 + tig;
  if (dj < p.KW) return di * p.KW + dj;
  return pad_first ? di * p.KW + dj0 : -1;
}

// Q1's bf16 step on a pair (to_act2's bits): each value rounded to bf16,
// then with RELU a value below 0 becomes +0 and then with CAP one above the
// cap (cap2, the cap's bf16 twice) the cap, both halves by one packed
// compare (NaN and -0 compare false and pass, as in the plain version); no
// branch, so the pairs of an item interleave
template <bool RELU, bool CAP>
__device__ __forceinline__ uint32_t q3_act2(float v0, float v1, __nv_bfloat162 cap2) {
  __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  uint32_t w = *reinterpret_cast<uint32_t*>(&h2);
  if constexpr (RELU) {
    w &= ~__hlt2_mask(h2, __float2bfloat162_rn(0.f));
    if constexpr (CAP) {
      h2 = *reinterpret_cast<__nv_bfloat162*>(&w);
      const uint32_t over = __hgt2_mask(h2, cap2);
      w = (w & ~over) | (*reinterpret_cast<const uint32_t*>(&cap2) & over);
    }
  }
  return w;
}

template <int NB, int MT, int LOADS>
__global__ void __launch_bounds__(Q3_THREADS, 2)
    qconv_grouped_kernel(const __grid_constant__ QGrouped p) {
  extern __shared__ __align__(128) uint8_t q3_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int span = blockIdx.x % p.spans, step = gridDim.x / p.spans;
  const int cbA = span * p.cbs, ncb = min(p.cbs, p.NCB - cbA);
  const int c0 = q3_glo(p, cbA) * p.Cgs & ~15;  // the span's first halo byte (x's channel if dense)
  const uint32_t* bs = reinterpret_cast<const uint32_t*>(q3_smem + p.o_w);
  uint8_t* stage = q3_smem + p.o_out;
  const float* cols = reinterpret_cast<const float*>(q3_smem + p.o_cols);  // dq, then bias
  int* tab = reinterpret_cast<int*>(q3_smem + p.o_tab);        // KS x 4 tap offsets
  int* pb = reinterpret_cast<int*>(q3_smem + p.o_pb);          // pixels' halo offsets
  const uint32_t halo0 = rt::tc::smem_u32(q3_smem);

  // a step's tap offsets: Q3_PAIR by the thread's tig (its tap; a padding
  // slot reads its row's first tap, so the step's loads touch one halo row),
  // Q3_LDSM by the fragment's half (its 16 bytes; padding reads pixel 0)
  for (int i = tid; i < p.KS * 4; i += Q3_THREADS) {
    const int ks = i >> 2, sl = i & 3;
    int t, j = 0;
    if constexpr (LOADS == Q3_PAIR) {
      t = q3_pair_tap(p, ks, sl, true);
    } else {
      const int u = 8 * ks + 4 * (sl & 1);
      t = u / p.WW;
      j = u - t * p.WW;
    }
    tab[i] = (t < p.T ? t / p.KW * p.HC + t % p.KW : 0) * p.pitch + 4 * j;
  }
  // a tile pixel's window corner in the halo (past TP: pixel 0)
  for (int i = tid; i < (p.MTILES + MT - 1) / MT * MT * 16; i += Q3_THREADS) {
    int v = 0;
    if (i < p.TP) {
      const int per = p.TR * p.Wo, im = i / per, rem = i - im * per, r = rem / p.Wo;
      v = ((im * p.HR + r * p.stride) * p.HC + (rem - r * p.Wo) * p.stride) * p.pitch;
    }
    pb[i] = v;
  }
  // the thread's 16-byte halo chunks (dense): image, halo row and column,
  // chunk, the same in every tile
  uint32_t desc[Q3_CHUNKS];
#pragma unroll
  for (int k = 0; k < Q3_CHUNKS; ++k) desc[k] = ~0u;
  if (p.dense) {
    const int cpp = p.SPB >> 4, per = p.HR * p.HC;
#pragma unroll
    for (int k = 0; k < Q3_CHUNKS; ++k) {
      const int c = tid + k * Q3_THREADS;
      if (c < p.HPX * cpp) {
        const int q = c / cpp, cc = c - q * cpp, im = q / per, rem = q - im * per;
        const int hr = rem / p.HC, hc = rem - hr * p.HC;
        desc[k] = (uint32_t)im << 22 | (uint32_t)hr << 14 | (uint32_t)hc << 3 | (uint32_t)cc;
      }
    }
  }

  // tile t's halo into the buffer at `buf` (cp.async where dense, else stores)
  auto load = [&](int t, uint32_t buf) {
    int n0, oyb;
    if (p.TI > 1) {
      n0 = t * p.TI;
      oyb = -p.pad_top;
    } else {
      n0 = t / p.RT;
      oyb = (t - n0 * p.RT) * p.TR * p.stride - p.pad_top;
    }
    if (p.dense) {
#pragma unroll
      for (int k = 0; k < Q3_CHUNKS; ++k) {
        const uint32_t d = desc[k];
        if (d == ~0u) continue;
        const int cc = d & 7, hc = d >> 3 & 2047, hr = d >> 14 & 255, im = d >> 22;
        const int n = n0 + im, iy = oyb + hr, ix = hc - p.pad_left, ch = c0 + 16 * cc;
        const bool ok = n < p.N && (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W &&
                        ch < p.Cin;
        const int8_t* src = ok ? p.x + (((int64_t)n * p.H + iy) * p.W + ix) * p.Cin + ch : p.x;
        wgb::cp16(buf + ((im * p.HR + hr) * p.HC + hc) * p.pitch + 16 * cc, src, ok);
      }
    } else {
      const int wpp = p.SPB >> 2, per = p.HR * p.HC;
      for (int c = tid; c < p.HPX * wpp; c += Q3_THREADS) {
        const int q = c / wpp, wd = c - q * wpp, im = q / per, rem = q - im * per;
        const int hr = rem / p.HC, n = n0 + im, iy = oyb + hr, ix = rem - hr * p.HC - p.pad_left;
        uint32_t v = 0;
        if (n < p.N && (unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W) {
          const int8_t* px = p.x + (((int64_t)n * p.H + iy) * p.W + ix) * p.Cin;
          for (int e = 0; e < 4; ++e) {
            const int b = c0 + 4 * wd + e, g = b / p.Cgs, ci = b - g * p.Cgs;
            if (g < p.G && ci < p.Cg) v |= (uint32_t)(uint8_t)px[g * p.Cg + ci] << 8 * e;
          }
        }
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(buf + q * p.pitch + 4 * wd), "r"(v)
                     : "memory");
      }
    }
  };

  const int kind = p.mode == OUT_F32 ? 0 : p.mode == OUT_BF16 ? 1 : p.has_cap ? 3 : 2;
  const __nv_bfloat162 cap2 = __float2bfloat162_rn(p.cap);
  const int sets = ncb / NB, mgs = (p.MTILES + MT - 1) / MT, items = sets * mgs;
  const uint32_t* b2 = bs + lane;  // b0 at + 0, b1 at + 32 words
  // the span's output columns; where they leave as 16-byte chunks (ovec),
  // the thread stores chunk sk of rows sr, sr + rpp, ... of each tile
  const int col0 = 8 * cbA, ncols = min(p.NCOLS, p.Cout - col0);
  const int cpr = ncols * p.esize >> 4, rpp = Q3_THREADS / max(cpr, 1);
  const int sr = tid / max(cpr, 1), sk = tid - sr * cpr;
  int tile = blockIdx.x / p.spans, cur = 0;
  if (tile < p.tiles) load(tile, halo0);
  // once per block: the span's weight in fragment order, word i of (cb,
  // ks, register q, gid, tig) (so lane (gid, tig) reads b0 and b1 as two
  // conflict-free words), zero off the diagonal and past the taps (zero-
  // filled copies): where a window is one group of 16-byte multiples, a
  // register's four words are 16 contiguous bytes of the packed weight, one
  // copy; else word by word. Its dq and bias columns too, all by cp.async in
  // one group with the first tile's halo
  const uint32_t bw = halo0 + p.o_w;
  if (p.wvec) {
    for (int i = tid; i < ncb * p.KS * 16; i += Q3_THREADS) {
      const int gid_ = i & 7, q = i >> 3 & 1, rest = i >> 4;
      const int ks = rest % p.KS, cb = cbA + rest / p.KS, o = 8 * cb + gid_;
      const int u = 8 * ks + 4 * q, t = u / p.WW, j = u - t * p.WW;
      const bool ok = o < p.Cout && t < p.T;
      wgb::cp16(bw + 16 * i, ok ? p.w + ((int64_t)t * p.Cout + o) * p.Cgp + 4 * j : p.w, ok);
    }
  } else {
    for (int i = tid; i < ncb * p.KS * 64; i += Q3_THREADS) {
      const int tig_ = i & 3, gid_ = i >> 2 & 7, q = i >> 5 & 1, rest = i >> 6;
      const int ks = rest % p.KS, cb = cbA + rest / p.KS, o = 8 * cb + gid_;
      int t, j;
      if constexpr (LOADS == Q3_PAIR) {
        t = q3_pair_tap(p, ks, tig_, false);
        j = q;
      } else {
        const int u = 8 * ks + 4 * q + tig_;
        t = u / p.WW;
        j = u - t * p.WW;
      }
      const int k = 4 * j / p.Cgs, ci = 4 * j - k * p.Cgs;
      const bool ok =
          o < p.Cout && t >= 0 && t < p.T && q3_glo(p, cb) + k == o / p.Ng && ci < p.Cgp;
      wgb::cp4(bw + 4 * i, ok ? p.w + ((int64_t)t * p.Cout + o) * p.Cgp + ci : p.w, ok);
    }
  }
  for (int c = tid; c < 2 * p.NCOLS; c += Q3_THREADS) {
    const int col = 8 * cbA + c % p.NCOLS;
    if (c >= p.NCOLS && !p.bias) {
      reinterpret_cast<float*>(q3_smem + p.o_cols)[c] = -0.f;
      continue;
    }
    const float* src = c < p.NCOLS ? p.dq : p.bias;
    wgb::cp4(halo0 + p.o_cols + 4 * c, src + (col < p.Cout ? col : 0), col < p.Cout);
  }
  rt::tc::cp_async_commit();
  // the next Q3_BUFS - 2 tiles' halos, a copy group each
  for (int b = 1; b < Q3_BUFS - 1; ++b) {
    if (tile + b * step < p.tiles) load(tile + b * step, halo0 + b * p.o_halo1);
    rt::tc::cp_async_commit();
  }
  for (; tile < p.tiles; tile += step, cur = cur + 1 == Q3_BUFS ? 0 : cur + 1) {
    // Q3_BUFS - 1 tiles ahead, into the buffer the last tile was read from
    const int ahead = tile + (Q3_BUFS - 1) * step;
    if (ahead < p.tiles) load(ahead, halo0 + (cur == 0 ? Q3_BUFS - 1 : cur - 1) * p.o_halo1);
    rt::tc::cp_async_commit();
    rt::tc::cp_async_wait<Q3_BUFS - 1>();  // this tile's copies have landed
    __syncthreads();
    const uint32_t hcur = halo0 + cur * p.o_halo1;
    for (int it = warp; it < items; it += Q3_WARPS) {
      const int set = it / mgs, mg = it - set * mgs, cbl = set * NB;
      const uint32_t base = hcur + q3_glo(p, cbA + cbl) * p.Cgs - c0;
      int acc[MT][NB][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
      // the fragment rows' window corners: Q3_PAIR rows gid and gid + 8,
      // Q3_LDSM the row whose address this lane gives ldmatrix
      uint32_t rb[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = (mg * MT + mt) * 16;
        if constexpr (LOADS == Q3_PAIR) {
          rb[mt][0] = base + pb[r0 + gid];
          rb[mt][1] = base + pb[r0 + gid + 8];
        } else {
          rb[mt][0] = base + pb[r0 + (lane & 15)];
        }
      }
      const uint32_t* bp = b2 + cbl * p.KS * 64;
      for (int ks = 0; ks < p.KS; ++ks) {
        uint32_t a[MT][4];
        if constexpr (LOADS == Q3_PAIR) {
          const int tb = tab[4 * ks + tig];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                           : "=r"(a[mt][h]), "=r"(a[mt][2 + h])
                           : "r"(rb[mt][h] + tb));
        } else {
          const int tb = tab[4 * ks + (lane >> 4)];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
                         : "r"(rb[mt][0] + tb));
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint2 b = make_uint2(bp[(j * p.KS + ks) * 64], bp[(j * p.KS + ks) * 64 + 32]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][j], a[mt], b.x, b.y);
        }
      }
      // Q1's epilogue into the staged tile (every row the item computed; the
      // store leaves out those past the tile): f32(acc) * dq, + bias (-0
      // where there is none: v + -0 is v), each step rounded (no FMA), then
      // bf16 (ReLU and cap on the bf16 pair) or fp32; straight-line code
      // the output kind as template arguments: 0 fp32, 1 bf16, 2 bf16 + ReLU,
      // 3 bf16 + ReLU + cap
      auto epilogue = [&](auto kind) {
        constexpr int K = decltype(kind)::value;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int c = (cbl + j) * 8 + 2 * tig;
          const float2 d = *reinterpret_cast<const float2*>(cols + c);
          const float2 bb = *reinterpret_cast<const float2*>(cols + p.NCOLS + c);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = (mg * MT + mt) * 16 + gid + 8 * h;
              const float v0 =
                  __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h]), d.x), bb.x);
              const float v1 =
                  __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h + 1]), d.y), bb.y);
              uint8_t* o = stage + row * p.opitch;
              if constexpr (K == 0)
                *reinterpret_cast<float2*>(o + 4 * c) = make_float2(v0, v1);
              else
                *reinterpret_cast<uint32_t*>(o + 2 * c) = q3_act2<K >= 2, K == 3>(v0, v1, cap2);
            }
        }
      };
      if (kind == 0)
        epilogue(std::integral_constant<int, 0>{});
      else if (kind == 1)
        epilogue(std::integral_constant<int, 1>{});
      else if (kind == 2)
        epilogue(std::integral_constant<int, 2>{});
      else
        epilogue(std::integral_constant<int, 3>{});
    }
    __syncthreads();
    // the tile's outputs (rows past M or Ho left out) from the stage, as
    // 16-byte row chunks where Cout and out allow
    int64_t m0;
    int tpv;
    if (p.TI > 1) {
      const int n0 = tile * p.TI;
      m0 = (int64_t)n0 * p.Ho * p.Wo;
      tpv = min(p.TI, p.N - n0) * p.Ho * p.Wo;
    } else {
      const int n = tile / p.RT, oy0 = (tile - n * p.RT) * p.TR;
      m0 = ((int64_t)n * p.Ho + oy0) * p.Wo;
      tpv = min(p.TR, p.Ho - oy0) * p.Wo;
    }
    uint8_t* y = static_cast<uint8_t*>(p.out) + (m0 * p.Cout + col0) * p.esize;
    const int64_t ystride = (int64_t)p.Cout * p.esize;
    if (p.ovec) {
      // chunk sk of rows sr, sr + rpp, ...: four read from the stage before
      // any is stored
      if (sr < rpp) {
        const uint8_t* sp = stage + sr * p.opitch + 16 * sk;
        uint8_t* gp = y + sr * ystride + 16 * sk;
        const int sstep = rpp * p.opitch;
        const int64_t gstep = rpp * ystride;
        for (int r = sr; r < tpv; r += 4 * rpp, sp += 4 * sstep, gp += 4 * gstep) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r + u * rpp < tpv) v[u] = *reinterpret_cast<const uint4*>(sp + u * sstep);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r + u * rpp < tpv) *reinterpret_cast<uint4*>(gp + u * gstep) = v[u];
        }
      }
    } else {
      for (int c = tid; c < tpv * ncols; c += Q3_THREADS) {
        const int r = c / ncols, k = c - r * ncols;
        if (p.esize == 4)
          *reinterpret_cast<uint32_t*>(y + r * ystride + 4 * k) =
              *reinterpret_cast<const uint32_t*>(stage + r * p.opitch + 4 * k);
        else
          *reinterpret_cast<uint16_t*>(y + r * ystride + 2 * k) =
              *reinterpret_cast<const uint16_t*>(stage + r * p.opitch + 2 * k);
      }
    }
  }
  rt::tc::cp_async_wait<0>();
}

inline int q3_r16(int v) { return (v + 15) / 16 * 16; }
// v rounded up to an odd multiple of 16 bytes: 8 rows at that stride start
// in 8 distinct 16-byte bank groups
inline int q3_odd16(int v) { return q3_r16(v) / 16 % 2 ? q3_r16(v) : q3_r16(v) + 16; }

// p's geometry under the plan (sb sets a span; ti images a tile, or at ti =
// 1 tr output rows of one image): false if the kernel does not take the
// plan. kernels/build.py q3_geometry is the same function in Python.
bool q3_geometry(QGrouped& p, int sb, int ti, int tr, bool aligned) {
  const int ncb = (p.Cout + 7) / 8;
  int wg = 1;
  for (int cb = 0; cb < ncb; ++cb)
    wg = std::max(wg, std::min(8 * cb + 7, p.Cout - 1) / p.Ng - 8 * cb / p.Ng + 1);
  auto starts = [&](int cgs, int a) {  // every window starts at a multiple of a
    for (int cb = 0; cb < ncb; ++cb)
      if (8 * cb / p.Ng * cgs % a) return false;
    return true;
  };
  if (sb < 1 || ti < 1 || tr < 1 || tr > p.Ho || ti > p.N || (ti > 1 && tr != p.Ho)) return false;
  for (int dense = aligned && p.Cin % 16 == 0 && p.Cg % 4 == 0; dense >= 0; --dense) {
    const int cgs = dense ? p.Cg : q3_r16(p.Cg);
    int wb;
    if (dense && wg * cgs <= 8 && starts(cgs, 8))
      wb = 8;
    else if (!dense || starts(cgs, 16))
      wb = q3_r16(wg * cgs);
    else
      continue;
    p.dense = dense;
    p.Cgs = cgs;
    p.WB = wb;
    p.WW = wb / 4;
    p.loads = wb == 8 ? Q3_PAIR : Q3_LDSM;
    p.KS = p.loads == Q3_PAIR ? p.KH * ((p.KW + 3) / 4) : (p.T * p.WW + 7) / 8;
    p.NCB = ncb;
    p.NB = 1;
    if (p.loads == Q3_LDSM && p.Ng % 8 == 0) {
      const int q = p.Ng / 8;
      p.NB = q % 4 == 0 ? 4 : q % 2 == 0 ? 2 : 1;
    }
    p.MT = p.NB == 1 ? 4 : 2;
    p.wvec = dense && p.loads == Q3_LDSM && p.Ng % 8 == 0;
    const int sets = ncb / p.NB;
    if (sb > sets) return false;
    p.cbs = sb * p.NB;
    p.spans = (sets + sb - 1) / sb;
    int spb = 0;
    for (int s = 0; s < p.spans; ++s) {
      const int a = s * p.cbs, c0 = 8 * a / p.Ng * cgs / 16 * 16;
      for (int cb = a; cb < std::min(a + p.cbs, ncb); ++cb)
        spb = std::max(spb, 8 * cb / p.Ng * cgs + wb - c0);
    }
    p.SPB = q3_r16(spb);
    p.pitch = q3_odd16(p.SPB);
    p.TI = ti;
    p.TR = tr;
    p.RT = (p.Ho + tr - 1) / tr;
    p.tiles = ti > 1 ? (p.N + ti - 1) / ti : p.N * p.RT;
    p.HR = (tr - 1) * p.stride + p.KH;
    p.HC = (p.Wo - 1) * p.stride + p.KW;
    p.HPX = ti * p.HR * p.HC;
    p.TP = ti * tr * p.Wo;
    p.MTILES = (p.TP + 15) / 16;
    // the dense loader's chunk record: 8 chunks a thread, image < 2^10,
    // halo row < 2^8, column < 2^11, chunk < 8
    if (dense && ((int64_t)p.HPX * (p.SPB / 16) > Q3_THREADS * Q3_CHUNKS || ti > 1023 ||
                  p.HR > 255 || p.HC > 2047 || p.SPB > 128))
      continue;
    p.NCOLS = p.cbs * 8;
    p.esize = p.mode == OUT_F32 ? 4 : 2;
    p.opitch = q3_odd16(p.NCOLS * p.esize);
    const int64_t hb = ((int64_t)p.HPX * p.pitch + 127) / 128 * 128;
    const int64_t o_w = Q3_BUFS * hb, o_out = o_w + (int64_t)p.cbs * p.KS * 256;
    // the staged tile holds every row the items compute
    const int rows = (p.MTILES + p.MT - 1) / p.MT * p.MT * 16;
    const int64_t o_cols = o_out + q3_r16(rows * p.opitch), o_tab = o_cols + 8 * p.NCOLS;
    const int64_t o_pb = o_tab + 16 * p.KS;
    const int64_t smem = o_pb + 4 * rows;
    if (smem > Q3_SMEM) return false;
    p.o_halo1 = (int)hb;
    p.o_w = (int)o_w;
    p.o_out = (int)o_out;
    p.o_cols = (int)o_cols;
    p.o_tab = (int)o_tab;
    p.o_pb = (int)o_pb;
    p.smem = (int)smem;
    return true;
  }
  return false;
}

template <int NB, int MT, int LOADS>
int q3_launch(const QGrouped& p, cudaStream_t s) {
  auto* kernel = qconv_grouped_kernel<NB, MT, LOADS>;
  // the smem attribute and the SM count, once per device (bit d of ready)
  static std::atomic<uint32_t> ready{0};
  static int sms_of[32];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(ready.load(std::memory_order_acquire) >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q3_SMEM);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(1u << dev, std::memory_order_release);
  }
  // P blocks a span: at most two blocks a SM in all (one wave), none
  // without a tile
  const int per = std::max(1, std::min(p.tiles, 2 * sms_of[dev] / p.spans));
  kernel<<<(unsigned)(p.spans * per), Q3_THREADS, p.smem, s>>>(p);
  return (int)cudaGetLastError();
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
// (mode 2); the plan (sb sets a span, ti images or tr output rows a tile)
// build.q3_plan's. One launch; M, one image of x and the weight below 2^31
// bytes.
extern "C" int rt_qconv_grouped_s8(const int8_t* x, const int8_t* w, const float* dq,
                                   const float* bias, void* out, int N, int H, int W, int Cin,
                                   int Cout, int groups, int KH, int KW, int stride,
                                   int pad_top, int pad_left, int Ho, int Wo, int mode,
                                   int has_cap, float cap, int sb, int ti, int tr,
                                   void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Ho <= 0 || Wo <= 0 || KH <= 0 ||
      KW <= 0 || stride <= 0 || groups < 2 || Cin % groups != 0 || Cout % groups != 0 ||
      mode < OUT_BF16 || mode > OUT_F32 || ((uintptr_t)w % 16) != 0 ||
      (int64_t)N * Ho * Wo >= INT32_MAX || (int64_t)H * W * Cin >= INT32_MAX ||
      (int64_t)KH * KW * Cout * ((Cin / groups + 3) / 4 * 4) >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  QGrouped p;
  p.x = x;
  p.w = w;
  p.dq = dq;
  p.bias = bias;
  p.out = out;
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.G = groups;
  p.Cg = Cin / groups;
  p.Ng = Cout / groups;
  p.Cgp = (p.Cg + 3) / 4 * 4;
  p.KH = KH;
  p.KW = KW;
  p.T = KH * KW;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.Ho = Ho;
  p.Wo = Wo;
  p.mode = mode;
  p.has_cap = has_cap;
  p.cap = cap;
  if (!q3_geometry(p, sb, ti, tr, rt::aligned16(x))) return (int)cudaErrorInvalidValue;
  p.ovec = rt::aligned16(out) && (int64_t)Cout * p.esize % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.loads == Q3_PAIR) return q3_launch<1, 4, Q3_PAIR>(p, s);
  static_assert(Q3_NB_MAX == 4, "an instantiation for each NB");
  switch (p.NB) {
    case 1: return q3_launch<1, 4, Q3_LDSM>(p, s);
    case 2: return q3_launch<2, 2, Q3_LDSM>(p, s);
    default: return q3_launch<4, 2, Q3_LDSM>(p, s);
  }
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
