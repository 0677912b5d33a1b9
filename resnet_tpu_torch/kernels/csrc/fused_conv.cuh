// Device code shared by the fused conv (K8) and the residual join (K9),
// whose kernels and entry points are in csrc/fused_conv.cu, and K10
// (csrc/block_fused.cu): the gather with the prologue, the statistics
// passes and the join. K10's stages 0-2 gather as K8 does, but run their
// GEMMs on wg_gemm.cuh's wgmma core (fp32) or wgb_gemm.cuh's specialized
// loop (bf16); its stage 3 is K9's body with an identity residual.
//
// The fused conv is the implicit GEMM of the conv on the split-TF32
// tensor-core core (tc_gemm.cuh, K-major A) with the loader FusedConvTcA,
// im2col.cuh's gather with the prologue (the conv forward, K1, runs the same
// gather without it): row (n, oy, ox) decoded once per copying thread, a
// (di, dj, ci) cursor walked by 32 columns with carries (one tap per K-step
// where Cin % 32 == 0), 16-byte copies of four channels where Cin and Cout
// are multiples of 4 and x and w 16-byte aligned, 4-byte copies otherwise.
// The prologue (the previous layer's BN affine and ReLU) cannot ride
// cp.async, so each thread rewrites the elements it copied once the slice
// has landed, before the fragment reads:
// act(__fadd_rn(__fmul_rn(v, scale[ci]), shift[ci])), rounded step by step
// as the plain version is, then the TF32 split. It
// rewrites only the elements the copy read: a tap outside the image is
// zero-filled and stays exactly 0 (relu(shift) must never enter the
// padding). Its statistics [sum y, sum y^2] per output channel come from the
// GEMM epilogue's per-tile partials (tc_gemm.cuh kStats, one BM = 128-row
// tile each) or, when the GEMM splits K and its tiles hold partials, from a
// column pass over the summed y into the same workspace, one 128-row tile
// per entry too; a second kernel adds the tiles per channel in double, in a
// fixed order (tile_sums). No atomics, so a run repeats exactly.
//
// The join is one elementwise pass, each product and sum rounded on its own
// as the plain PyTorch version rounds it; one template over the storage type
// (rowwise.cuh), so bf16 e and r are read into fp32 and the result rounded
// once. Where C is a multiple of a 16-byte vector's elements and every
// pointer is 16-byte aligned, each thread keeps one channel group and its
// rows in registers and streams 16-byte vectors of e and r (join_group);
// otherwise, and for a remainder, element by element (join_scalar).
//
// bf16 (K8 and K10 on bf16 tensors): the implicit GEMM runs on
// wgb_gemm.cuh's wgmma core (fused_conv_wg_kernel below): B, the weight
// (k*k*Cin, Cout) row-major, by TMA as it lies (MN-major, the transpose bit
// of wgmma's descriptor); A, the im2col gather of x, K-major, by cp.async
// into the ring's swizzled slot, 16 bytes (8 channels of one tap) per copy,
// each thread's four rows decoded once per tile and its (tap, channel)
// cursor walked by 64 columns; once a thread's copies have landed it applies
// the prologue in place to the chunks it read (the affine, ReLU and cap in
// fp32 on the upcast value, rounded to bf16 before the product,
// fused_conv.py:61-76), one (scale, shift) load per 8 channels; a halo tap
// or a column past K was zero-filled and stays exactly 0. Ragged widths
// (Cin or Cout not a multiple of 8, or x or w not 16-byte aligned) load
// both operands through the threads instead, 2 bytes at a time, the
// prologue applied on the way. K1's bf16 forward (conv.cu) runs the same
// gather with the prologue off on wgb::persistent, ConvWgBlock::start
// moving it from unit to unit, and K10-bf16's three stage GEMMs
// (block_fused.cu) with the prologue on, by the copying warpgroups of
// wgb::specialized: fix reads what a slot needs from the slot's own record
// (sm.info), so the copier may have moved on to later slices and units. The statistics come from the fp32
// accumulators (fused_conv.py:109-110), never from the rounded y: one
// split, the core's per-128-row-tile epilogue (wgb::tile_stats); several,
// the split sum of splitk_sum_stats_bf16, which adds the fp32 partials in
// split order, rounds y once and takes the column partials from the fp32
// sum before that rounding.
//
#pragma once

#include <cstring>

#include "bf16_gemm.cuh"
#include "im2col.cuh"
#include "rowwise.cuh"
#include "tc_gemm.cuh"
#include "wgb_gemm.cuh"

namespace {

using rt::Act;
using rt::ChannelWalk;

constexpr int CT = 32;  // channels per block of the statistics passes
constexpr int RT = 8;   // row lanes per block of the column pass
constexpr int FL = 32;  // tile lanes per block of the final sum
constexpr int TILE_M = rt::tc::BM;  // rows of one statistics tile

// A of the fused conv: the im2col gather of im2col.cuh with the prologue
using FusedConvTcA = Im2colTcA<true>;

// The loader of x (N, H, W, Cin) for a k x k window at stride `stride` whose
// origin is (pad_top, pad_left) above and left of the input, output (Ho, Wo);
// with prologue, scale and shift hold Cin floats (the device may still be
// writing them: they are read only by the kernel)
inline FusedConvTcA conv_loader(const float* x, const float* scale, const float* shift, int N,
                                int H, int W, int Cin, int k, int stride, int pad_top,
                                int pad_left, int Ho, int Wo, bool prologue, Act act) {
  FusedConvTcA a = im2col<true>(x, N, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo);
  a.scale = scale;
  a.shift = shift;
  a.prologue = prologue;
  a.act = act;
  return a;
}

// Split-K case: per TILE_M-row tile of y (M, C), the column sums and sums
// of squares, into the same workspace layout as the GEMM epilogue's
__global__ void __launch_bounds__(CT * RT)
column_partials(const float* __restrict__ y, float* __restrict__ part, int64_t M, int C) {
  const int c = blockIdx.x * CT + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * TILE_M;
  const int64_t r1 = M < r0 + TILE_M ? M : r0 + TILE_M;
  float s = 0.f, s2 = 0.f;
  if (c < C) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += RT) {
      const float v = y[r * C + c];
      s += v;
      s2 += v * v;
    }
  }
  __shared__ float sh[2][RT][CT];
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      a += sh[0][t][threadIdx.x];
      b += sh[1][t][threadIdx.x];
    }
    part[(2 * (int64_t)blockIdx.y) * C + c] = a;
    part[(2 * (int64_t)blockIdx.y + 1) * C + c] = b;
  }
}

// Channel blockIdx.x * CT + threadIdx.x of the tile partials (m_tiles, 2,
// C) added in double in a fixed order, rounded to (s0, s1); true in the
// thread that holds it (threadIdx.y == 0, c < C). Called by every thread
// of a (CT, FL) block.
__device__ __forceinline__ bool tile_sums(const float* __restrict__ part, int C,
                                          int64_t m_tiles, float& s0, float& s1) {
  const int c = blockIdx.x * CT + threadIdx.x;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int64_t t = threadIdx.y; t < m_tiles; t += FL) {
      a += part[(2 * t) * C + c];
      b += part[(2 * t + 1) * C + c];
    }
  }
  __shared__ double sh[2][FL][CT];
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y != 0 || c >= C) return false;
  double sa = 0.0, sb = 0.0;
  for (int t = 0; t < FL; ++t) {
    sa += sh[0][t][threadIdx.x];
    sb += sh[1][t][threadIdx.x];
  }
  s0 = (float)sa;
  s1 = (float)sb;
  return true;
}

// e * se + te + r * sr + tr, left to right, each step rounded (K9); q
// holds the channel's (se, te, sr, tr)
struct JoinRows {
  static constexpr int ROWS = 4;
  const float* row[ROWS];  // se, te, sr, tr
  Act act;
  __device__ float operator()(float e, float r, const float (&q)[ROWS]) const {
    return act(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(e, q[0]), q[1]), __fmul_rn(r, q[2])),
                         q[3]));
  }
};

// e * se + te + r, left to right, each step rounded: the join of an identity
// residual (K10's stage 3); q holds the channel's (se, te)
struct JoinIdentity {
  static constexpr int ROWS = 2;
  const float* row[ROWS];  // se, te
  Act act;
  __device__ float operator()(float e, float r, const float (&q)[ROWS]) const {
    return act(__fadd_rn(__fadd_rn(__fmul_rn(e, q[0]), q[1]), r));
  }
};

// The join's body where C % V == 0 (V = Vec16<T>::N: 8 bf16 or 4 floats a
// 16-byte vector) and e, r, o are 16-byte aligned: vector i holds channels
// V * (i % G) + [0, V), G = C / V. The grid's stride in vectors is a
// multiple of G (launch_join), so each thread keeps one channel group for
// its whole walk: it reads that group's rows once (16-byte loads where a row
// is aligned) and then only e and r, U vectors of each in flight, read and
// written once with streaming cache hints. The arithmetic per element is
// f's, as the scalar path's, so the two give the same bits.
constexpr int JOIN_THREADS = 256;
constexpr int JOIN_U = 4;  // vectors of e and of r in flight a thread

template <class T, class F>
__global__ void __launch_bounds__(JOIN_THREADS)
join_group(const T* __restrict__ e, const T* __restrict__ r, T* __restrict__ o, int64_t nv,
           int G, F f) {
  using V = rt::Vec16<T>;
  const int64_t stride = (int64_t)gridDim.x * JOIN_THREADS;
  int64_t i = (int64_t)blockIdx.x * JOIN_THREADS + threadIdx.x;
  const int c0 = (int)(i % G) * V::N;
  float q[V::N][F::ROWS];
#pragma unroll
  for (int k = 0; k < F::ROWS; ++k) {
    const float* row = f.row[k] + c0;
    if (rt::aligned16(row)) {
#pragma unroll
      for (int j = 0; j < V::N; j += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + j));
        q[j][k] = v.x;
        q[j + 1][k] = v.y;
        q[j + 2][k] = v.z;
        q[j + 3][k] = v.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < V::N; ++j) q[j][k] = __ldg(row + j);
    }
  }
  const uint4* ev = reinterpret_cast<const uint4*>(e);
  const uint4* rv = reinterpret_cast<const uint4*>(r);
  uint4* ov = reinterpret_cast<uint4*>(o);
  auto join = [&](const uint4& ue, const uint4& ur) {
    float a[V::N], b[V::N];
    V::unpack(ue, a);
    V::unpack(ur, b);
#pragma unroll
    for (int j = 0; j < V::N; ++j) a[j] = f(a[j], b[j], q[j]);
    return V::pack(a);
  };
  for (; i + (JOIN_U - 1) * stride < nv; i += JOIN_U * stride) {
    uint4 ue[JOIN_U], ur[JOIN_U];
#pragma unroll
    for (int u = 0; u < JOIN_U; ++u) {
      ue[u] = __ldcs(ev + i + u * stride);
      ur[u] = __ldcs(rv + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < JOIN_U; ++u) __stcs(ov + i + u * stride, join(ue[u], ur[u]));
  }
  for (; i < nv; i += stride) __stcs(ov + i, join(__ldcs(ev + i), __ldcs(rv + i)));
}

// The join element by element (C % V != 0, or a pointer off a 16-byte
// boundary, or the last n % V elements): each channel's rows read per
// element
template <class T, class F>
__global__ void join_scalar(const T* __restrict__ e, const T* __restrict__ r,
                            T* __restrict__ o, int64_t begin, int64_t end, int C, F f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance()) {
    float q[F::ROWS];
#pragma unroll
    for (int k = 0; k < F::ROWS; ++k) q[k] = f.row[k][ch.c];
    rt::st(o + i, f(rt::ld(e + i), rt::ld(r + i), q));
  }
}

// join_group's blocks resident on one SM, asked once per device
template <class T, class F>
inline int join_resident(int* blocks) {
  static int counts[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && counts[dev] > 0) {
    *blocks = counts[dev];
    return 0;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, join_group<T, F>, JOIN_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (*blocks < 1) *blocks = 1;
  if (dev < 32) counts[dev] = *blocks;
  return 0;
}

inline int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// o = f(e, r) over n elements of (n / C, C) views, enqueued on s: join_group
// where C % V == 0 and every pointer is 16-byte aligned, on at most one wave
// of resident blocks whose count is a multiple of G / gcd(G, JOIN_THREADS)
// (so the grid's stride is a multiple of G), each thread walking U
// vectors a step; join_scalar for the rest
template <class T, class F>
inline int launch_join(const T* e, const T* r, T* o, int64_t n, int C, F f, cudaStream_t s) {
  constexpr int N = rt::Vec16<T>::N;
  const bool vec = C % N == 0 && rt::aligned16(e) && rt::aligned16(r) && rt::aligned16(o);
  const int64_t nv = vec ? n / N : 0;
  if (nv > 0) {
    const int G = C / N;
    int sms = 0, per_sm = 0;
    int status = wgb::sm_count(&sms);
    if (status == 0) status = join_resident<T, F>(&per_sm);
    if (status != 0) return status;
    const int64_t step = G / gcd64(G, JOIN_THREADS);  // so that G divides the grid's stride
    const int64_t per_block = (int64_t)JOIN_THREADS * JOIN_U;
    const int64_t want = (nv + per_block - 1) / per_block, wave = (int64_t)sms * per_sm;
    int64_t blocks = want < wave ? want : wave;
    blocks = (blocks + step - 1) / step * step;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    join_group<T><<<(unsigned)blocks, JOIN_THREADS, 0, s>>>(e, r, o, nv, G, f);
  }
  if (N * nv < n)
    join_scalar<T><<<rt::ew_blocks(n - N * nv), rt::EW_THREADS, 0, s>>>(e, r, o, N * nv, n, C,
                                                                       f);
  return (int)cudaGetLastError();
}

// sums (2, C) = the tile partials added per channel (tile_sums)
__global__ void __launch_bounds__(CT * FL)
tile_sums_final(const float* __restrict__ part, float* __restrict__ sums, int C,
                int64_t m_tiles) {
  float s0, s1;
  if (tile_sums(part, C, m_tiles, s0, s1)) {
    const int c = blockIdx.x * CT + threadIdx.x;
    sums[c] = s0;
    sums[C + c] = s1;
  }
}

// ---------------------------------------------------------------- bf16

// The bf16 fused conv's gather: x (N, H, W, Cin) bf16 for a k x k window
// at stride `stride` whose origin is (pad_top, pad_left), output (Ho, Wo),
// A((n, oy, ox), (di, dj, ci)) = x[n, stride * oy - pad_top + di, ...],
// K-major; with the prologue each in-image value becomes
// bf16(act(v * scale[ci] + shift[ci])), each step rounded in fp32 as the
// plain version rounds it
struct FusedConvBfA {
  const uint16_t* __restrict__ x;
  const float* __restrict__ scale;
  const float* __restrict__ shift;
  int H, W, Cin, ksize, stride, pad_top, pad_left, Ho, Wo;
  int64_t M;
  bool vec;  // Cin % 8 == 0 and x 16-byte aligned
  bool prologue;
  Act act;

  __device__ uint16_t pro(uint16_t v, float sc, float sh) const {
    const float f = __bfloat162float(__ushort_as_bfloat16(v));
    return bfg::to_bf16(act(__fadd_rn(__fmul_rn(f, sc), sh)));
  }
};

inline FusedConvBfA conv_loader_bf16(const uint16_t* x, const float* scale, const float* shift,
                                     int N, int H, int W, int Cin, int k, int stride,
                                     int pad_top, int pad_left, int Ho, int Wo, bool prologue,
                                     Act act) {
  return FusedConvBfA{x, scale, shift, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo,
                      (int64_t)N * Ho * Wo, Cin % 8 == 0 && rt::aligned16(x), prologue, act};
}

// One block's copies for fused_conv_wg_kernel (wgb::mainloop's Block). The
// thread copies chunk column cc = tid % 8 (8 K columns) of rows tid / 8 + 32 i,
// i < 4, of each 128 x 64 slice of A; with kVec its chunk is 8 channels of
// one tap, copied by cp.async, and thread 0 asks TMA for B's boxes; without,
// every thread loads its A chunks and B's 8-column chunks element by element.
template <int BN, bool kVec>
struct ConvWgBlock {
  const FusedConvBfA& a;
  const CUtensorMap* wmap;
  const uint16_t* __restrict__ w;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int64_t K, k_lo, k_end;  // the split's K columns [k_lo, k_end) of K
  int N, col0, cc, rlo;
  int64_t off[4];   // x's offset of each row's image
  int iy[4], ix[4];  // each row's window origin
  int64_t k;         // the K column of the thread's chunk in the next slice
  int di, dj, ci;    // its tap and channel

  __device__ ConvWgBlock(const FusedConvBfA& a_, const CUtensorMap* wmap_, const uint16_t* w_,
                         const wgb::Smem<BN>& sm_, uint64_t* full_, int64_t k_lo_, int N_,
                         int col0_, int64_t row0)
      : a(a_), wmap(wmap_), w(w_), sm(sm_), full(full_),
        K((int64_t)a_.ksize * a_.ksize * a_.Cin), N(N_), cc(threadIdx.x & 7),
        rlo(threadIdx.x >> 3) {
    start(row0, col0_, k_lo_, K);
  }

  // the copies pointed at the tile of rows row0 + [0, 128), columns col0 +
  // [0, BN), K columns [k_lo, k_end) (wgb::persistent moves a block from
  // unit to unit; k_end a multiple of 8, A reads zeros past it)
  __device__ void start(int64_t row0, int col0_, int64_t k_lo_, int64_t k_end_, int = 0) {
    col0 = col0_;
    k_lo = k_lo_;
    k_end = k_end_;
    const int howo = a.Ho * a.Wo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = row0 + rlo + 32 * i;
      off[i] = 0;
      iy[i] = -(1 << 29);  // a row past M: outside the image at every tap
      ix[i] = 0;
      if (m < a.M) {
        const int64_t n = m / howo;
        const int rem = (int)(m - n * howo);
        const int oy = rem / a.Wo;
        off[i] = n * a.H * a.W * a.Cin;
        iy[i] = a.stride * oy - a.pad_top;
        ix[i] = a.stride * (rem - oy * a.Wo) - a.pad_left;
      }
    }
    k = k_lo + 8 * cc;
    const int64_t tap = k / a.Cin;
    ci = (int)(k - tap * a.Cin);
    di = (int)(tap / a.ksize);
    dj = (int)(tap - (int64_t)di * a.ksize);
  }

  __device__ bool on(int) const { return true; }

  __device__ bool inside(int y, int x) const {
    return (unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
  }

  __device__ void load(int slot, int kt) {
    uint8_t* st = sm.slot(slot);
    const uint32_t sa = rt::tc::smem_u32(st);
    if constexpr (kVec) {
      const bool kin = k < k_end;
      uint32_t mask = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = iy[i] + di, x = ix[i] + dj;
        const bool ok = kin && inside(y, x);
        const uint16_t* src = ok ? a.x + off[i] + ((int64_t)y * a.W + x) * a.Cin + ci : a.x;
        wgb::cp16(sa + wgb::swz(rlo + 32 * i, cc), src, ok);
        mask |= (uint32_t)ok << i;
      }
      sm.info[slot * wgb::THREADS + threadIdx.x] = mask | (uint32_t)ci << 4;
      k += wgb::BK;
      for (ci += wgb::BK; ci >= a.Cin; ci -= a.Cin)
        if (++dj == a.ksize) {
          dj = 0;
          ++di;
        }
      if (threadIdx.x == 0) {
        const uint32_t bar = rt::tc::smem_u32(&full[slot]);
        rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::B_BYTES);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          wgb::tma_2d(sa + wgb::Tile<BN>::A_BYTES + j * wgb::HALF, wmap, bar, col0 + 64 * j,
                      (int)(k_lo + (int64_t)kt * wgb::BK));
      }
    } else {
      // the chunk's 8 columns decoded once for the 4 rows by the thread's
      // (tap, channel) cursor: tap (ty, tx), channel c, offset from the
      // row's window origin (-1: past k_end)
      int ty[8], tx[8], c[8];
      int64_t rel[8];
      int y0 = di, x0 = dj, c0 = ci;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ty[e] = y0;
        tx[e] = x0;
        c[e] = c0;
        rel[e] = k + e < k_end ? ((int64_t)y0 * a.W + x0) * a.Cin + c0 : -1;
        if (++c0 == a.Cin) {
          c0 = 0;
          if (++x0 == a.ksize) {
            x0 = 0;
            ++y0;
          }
        }
      }
      // every load issued before any is used (no branch between them), then
      // the prologue on the values that are taps inside the image
      uint16_t v[4][8];
      uint32_t in = 0;  // bit 8 i + e: value e of row i is a tap inside the image
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint16_t* base = a.x + off[i] + ((int64_t)iy[i] * a.W + ix[i]) * a.Cin;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool ok = rel[e] >= 0 && inside(iy[i] + ty[e], ix[i] + tx[e]);
          v[i][e] = ok ? bfg::ld16(base + rel[e]) : (uint16_t)0;
          in |= (uint32_t)ok << (8 * i + e);
        }
      }
      if (a.prologue) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float sc = __ldg(a.scale + c[e]), sh = __ldg(a.shift + c[e]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (in >> (8 * i + e) & 1) v[i][e] = a.pro(v[i][e], sc, sh);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(st + wgb::swz(rlo + 32 * i, cc)) = bfg::pack8(v[i]);
      k += wgb::BK;
      for (ci += wgb::BK; ci >= a.Cin; ci -= a.Cin)
        if (++dj == a.ksize) {
          dj = 0;
          ++di;
        }
      // B: BN / 64 halves of 64 K rows x 8 chunks of 8 columns
      const int64_t kb = k_lo + (int64_t)kt * wgb::BK;
#pragma unroll
      for (int p = 0; p < BN / 32; ++p) {
        const int q = threadIdx.x + wgb::THREADS * p;
        const int hb = q / 512, kr = (q / 8) % 64, j = q % 8;
        const int c = col0 + 64 * hb + 8 * j;
        uint16_t v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = kb + kr < K && c + e < N ? bfg::ld16(w + (kb + kr) * N + c + e) : 0;
        *reinterpret_cast<uint4*>(st + wgb::Tile<BN>::A_BYTES + hb * wgb::HALF +
                                  wgb::swz(kr, j)) = bfg::pack8(v);
      }
      if (threadIdx.x == 0) rt::wg::mbar_expect_tx(&full[slot], 0);  // no TMA: arrive
    }
  }

  // the prologue on the chunks this thread copied into slice kt's slot
  __device__ void fix(int slot, int = 0) const {
    if constexpr (kVec) {
      if (!a.prologue) return;
      const uint32_t info = sm.info[slot * wgb::THREADS + threadIdx.x];
      if (!(info & 15)) return;
      const int c = (int)(info >> 4);
      float sc[8], sh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = __ldg(a.scale + c + e);
        sh[e] = __ldg(a.shift + c + e);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(info >> i & 1)) continue;
        uint4* p = reinterpret_cast<uint4*>(sm.slot(slot) + wgb::swz(rlo + 32 * i, cc));
        const uint4 u = *p;
        uint16_t v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = a.pro(bfg::half_of(u, e), sc[e], sh[e]);
        *p = bfg::pack8(v);
      }
    }
  }
};

// y (M, N) bf16 of the conv gathered by `a` with the weight (K, N) (by TMA
// through wmap with kVec, else read from w), on 128 x BN tiles; split
// blockIdx.z of K's slices [z * chunk, (z + 1) * chunk): with ws its fp32
// partials into ws + z * M * N, else y and, unless tile_sums is nullptr,
// the tile's column sums
template <int BN, bool kVec>
__global__ void __launch_bounds__(wgb::THREADS, wgb::Tile<BN>::MIN_BLOCKS)
fused_conv_wg_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ FusedConvBfA a, const uint16_t* __restrict__ w,
                     uint16_t* __restrict__ y, float* __restrict__ ws, int N, int64_t chunk,
                     float* __restrict__ tile_sums) {
  extern __shared__ __align__(1024) uint8_t fc_wg_smem[];
  __shared__ __align__(8) uint64_t full[wgb::Tile<BN>::STAGES];
  const wgb::Smem<BN> sm = wgb::smem_layout<BN>(fc_wg_smem);
  const int64_t row0 = (int64_t)blockIdx.x * wgb::BM;
  const int col0 = blockIdx.y * BN;
  const int64_t slices = wgb::slices_of((int64_t)a.ksize * a.ksize * a.Cin);
  const int64_t s0 = (int64_t)blockIdx.z * chunk;
  const int64_t s1 = slices < s0 + chunk ? slices : s0 + chunk;
  ConvWgBlock<BN, kVec> blk(a, &wmap, w, sm, full, s0 * wgb::BK, N, col0, row0);
  wgb::init_barriers<wgb::Tile<BN>::STAGES>(full);
  float acc[wgb::Tile<BN>::NACC];
  wgb::mainloop<BN, wgb::A_K>(blk, sm, full, s1 > s0 ? (int)(s1 - s0) : 0, acc);
  wgb::store_tile<BN>(acc, sm, row0, col0, a.M, N, y,
                      ws ? ws + (int64_t)blockIdx.z * a.M * N : nullptr);
  if (ws == nullptr && tile_sums != nullptr)
    wgb::tile_stats<BN>(acc, sm, blockIdx.x, col0, a.M, N, tile_sums);
}

template <int BN, bool kVec>
inline int launch_fused_wg(const CUtensorMap& map, const FusedConvBfA& a, const uint16_t* w,
                           uint16_t* y, float* part, int N, float* ws, int splits,
                           cudaStream_t s) {
  auto* kernel = fused_conv_wg_kernel<BN, kVec>;
  const int64_t chunk =
      (wgb::slices_of((int64_t)a.ksize * a.ksize * a.Cin) + splits - 1) / splits;
  return wgb::launch<BN>(
      kernel,
      [&](dim3 grid, int smem) {
        kernel<<<grid, wgb::THREADS, smem, s>>>(map, a, w, y, splits > 1 ? ws : nullptr, N,
                                                chunk, part);
      },
      a.M, N, splits);
}

// Split-K case of the bf16 GEMM: y (M, C) = bf16(sum over the splits of
// ws), added in split order as bfg::splitk_sum_bf16 adds them, and per
// TILE_M-row tile the column sums and sums of squares of that fp32 sum
// before its rounding, into the layout of the GEMM epilogue's partials
__global__ void __launch_bounds__(CT * RT)
splitk_sum_stats_bf16(const float* __restrict__ ws, uint16_t* __restrict__ y,
                      float* __restrict__ part, int64_t M, int C, int splits) {
  const int c = blockIdx.x * CT + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * TILE_M;
  const int64_t r1 = M < r0 + TILE_M ? M : r0 + TILE_M;
  const int64_t mn = M * C;
  float s = 0.f, s2 = 0.f;
  if (c < C) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += RT) {
      float v = 0.f;
      for (int z = 0; z < splits; ++z) v = __fadd_rn(v, ws[(int64_t)z * mn + r * C + c]);
      y[r * C + c] = bfg::to_bf16(v);
      s += v;
      s2 += v * v;
    }
  }
  __shared__ float sh[2][RT][CT];
  sh[0][threadIdx.y][threadIdx.x] = s;
  sh[1][threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      a += sh[0][t][threadIdx.x];
      b += sh[1][t][threadIdx.x];
    }
    part[(2 * (int64_t)blockIdx.y) * C + c] = a;
    part[(2 * (int64_t)blockIdx.y + 1) * C + c] = b;
  }
}

static_assert(TILE_M == wgb::BM, "the bf16 statistics tile is the wgmma core's 128-row tile");

// y (M, Cout) bf16 of the conv gathered by `a` with w (k * k * Cin, Cout)
// bf16 row-major, and the tile partials of its fp32 accumulator in part
// (m_tiles * 2 * Cout floats, m_tiles = ceil(M / TILE_M)); ws holds splits
// * M * Cout floats when splits > 1. Tiles 128 x 64 where Cout <= 64, else
// 128 x 128 (build.wgb_tile_n). Enqueued on s; returns the status.
inline int fused_gemm_bf16(const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* part,
                           int Cout, float* ws, int splits, cudaStream_t s) {
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t K = (int64_t)a.ksize * a.ksize * a.Cin;
  const bool vec = a.vec && Cout % 8 == 0 && rt::aligned16(w);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (vec) {
    const int status = wgb::matrix_map(&map, w, K, Cout);
    if (status != 0) return status;
  }
  auto* gemm = Cout <= 64 ? (vec ? launch_fused_wg<64, true> : launch_fused_wg<64, false>)
                          : (vec ? launch_fused_wg<128, true> : launch_fused_wg<128, false>);
  const int status = gemm(map, a, w, y, part, Cout, ws, splits, s);
  if (status != 0) return status;
  if (splits > 1) {
    const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
    splitk_sum_stats_bf16<<<dim3((unsigned)((Cout + CT - 1) / CT), (unsigned)m_tiles),
                            dim3(CT, RT), 0, s>>>(ws, y, part, a.M, Cout, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace
