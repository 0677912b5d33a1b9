// Device code shared by the fused conv (K8) and the residual join (K9),
// whose kernels and entry points are in csrc/fused_conv.cu, and K10
// (csrc/block_fused.cu): the gather with the prologue, the statistics
// passes and the join. K10's stages 0-2 gather as K8 does, but run their
// GEMMs on wg_gemm.cuh's wgmma core; its stage 3 is K9 with an identity
// residual.
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
// The join is one elementwise pass (16-byte accesses where every pointer is
// 16-byte aligned, a scalar loop for the remainder or the whole range
// otherwise), each product and sum rounded on its own as the plain PyTorch
// version rounds it; one template over the storage type (rowwise.cuh), so
// bf16 e and r are read into fp32 and the result rounded once.
//
// bf16 (K8 and K10 on bf16 tensors): the implicit GEMM runs on
// bf16_gemm.cuh's core with the loader FusedConvBfA: each thread loads 8
// bf16 values of x through registers, so the prologue rides the load: the
// affine, ReLU and cap in fp32 on the upcast value, rounded to bf16 before
// the product (fused_conv.py:61-76); a halo tap and a column past K are
// exactly 0. The statistics come from the fp32 accumulators
// (fused_conv.py:109-110), never from the rounded y: one split, the GEMM
// epilogue's tile partials (bf16_gemm.cuh kStats); several, the split sum
// of splitk_sum_stats_bf16, which adds the fp32 partials in split order,
// rounds y once and takes the column partials from the fp32 sum before
// that rounding.
//
#pragma once

#include "bf16_gemm.cuh"
#include "im2col.cuh"
#include "rowwise.cuh"
#include "tc_gemm.cuh"

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

// e * se + te + r * sr + tr, left to right, each step rounded (K9)
struct JoinRows {
  const float* __restrict__ se;
  const float* __restrict__ te;
  const float* __restrict__ sr;
  const float* __restrict__ tr;
  Act act;
  __device__ float operator()(float e, float r, int c) const {
    return act(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(e, se[c]), te[c]), __fmul_rn(r, sr[c])),
                         tr[c]));
  }
};

// e * se + te + r, left to right, each step rounded: the join of an identity
// residual (K10's stage 3)
struct JoinIdentity {
  const float* __restrict__ se;
  const float* __restrict__ te;
  Act act;
  __device__ float operator()(float e, float r, int c) const {
    return act(__fadd_rn(__fadd_rn(__fmul_rn(e, se[c]), te[c]), r));
  }
};

template <class T, class F>
__global__ void join_vec(const T* __restrict__ e, const T* __restrict__ r, T* __restrict__ o,
                         int64_t nv, int C, F f) {
  using V = rt::Vec16<T>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(V::N * i, V::N * stride, C);
  for (; i < nv; i += stride, ch.advance()) {
    float a[V::N], b[V::N];
    V::load(e + V::N * i, a);
    V::load(r + V::N * i, b);
#pragma unroll
    for (int j = 0; j < V::N; ++j) a[j] = f(a[j], b[j], ch.at(j));
    V::store(o + V::N * i, a);
  }
}

template <class T, class F>
__global__ void join_scalar(const T* __restrict__ e, const T* __restrict__ r,
                            T* __restrict__ o, int64_t begin, int64_t end, int C, F f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance()) rt::st(o + i, f(rt::ld(e + i), rt::ld(r + i), ch.c));
}

// o = f(e, r) over n elements of (n / C, C) views, enqueued on s
template <class T, class F>
inline int launch_join(const T* e, const T* r, T* o, int64_t n, int C, F f, cudaStream_t s) {
  constexpr int N = rt::Vec16<T>::N;
  const bool aligned = rt::aligned16(e) && rt::aligned16(r) && rt::aligned16(o);
  const int64_t nv = aligned ? n / N : 0;
  if (nv > 0)
    join_vec<T><<<rt::ew_blocks(nv), rt::EW_THREADS, 0, s>>>(e, r, o, nv, C, f);
  if (N * nv < n)
    join_scalar<T><<<rt::ew_blocks(n - N * nv), rt::EW_THREADS, 0, s>>>(e, r, o, N * nv, n, C,
                                                                       f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

// A of the bf16 fused conv: the im2col gather of x (N, H, W, Cin) bf16 for
// a k x k window at stride `stride` whose origin is (pad_top, pad_left),
// output (Ho, Wo), K contiguous, 8 values per load8; with the prologue,
// each in-image value becomes bf16(act(v * scale[ci] + shift[ci])), each
// step rounded in fp32 as the plain version rounds it
struct FusedConvBfA {
  static constexpr bool kKContig = true;
  const uint16_t* __restrict__ x;
  const float* __restrict__ scale;
  const float* __restrict__ shift;
  int H, W, Cin, ksize, stride, pad_top, pad_left, Ho, Wo;
  int64_t M;
  bool vec;  // Cin % 8 == 0 and x 16-byte aligned
  bool prologue;
  Act act;

  __device__ uint16_t pro(uint16_t v, int ci) const {
    const float f = __bfloat162float(__ushort_as_bfloat16(v));
    return bfg::to_bf16(act(__fadd_rn(__fmul_rn(f, __ldg(scale + ci)), __ldg(shift + ci))));
  }

  __device__ uint4 load8(int64_t m, int64_t k, int64_t kend) const {
    if (m >= M) return bfg::zero4();
    const int64_t n = m / ((int64_t)Ho * Wo);
    const int rem = (int)(m - n * Ho * Wo);
    const int oy = rem / Wo;
    const int iy0 = stride * oy - pad_top, ix0 = stride * (rem - oy * Wo) - pad_left;
    const uint16_t* base = x + n * H * W * Cin;
    if (vec) {  // k is a multiple of 8: one tap, 8 channels
      if (k >= kend) return bfg::zero4();
      const int tap = (int)(k / Cin), ci = (int)(k - (int64_t)tap * Cin);
      const int iy = iy0 + tap / ksize, ix = ix0 + tap % ksize;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) return bfg::zero4();  // the halo
      const uint4 u = bfg::ld128(base + ((int64_t)iy * W + ix) * Cin + ci);
      if (!prologue) return u;
      uint16_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = pro(bfg::half_of(u, j), ci + j);
      return bfg::pack8(v);
    }
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = 0;
      if (k + j < kend) {
        const int tap = (int)((k + j) / Cin), ci = (int)(k + j - (int64_t)tap * Cin);
        const int iy = iy0 + tap / ksize, ix = ix0 + tap % ksize;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const uint16_t u = bfg::ld16(base + ((int64_t)iy * W + ix) * Cin + ci);
          v[j] = prologue ? pro(u, ci) : u;
        }
      }
    }
    return bfg::pack8(v);
  }
  __device__ int64_t out_row(int64_t m) const { return m; }
};

inline FusedConvBfA conv_loader_bf16(const uint16_t* x, const float* scale, const float* shift,
                                     int N, int H, int W, int Cin, int k, int stride,
                                     int pad_top, int pad_left, int Ho, int Wo, bool prologue,
                                     Act act) {
  return FusedConvBfA{x, scale, shift, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo,
                      (int64_t)N * Ho * Wo, Cin % 8 == 0 && rt::aligned16(x), prologue, act};
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

static_assert(TILE_M == 128, "the bf16 statistics tile is the bf16 GEMM's 128-row tile");

// y (M, Cout) bf16 of the conv gathered by `a` with w (k * k * Cin, Cout)
// bf16 row-major, and the tile partials of its fp32 accumulator in part
// (m_tiles * 2 * Cout floats, m_tiles = ceil(M / TILE_M)); ws holds splits
// * M * Cout floats when splits > 1. Enqueued on s; returns the status.
inline int fused_gemm_bf16(const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* part,
                           int Cout, float* ws, int splits, cudaStream_t s) {
  const int status =
      bfg::enqueue<128, true>(a, bfg::row_mn(w, Cout), y, ws, a.M, Cout,
                              (int64_t)a.ksize * a.ksize * a.Cin, splits, Cout, part, s);
  if (status != 0) return status;
  if (splits > 1) {
    const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
    splitk_sum_stats_bf16<<<dim3((unsigned)((Cout + CT - 1) / CT), (unsigned)m_tiles),
                            dim3(CT, RT), 0, s>>>(ws, y, part, a.M, Cout, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace
