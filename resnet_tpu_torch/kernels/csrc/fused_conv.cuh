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
// The join is one elementwise pass (float4 where every pointer is 16-byte
// aligned, a scalar loop for the remainder or the whole range otherwise),
// each product and sum rounded on its own as the plain PyTorch version
// rounds it.
//
#pragma once

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

template <class F>
__global__ void join_vec4(const float4* __restrict__ e, const float4* __restrict__ r,
                          float4* __restrict__ o, int64_t n4, int C, F f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(4 * i, 4 * stride, C);
  for (; i < n4; i += stride, ch.advance()) {
    const float4 a = e[i];
    const float4 b = r[i];
    o[i] = make_float4(f(a.x, b.x, ch.at(0)), f(a.y, b.y, ch.at(1)), f(a.z, b.z, ch.at(2)),
                       f(a.w, b.w, ch.at(3)));
  }
}

template <class F>
__global__ void join_scalar(const float* __restrict__ e, const float* __restrict__ r,
                            float* __restrict__ o, int64_t begin, int64_t end, int C, F f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance()) o[i] = f(e[i], r[i], ch.c);
}

// o = f(e, r) over n elements of (n / C, C) views, enqueued on s
template <class F>
inline int launch_join(const float* e, const float* r, float* o, int64_t n, int C, F f,
                       cudaStream_t s) {
  const bool aligned = (((uintptr_t)e | (uintptr_t)r | (uintptr_t)o) % 16) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    join_vec4<<<rt::ew_blocks(n4), rt::EW_THREADS, 0, s>>>(
        (const float4*)e, (const float4*)r, (float4*)o, n4, C, f);
  if (4 * n4 < n)
    join_scalar<<<rt::ew_blocks(n - 4 * n4), rt::EW_THREADS, 0, s>>>(e, r, o, 4 * n4, n, C, f);
  return (int)cudaGetLastError();
}

}  // namespace
