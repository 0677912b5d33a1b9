// The fused engine's conv and residual join, fp32 in, out and accumulator.
//
// K8 replaces resnet_tpu/kernels/fused_conv.py::_fused_conv_kernel (public
// function fused_conv):
//
//   y    = conv(u, w),  u = clip(relu(x * scale[ci] + shift[ci]))  (prologue)
//   sums = [sum y, sum y^2] per output channel                     (epilogue)
//
// The previous layer's BN affine and ReLU ride the conv's input read and
// this layer's BN statistics its output write, so neither makes a pass of
// its own over device memory. Here the conv is the implicit GEMM of
// csrc/conv.cu on the shared core (tiled_gemm.cuh) with a new A loader:
// ConvA plus the prologue, applied to each in-image element as it is
// gathered. Taps outside the image stay exactly 0 -- the halo mask of
// fused_conv.py:68-75: relu(shift) must never enter the padding. The window
// origin is the explicit padding (pad_top, pad_left), so the reference's
// centred windows (ops/padding.py) and any explicit padding take one path,
// and stride 2 gathers directly: the TPU kernel's phase-plane rewrite
// (fused_conv.py:248-315) exists only because Mosaic cannot slice a strided
// window, and is not carried over.
//
// Statistics without a sequential grid: the TPU kernel carries [sum y,
// sum y^2] in VMEM across its image-batch grid axis. Here each 64-row M
// tile writes its per-channel partials to a workspace (m_tiles, 2, Cout) in
// the GEMM epilogue (tiled_gemm.cuh kStats), and a second kernel adds them
// per channel in double, in a fixed order. When the GEMM splits K (small M,
// build.split_k), its tiles hold partials, so the statistics are taken from
// the summed y instead: a column pass over y writes the same workspace. No
// atomics, so a run repeats exactly.
//
// K9 replaces ::_join_kernel (public function fused_join):
//   out = clip(relu(e * se[c] + te[c] + r * sr[c] + tr[c])),
// one elementwise pass (float4 where every pointer is 16-byte aligned, a
// scalar loop for the remainder or the whole range otherwise), rounded step
// by step as the plain PyTorch version is.
//
// Bound on the H100: K8 is compute-bound like the plain conv (2 * k*k*Cin
// FLOPs per output element, 147 to 4608 deep in ResNet-50) and runs on the
// fp32 FMA units from shared-memory tiles; the prologue adds 2 FLOPs per
// gathered element and the statistics 2 per output, both under 2% of the
// GEMM. K9 is bound by device memory (8 bytes read, 4 written per element).
// wgmma/TMA tiling, tensor cores and folding K9 into the expand conv's
// epilogue are later work.

#include "rowwise.cuh"
#include "tiled_gemm.cuh"

namespace {

using rt::Act;
using rt::ChannelWalk;

constexpr int CT = 32;  // channels per block of the statistics passes
constexpr int RT = 8;   // row lanes per block of the column pass
constexpr int FL = 32;  // tile lanes per block of the final sum

// A of the forward conv through im2col, the prologue applied in the gather;
// neighbouring threads on neighbouring ci
struct FusedConvA {
  static constexpr bool kMFast = false;
  const float* __restrict__ x;
  const float* __restrict__ scale;
  const float* __restrict__ shift;
  int H, W, Cin, k;
  int HoWo, Wo, stride, pad_top, pad_left;
  bool prologue;
  Act act;
  int64_t M;
  int64_t img[rt::A_PER_THREAD];
  int iy0[rt::A_PER_THREAD], ix0[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  int di, dj, ci;
  float sc, sh;  // the prologue's affine for channel ci

  __device__ void set_row(int r, int64_t m) {
    row_ok[r] = m < M;
    const int64_t mm = row_ok[r] ? m : 0;
    const int64_t n = mm / HoWo;
    const int rem = (int)(mm - n * HoWo);
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    img[r] = n * H * W * Cin;
    iy0[r] = stride * oy - pad_top;
    ix0[r] = stride * ox - pad_left;
  }

  __device__ void set_k(int64_t kk) {
    const int tap = (int)(kk / Cin);
    ci = (int)(kk - (int64_t)tap * Cin);
    di = tap / k;
    dj = tap - di * k;
    if (prologue) {
      sc = scale[ci];
      sh = shift[ci];
    }
  }

  __device__ float load(int r) const {
    const int iy = iy0[r] + di;
    const int ix = ix0[r] + dj;
    if (!row_ok[r] || iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;  // the halo
    const float v = x[img[r] + ((int64_t)iy * W + ix) * Cin + ci];
    return prologue ? act(__fadd_rn(__fmul_rn(v, sc), sh)) : v;
  }

  __device__ int64_t out_row(int64_t m) const { return m; }
};

__global__ void __launch_bounds__(rt::THREADS)
fused_conv_nhwc_f32_kernel(const FusedConvA geometry, const float* __restrict__ w,
                           float* __restrict__ y, int Cout, int64_t k_chunk,
                           float* __restrict__ tile_sums) {
  FusedConvA a = geometry;  // the loader's per-thread state lives in registers
  rt::tiled_gemm<false, true>(a, w, Cout, y, a.M, Cout, (int64_t)a.k * a.k * a.Cin, k_chunk,
                              tile_sums);
}

// Split-K case: per 64-row tile of y (M, C), the column sums and sums of
// squares, into the same workspace layout as the GEMM epilogue's
__global__ void __launch_bounds__(CT * RT)
column_partials(const float* __restrict__ y, float* __restrict__ part, int64_t M, int C) {
  const int c = blockIdx.x * CT + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * rt::BM;
  const int64_t r1 = M < r0 + rt::BM ? M : r0 + rt::BM;
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

// sums (2, C) = the tile partials added per channel in double, fixed order
__global__ void __launch_bounds__(CT * FL)
tile_sums_final(const float* __restrict__ part, float* __restrict__ sums, int C,
                int64_t m_tiles) {
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
  if (threadIdx.y == 0 && c < C) {
    double sa = 0.0, sb = 0.0;
    for (int t = 0; t < FL; ++t) {
      sa += sh[0][t][threadIdx.x];
      sb += sh[1][t][threadIdx.x];
    }
    sums[c] = (float)sa;
    sums[C + c] = (float)sb;
  }
}

struct JoinRows {
  const float* __restrict__ se;
  const float* __restrict__ te;
  const float* __restrict__ sr;
  const float* __restrict__ tr;
  Act act;
  // e * se + te + r * sr + tr, left to right, each step rounded
  __device__ float operator()(float e, float r, int c) const {
    return act(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(e, se[c]), te[c]), __fmul_rn(r, sr[c])),
                         tr[c]));
  }
};

__global__ void join_vec4(const float4* __restrict__ e, const float4* __restrict__ r,
                          float4* __restrict__ o, int64_t n4, int C, JoinRows f) {
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

__global__ void join_scalar(const float* __restrict__ e, const float* __restrict__ r,
                            float* __restrict__ o, int64_t begin, int64_t end, int C,
                            JoinRows f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance()) o[i] = f(e[i], r[i], ch.c);
}

}  // namespace

// y (N, Ho, Wo, Cout) and sums (2, Cout) of the fused conv of x (N, H, W,
// Cin) with w (k, k, Cin, Cout): window (oy, ox) starts at input row
// stride * oy - pad_top, column stride * ox - pad_left. With prologue, scale
// and shift hold Cin floats; without, they are not read. part holds
// m_tiles * 2 * Cout floats (m_tiles = ceil(N * Ho * Wo / 64)); ws holds
// splits * N * Ho * Wo * Cout floats when splits > 1. The caller checks
// shapes, dtype and contiguity.
extern "C" int rt_fused_conv_f32(const float* x, const float* w, const float* scale,
                                 const float* shift, float* y, float* part, float* sums,
                                 int N, int H, int W, int Cin, int Cout, int k, int stride,
                                 int pad_top, int pad_left, int Ho, int Wo, int prologue,
                                 int relu, int has_cap, float cap, float* ws, int splits,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  FusedConvA a;
  a.x = x;
  a.scale = scale;
  a.shift = shift;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.Wo = Wo;
  a.HoWo = Ho * Wo;
  a.stride = stride;
  a.pad_top = pad_top;
  a.pad_left = pad_left;
  a.prologue = prologue != 0;
  a.act = Act{relu != 0, has_cap != 0, cap};
  a.M = (int64_t)N * Ho * Wo;
  const int64_t m_tiles = (a.M + rt::BM - 1) / rt::BM;
  const int status = rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        fused_conv_nhwc_f32_kernel<<<grid, rt::THREADS, 0, s>>>(a, w, out, Cout, kc,
                                                                splits == 1 ? part : nullptr);
      },
      y, ws, a.M, Cout, (int64_t)k * k * Cin, splits, s);
  if (status != 0) return status;
  const unsigned ct = (unsigned)((Cout + CT - 1) / CT);
  if (splits > 1)
    column_partials<<<dim3(ct, (unsigned)m_tiles), dim3(CT, RT), 0, s>>>(y, part, a.M, Cout);
  tile_sums_final<<<ct, dim3(CT, FL), 0, s>>>(part, sums, Cout, m_tiles);
  return (int)cudaGetLastError();
}

// out = clip(relu(e * se + te + r * sr + tr)) over n elements of (n / C, C)
// views; se, te, sr and tr hold C floats.
extern "C" int rt_fused_join_f32(const float* e, const float* r, const float* se,
                                 const float* te, const float* sr, const float* tr, float* o,
                                 int64_t n, int C, int has_cap, float cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const JoinRows f{se, te, sr, tr, Act{true, has_cap != 0, cap}};
  const bool aligned = (((uintptr_t)e | (uintptr_t)r | (uintptr_t)o) % 16) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    join_vec4<<<rt::ew_blocks(n4), rt::EW_THREADS, 0, s>>>(
        (const float4*)e, (const float4*)r, (float4*)o, n4, C, f);
  if (4 * n4 < n)
    join_scalar<<<rt::ew_blocks(n - 4 * n4), rt::EW_THREADS, 0, s>>>(e, r, o, 4 * n4, n, C, f);
  return (int)cudaGetLastError();
}
