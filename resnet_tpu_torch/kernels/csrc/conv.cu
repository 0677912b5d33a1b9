// Direct NHWC convolution with HWIO weights and its two gradients, fp32 in,
// out and accumulator.
//
// Replaces the Pallas kernel resnet_tpu/kernels/conv.py::_conv_kernel (its
// public function conv2d_pallas): a k*k sum of tap GEMMs
// (Ho*Wo, Cin) @ (Cin, Cout) with the reference's centered windows, and
// its custom VJP (conv.py:150-196), which computes dx with the same kernel
// on the stride-dilated gradient and the flipped, transposed filter, and dW
// per tap on the Pallas matmul (matmul.py::_matmul_kernel). Here each of
// the three is one implicit GEMM on the shared core (tiled_gemm.cuh); the
// results equal the VJP's, the blocking does not follow it.
//
// Geometry (resnet_tpu/ops/padding.py::reference_padding): Ho = H / s,
// iy = s*oy - k/2 + i, ix = s*ox - k/2 + j, and taps that fall outside the
// image are skipped (read as 0). No padded, dilated or flipped copy is made:
// the loaders compute the indices. Offsets are 64-bit.
//
//   forward  rows (n, oy, ox), K = (i, j, ci), B = w as (k*k*Cin, Cout);
//   dx       one GEMM per phase (py, px) = (iy mod s, ix mod s): rows
//            (n, qy, qx) with iy = py + s*qy, ix = px + s*qx, K = the taps
//            (i, j) that reach such a row, i = (py + k/2) mod s + s*ti (j
//            alike), times co; A gathers g[n, (iy + k/2 - i)/s, ...] (the
//            division is exact for these taps; 0 out of range), B is the
//            phase's slice of w^T, (taps * Cout, Cin), which the caller cuts
//            from w.permute(0, 1, 3, 2). At stride 1 it is one phase, all
//            taps. The stride-2 taps that would read the zeros of the
//            dilated gradient (3 of 4 at k = 3) are never visited;
//   dW       rows (i, j, ci), K = the pixels (n, oy, ox), B = g as its
//            (N*Ho*Wo, Cout) view; the output is HWIO. K is huge and M*N
//            small, so the wrapper splits K (split-K in tiled_gemm.cuh).
//
// Bound on the H100: compute. ResNet-50's convs do 2*K FLOPs per output
// element with K from 147 to 4608 (the gradients the same FLOPs as the
// forward); the kernels run them on the fp32 FMA units from shared-memory
// tiles. wgmma/TMA tiling and bf16/TF32 tensor cores are left for later
// PRs.

#include "tiled_gemm.cuh"

namespace {

// forward A: x through im2col, neighbouring threads on neighbouring ci
struct ConvA {
  static constexpr bool kMFast = false;
  const float* __restrict__ x;
  int H, W, Cin, k;
  int HoWo, Wo, stride;
  int64_t M;
  // per row of this thread: offset of its image, top-left tap, validity
  int64_t img[rt::A_PER_THREAD];
  int iy0[rt::A_PER_THREAD], ix0[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  // current column: tap (di, dj), channel ci
  int di, dj, ci;

  __device__ void set_row(int r, int64_t m) {
    row_ok[r] = m < M;
    const int64_t mm = row_ok[r] ? m : 0;
    const int64_t n = mm / HoWo;
    const int rem = (int)(mm - n * HoWo);
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    img[r] = n * H * W * Cin;
    iy0[r] = stride * oy - k / 2;
    ix0[r] = stride * ox - k / 2;
  }

  __device__ void set_k(int64_t kk) {
    const int tap = (int)(kk / Cin);
    ci = (int)(kk - (int64_t)tap * Cin);
    di = tap / k;
    dj = tap - di * k;
  }

  __device__ float load(int r) const {
    const int iy = iy0[r] + di;
    const int ix = ix0[r] + dj;
    if (!row_ok[r] || iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    return x[img[r] + ((int64_t)iy * W + ix) * Cin + ci];
  }

  __device__ int64_t out_row(int64_t m) const { return m; }
};

// dx A for one phase (py, px): the output gradient g gathered back onto
// the input rows of that phase, neighbouring threads on neighbouring co
struct ConvDxA {
  static constexpr bool kMFast = false;
  const float* __restrict__ g;
  int H, W, Ho, Wo, Cout, stride;
  int py, px, cy, cx;  // phase, and oy = qy + cy - ti, ox = qx + cx - tj
  int ntj;             // taps of this phase along j
  int QhQw, Qw;        // rows of this phase per image, per image row
  int64_t M;
  int64_t img[rt::A_PER_THREAD];
  int qy[rt::A_PER_THREAD], qx[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  int ti, tj, co;

  __device__ void set_row(int r, int64_t m) {
    row_ok[r] = m < M;
    const int64_t mm = row_ok[r] ? m : 0;
    const int64_t n = mm / QhQw;
    const int rem = (int)(mm - n * QhQw);
    qy[r] = rem / Qw + cy;
    qx[r] = rem - (rem / Qw) * Qw + cx;
    img[r] = n * Ho * Wo * Cout;
  }

  __device__ void set_k(int64_t kk) {
    const int tap = (int)(kk / Cout);
    co = (int)(kk - (int64_t)tap * Cout);
    ti = tap / ntj;
    tj = tap - ti * ntj;
  }

  __device__ float load(int r) const {
    const int oy = qy[r] - ti;
    const int ox = qx[r] - tj;
    if (!row_ok[r] || oy < 0 || oy >= Ho || ox < 0 || ox >= Wo) return 0.f;
    return g[img[r] + ((int64_t)oy * Wo + ox) * Cout + co];
  }

  __device__ int64_t out_row(int64_t m) const {
    const int64_t n = m / QhQw;
    const int rem = (int)(m - n * QhQw);
    const int y = rem / Qw;
    const int x = rem - y * Qw;
    return (n * H + py + (int64_t)stride * y) * W + px + (int64_t)stride * x;
  }
};

// taps i in [0, k) that reach input rows of phase p: i = first + s*t
struct PhaseTaps {
  int first, count, shift;  // shift: (p + k/2 - first) / s
  __host__ __device__ PhaseTaps(int p, int k, int s) {
    first = (p + k / 2) % s;
    count = first < k ? (k - 1 - first) / s + 1 : 0;
    shift = (p + k / 2 - first) / s;
  }
};

// dW A: rows (i, j, ci), columns the output pixels; neighbouring threads on
// neighbouring ci of one pixel
struct ConvDwA {
  static constexpr bool kMFast = true;
  const float* __restrict__ x;
  int H, W, Cin, k, stride, HoWo, Wo;
  int64_t M;
  bool row_ok;
  int di, dj, ci;

  __device__ void set_row(int64_t m) {
    row_ok = m < M;
    const int mm = row_ok ? (int)m : 0;
    const int tap = mm / Cin;
    ci = mm - tap * Cin;
    di = tap / k - k / 2;
    dj = tap % k - k / 2;
  }

  // the wrapper keeps N*Ho*Wo < 2^31, so the pixel decodes in 32 bits
  __device__ float load(int64_t p) const {
    const int pi = (int)p;
    const int n = pi / HoWo;
    const int rem = pi - n * HoWo;
    const int oy = rem / Wo;
    const int ox = rem - oy * Wo;
    const int iy = stride * oy + di;
    const int ix = stride * ox + dj;
    if (!row_ok || iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    return x[(((int64_t)n * H + iy) * W + ix) * Cin + ci];
  }

  __device__ int64_t out_row(int64_t m) const { return m; }
};

__global__ void __launch_bounds__(rt::THREADS)
conv2d_nhwc_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int N, int H, int W, int Cin,
                       int Cout, int k, int stride, int64_t k_chunk) {
  ConvA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.Wo = W / stride;
  a.HoWo = (H / stride) * a.Wo;
  a.stride = stride;
  a.M = (int64_t)N * a.HoWo;
  rt::tiled_gemm<false>(a, w, Cout, y, a.M, Cout, (int64_t)k * k * Cin, k_chunk);
}

__global__ void __launch_bounds__(rt::THREADS)
conv2d_dx_nhwc_f32_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                          float* __restrict__ dx, int N, int H, int W, int Cin,
                          int Cout, int k, int stride, int py, int px,
                          int64_t k_chunk) {
  const PhaseTaps ty(py, k, stride), tx(px, k, stride);
  ConvDxA a;
  a.g = g;
  a.H = H;
  a.W = W;
  a.Ho = H / stride;
  a.Wo = W / stride;
  a.Cout = Cout;
  a.stride = stride;
  a.py = py;
  a.px = px;
  a.cy = ty.shift;
  a.cx = tx.shift;
  a.ntj = tx.count;
  a.Qw = W / stride;
  a.QhQw = (H / stride) * a.Qw;
  a.M = (int64_t)N * a.QhQw;
  rt::tiled_gemm<false>(a, wp, Cin, dx, a.M, Cin, (int64_t)ty.count * tx.count * Cout,
                        k_chunk);
}

__global__ void __launch_bounds__(rt::THREADS)
conv2d_dw_nhwc_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          float* __restrict__ dw, int N, int H, int W, int Cin,
                          int Cout, int k, int stride, int64_t k_chunk) {
  ConvDwA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.stride = stride;
  a.Wo = W / stride;
  a.HoWo = (H / stride) * a.Wo;
  a.M = (int64_t)k * k * Cin;
  rt::tiled_gemm<false>(a, g, Cout, dw, a.M, Cout, (int64_t)N * a.HoWo, k_chunk);
}

}  // namespace

// The callers check stride | H, stride | W, shapes, dtype and contiguity,
// and allocate ws (splits * rows * cols floats) when splits > 1.

// y (N, H/s, W/s, Cout) = conv(x (N, H, W, Cin), w (k, k, Cin, Cout)).
extern "C" int rt_conv2d_nhwc_f32(const float* x, const float* w, float* y, int N,
                                  int H, int W, int Cin, int Cout, int k, int stride,
                                  float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t M = (int64_t)N * (H / stride) * (W / stride);
  return rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        conv2d_nhwc_f32_kernel<<<grid, rt::THREADS, 0, s>>>(x, w, out, N, H, W, Cin,
                                                            Cout, k, stride, kc);
      },
      y, ws, M, Cout, (int64_t)k * k * Cin, splits, s);
}

// dx (N, H, W, Cin) from g (N, H/s, W/s, Cout) and wp, the phases' slices of
// w^T = w.permute(0, 1, 3, 2) one after the other, phase (py, px) in
// row-major order, each (taps_y * taps_x * Cout, Cin) (PhaseTaps). With
// splits > 1 (stride 1 only: one phase) the K split goes through ws.
extern "C" int rt_conv2d_dx_nhwc_f32(const float* g, const float* wp, float* dx,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t rows = (int64_t)N * (H / stride) * (W / stride);
  if (stride > 1 && splits != 1) return (int)cudaErrorInvalidValue;
  const float* b = wp;
  for (int py = 0; py < stride; ++py) {
    for (int px = 0; px < stride; ++px) {
      const int64_t K = (int64_t)PhaseTaps(py, k, stride).count *
                        PhaseTaps(px, k, stride).count * Cout;
      const int status = rt::launch_gemm(
          [&](dim3 grid, float* out, int64_t kc) {
            conv2d_dx_nhwc_f32_kernel<<<grid, rt::THREADS, 0, s>>>(
                g, b, out, N, H, W, Cin, Cout, k, stride, py, px, kc);
          },
          dx, ws, rows, Cin, K, splits, s);
      if (status != 0) return status;
      b += K * Cin;
    }
  }
  return 0;
}

// dw (k, k, Cin, Cout) from x (N, H, W, Cin) and g (N, H/s, W/s, Cout).
extern "C" int rt_conv2d_dw_nhwc_f32(const float* x, const float* g, float* dw,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        conv2d_dw_nhwc_f32_kernel<<<grid, rt::THREADS, 0, s>>>(x, g, out, N, H, W, Cin,
                                                               Cout, k, stride, kc);
      },
      dw, ws, (int64_t)k * k * Cin, Cout, (int64_t)N * (H / stride) * (W / stride),
      splits, s);
}
