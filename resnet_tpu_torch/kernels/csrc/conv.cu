// Direct NHWC convolution with HWIO weights and its two gradients, fp32 in,
// out and accumulator.
//
// Replaces the Pallas kernel resnet_tpu/kernels/conv.py::_conv_kernel (its
// public function conv2d_pallas): a k*k sum of tap GEMMs
// (Ho*Wo, Cin) @ (Cin, Cout) with the reference's centered windows, and
// its custom VJP (conv.py:150-196), which computes dx with the same kernel
// on the stride-dilated gradient and the flipped, transposed filter, and dW
// per tap on the Pallas matmul (conv.py:172-196, matmul.py::_matmul_kernel).
// Here each of the three is one implicit GEMM; the results equal the
// VJP's, the blocking does not follow it.
//
// Geometry: JAX's explicit padding (conv.py:60-72), (lo, hi) above and
// below, left and right: Ho = (H + lo + hi - k) / s + 1, iy = s*oy - lo + i,
// ix = s*ox - lo_w + j, and taps that fall outside the image are skipped
// (read as 0); lo may be negative (a window grid that starts inside the
// input). The entries take (pad_top, pad_left, Ho, Wo), which is that
// padding: the reference's centred windows (resnet_tpu/ops/padding.py::
// reference_padding) are pad k/2 and Ho = H / s. No padded, dilated or
// flipped copy is made: the loaders compute the indices. Offsets are 64-bit.
//
//   forward  rows (n, oy, ox), K = (i, j, ci), B = w as (k*k*Cin, Cout);
//   dx       one GEMM per phase (py, px) = (iy mod s, ix mod s): rows
//            (n, qy, qx) with iy = py + s*qy < H, ix = px + s*qx < W, K = the
//            taps (i, j) that reach such a row, i = (py + lo) mod s + s*ti (j
//            alike), times co; A gathers g[n, (iy + lo - i)/s, ...] (the
//            division is exact for these taps; 0 out of range), B is the
//            phase's slice of w^T, (taps * Cout, Cin), which the caller cuts
//            from w.permute(0, 1, 3, 2). At stride 1 it is one phase, all
//            taps. The stride-2 taps that would read the zeros of the
//            dilated gradient (3 of 4 at k = 3) are never visited;
//   dW       rows (i, j, ci), K = the pixels (n, oy, ox), B = g as its
//            (N*Ho*Wo, Cout) view; the output is HWIO. K is huge and M*N
//            small, so the wrapper splits K.
//
// Bound on the H100: operations. ResNet-50's convs do 2*K FLOPs per output
// element with K from 147 to 4608 (the gradients the same FLOPs as the
// forward); the fp32 FMA units (67 TFLOP/s) reached 14-23% of their peak
// through shared-memory tiles. All three run on the split-TF32 tensor-core
// core of tc_gemm.cuh instead (fp32 accurate, 3 TF32 products per fp32
// product, each 8-deep step in a fresh fragment added in fp32):
// * the forward's loader is im2col.cuh's K-major gather (the fused conv's,
//   K8, without its prologue, which `if constexpr` compiles out), with the
//   window origin at (k/2, k/2): rows decoded once per copying thread, a
//   (di, dj, ci) cursor walked by 32 columns with carries; 16-byte copies
//   of four channels where Cin and Cout are multiples of 4 and x and w are
//   16-byte aligned, 4-byte copies otherwise (the stem's Cin = 3, whose
//   K = 147 makes 4 full K-steps and a ragged fifth). The K split comes from
//   build.tc_split, as dx's and K8's;
// * dW's loader, ConvDwTcA (M-fast A), takes a 16-byte copy of four input
//   channels of one tap and pixel where Cin % 4 == 0 (4-byte copies for the
//   stem's Cin = 3 and other ragged widths), one table entry per pixel and
//   K-step for the block, and a tap offset and channel per copying thread
//   for the whole K loop.
// * dx's loader, ConvDxTcA (K-major A: a row is the gradient's channels at
//   the taps of one input pixel), decodes each copying row (n, qy, qx) once
//   and walks a (ti, tj, co) cursor by 32 columns with carries; at every
//   ResNet-50 dx (Cout % 32 == 0) a K-step is one tap. 16-byte copies of
//   four channels where Cout and Cin are multiples of 4 and g and w are
//   16-byte aligned, 4-byte copies otherwise. A phase's rows land in dx
//   through out_row.
//
// Measured (-Xptxas -v, nvcc 12.9, sm_90a): see tc_gemm.cuh for dW;
// conv2d_tc*_kernel and conv2d_dx_tc*_kernel in PERF.md.

#include <climits>
#include <cstring>

#include "bf16_gemm.cuh"
#include "fused_conv.cuh"  // K8-bf16's gather, which the bf16 forward runs without its prologue
#include "im2col.cuh"
#include "tc_gemm.cuh"
#include "wgb_gemm.cuh"

namespace {

// the window grid of every entry: its origin above and left of the input
// (JAX's lo, possibly negative) and the output's height and width
struct ConvGeo {
  int pad_top, pad_left, Ho, Wo;
};

// taps i in [0, k) that reach input rows of phase p under padding lo (the
// window origin): i = first + s*t
struct PhaseTaps {
  int first, count, shift;  // shift: (p + lo - first) / s, exact
  __host__ __device__ PhaseTaps(int p, int k, int s, int lo) {
    first = ((p + lo) % s + s) % s;
    count = first < k ? (k - 1 - first) / s + 1 : 0;
    shift = (p + lo - first) / s;
  }
};

// input rows of phase p of a dimension of n at stride s: p + s*q < n
__host__ __device__ inline int phase_rows(int n, int p, int s) {
  return n > p ? (n - p + s - 1) / s : 0;
}

// dx A for tc_gemm.cuh, one phase (py, px): row (n, qy, qx) is the input
// pixel (py + s*qy, px + s*qx), column (ti, tj, co) the gradient at
// g[n, qy + cy - ti, qx + cx - tj, co], 0 out of range; K-major
struct ConvDxTcA {
  static constexpr bool kKMajor = true;
  static constexpr bool kPrologue = false;
  const float* __restrict__ g;
  int H, W, Ho, Wo, Cout, stride;
  int py, px, cy, cx;  // phase, and oy = qy + cy - ti, ox = qx + cx - tj
  int ntj;             // taps of this phase along j
  int QhQw, Qw;        // rows of this phase per image, per image row
  int64_t M;

  // the row's (qy + cy, qx + cx) and g's offset there
  struct Row {
    long long off;
    int qy, qx;
    bool ok;
  };
  struct Cursor {
    int ti, tj, co;
  };

  __device__ Row row(int64_t m) const {
    Row r;
    r.ok = m < M;
    const int64_t mm = r.ok ? m : 0;
    const int64_t n = mm / QhQw;
    const int rem = (int)(mm - n * QhQw);
    const int y = rem / Qw;
    r.qy = y + cy;
    r.qx = rem - y * Qw + cx;
    r.off = ((n * Ho + r.qy) * Wo + r.qx) * Cout;
    return r;
  }

  __device__ Cursor cursor(int64_t k) const {
    Cursor c;
    const int tap = (int)(k / Cout);
    c.co = (int)(k - (int64_t)tap * Cout);
    c.ti = tap / ntj;
    c.tj = tap - c.ti * ntj;
    return c;
  }

  __device__ void advance(Cursor& c) const {
    c.co += rt::tc::BK;
    while (c.co >= Cout) {
      c.co -= Cout;
      if (++c.tj == ntj) {
        c.tj = 0;
        ++c.ti;
      }
    }
  }

  __device__ bool in(const Row& r, const Cursor& c) const {
    const int oy = r.qy - c.ti;
    const int ox = r.qx - c.tj;
    return r.ok && oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
  }

  __device__ const float* at(const Row& r, const Cursor& c) const {
    return g + r.off - ((long long)c.ti * Wo + c.tj) * Cout + c.co;
  }

  __device__ int64_t out_row(int64_t m) const {
    const int64_t n = m / QhQw;
    const int rem = (int)(m - n * QhQw);
    const int y = rem / Qw;
    const int x = rem - y * Qw;
    return (n * H + py + (int64_t)stride * y) * W + px + (int64_t)stride * x;
  }
};

// dW A for tc_gemm.cuh: A((i, j, ci), p) = x[n, s*oy + i - pad_top,
// s*ox + j - pad_left, ci] for the pixel p = (n, oy, ox); neighbouring rows
// are neighbouring channels of one tap
struct ConvDwTcA {
  static constexpr bool kKMajor = false;
  const float* __restrict__ x;
  int H, W, Cin, k, stride, Ho, Wo, pad_top, pad_left;
  int64_t M;
  int step_y, step_x;  // BK pixels = step_y output rows + step_x columns

  struct Cursor {
    int n, oy, ox;
  };
  // the pixel's offset in x at its window's center, and that center
  struct Col {
    long long off;
    int iy, ix;
  };
  // the thread's rows: tap offset (di, dj) from the center, and offset in x
  struct Row {
    long long off;
    int di, dj;
    bool ok;
  };

  // the wrapper keeps N*Ho*Wo < 2^31, so a pixel decodes in 32 bits
  __device__ Cursor cursor(int64_t p) const {
    const int pi = (int)p;
    Cursor c;
    c.n = pi / (Ho * Wo);
    const int rem = pi - c.n * Ho * Wo;
    c.oy = rem / Wo;
    c.ox = rem - c.oy * Wo;
    return c;
  }

  __device__ void advance(Cursor& c) const {
    c.ox += step_x;
    c.oy += step_y;
    if (c.ox >= Wo) {
      c.ox -= Wo;
      ++c.oy;
    }
    while (c.oy >= Ho) {
      c.oy -= Ho;
      ++c.n;
    }
  }

  __device__ Col col(const Cursor& c, bool in_range) const {
    Col e;
    e.iy = in_range ? stride * c.oy : INT_MIN / 2;  // fails every bounds test
    e.ix = stride * c.ox;
    e.off = (((long long)c.n * H + stride * c.oy) * W + stride * c.ox) * Cin;
    return e;
  }

  __device__ Row row(int64_t m) const {
    Row r;
    r.ok = m < M;
    const int mm = r.ok ? (int)m : 0;
    const int tap = mm / Cin;
    const int ci = mm - tap * Cin;
    r.di = tap / k - pad_top;
    r.dj = tap % k - pad_left;
    r.off = ((long long)r.di * W + r.dj) * Cin + ci;
    return r;
  }

  __device__ const float* src(const Row& r, const Col& c, bool& ok) const {
    const int iy = c.iy + r.di;
    const int ix = c.ix + r.dj;
    ok = r.ok && iy >= 0 && iy < H && ix >= 0 && ix < W;
    return ok ? x + c.off + r.off : x;
  }

  __device__ int64_t out_row(int64_t m) const { return m; }
};

// the forward: im2col.cuh's gather, no prologue, window origin (pad_top, pad_left)
using ConvFwdTcA = Im2colTcA<false>;

// as the dW kernels below: the 128 x 64 tile capped at 128 registers, two
// blocks per SM; the 128 x 128 tile one block
template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS, 2)
conv2d_tc64_kernel(const ConvFwdTcA a, const float* __restrict__ w, float* __restrict__ y,
                   int Cout, int64_t k_chunk) {
  rt::tc::gemm_k<64, VEC, false>(a, w, Cout, y, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin,
                                 k_chunk, nullptr);
}

template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
conv2d_tc128_kernel(const ConvFwdTcA a, const float* __restrict__ w, float* __restrict__ y,
                    int Cout, int64_t k_chunk) {
  rt::tc::gemm_k<128, VEC, false>(a, w, Cout, y, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin,
                                  k_chunk, nullptr);
}

template <int BN, int AVEC, int BVEC>
__device__ __forceinline__ void conv2d_dw_tc(const float* __restrict__ x,
                                             const float* __restrict__ g,
                                             float* __restrict__ dw, int N, int H, int W,
                                             int Cin, int Cout, int k, int stride,
                                             const ConvGeo geo, int64_t k_chunk) {
  ConvDwTcA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.stride = stride;
  a.Ho = geo.Ho;
  a.Wo = geo.Wo;
  a.pad_top = geo.pad_top;
  a.pad_left = geo.pad_left;
  a.M = (int64_t)k * k * Cin;
  a.step_y = rt::tc::BK / a.Wo;
  a.step_x = rt::tc::BK % a.Wo;
  rt::tc::gemm<BN, AVEC, BVEC>(a, g, Cout, dw, a.M, Cout, (int64_t)N * a.Ho * a.Wo,
                               k_chunk);
}

// Registers decide the blocks resident per SM (build.py TC_BLOCKS_PER_SM
// plans the splits by it): a 128 x 64 tile is capped at 128 registers a
// thread so that two blocks fit (140-143 uncapped, a few dozen bytes of
// spills capped, and 0.41 against 0.50 ms on the stem's dW on the H100); a
// 128 x 128 tile takes what it needs (176-183, one block; a minimum of one
// block in __launch_bounds__ made ptxas take 255 and spill).
template <int AVEC, int BVEC>
__global__ void __launch_bounds__(rt::tc::THREADS, 2)
conv2d_dw_tc64_kernel(const float* __restrict__ x, const float* __restrict__ g,
                      float* __restrict__ dw, int N, int H, int W, int Cin, int Cout,
                      int k, int stride, const ConvGeo geo, int64_t k_chunk) {
  conv2d_dw_tc<64, AVEC, BVEC>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, k_chunk);
}

template <int AVEC, int BVEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
conv2d_dw_tc128_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ dw, int N, int H, int W, int Cin, int Cout,
                       int k, int stride, const ConvGeo geo, int64_t k_chunk) {
  conv2d_dw_tc<128, AVEC, BVEC>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, k_chunk);
}

template <int BN, int VEC>
__device__ __forceinline__ void conv2d_dx_tc(const float* __restrict__ g,
                                             const float* __restrict__ wp,
                                             float* __restrict__ dx, int N, int H, int W,
                                             int Cin, int Cout, int k, int stride, int py,
                                             int px, const ConvGeo geo, int64_t k_chunk) {
  const PhaseTaps ty(py, k, stride, geo.pad_top), tx(px, k, stride, geo.pad_left);
  ConvDxTcA a;
  a.g = g;
  a.H = H;
  a.W = W;
  a.Ho = geo.Ho;
  a.Wo = geo.Wo;
  a.Cout = Cout;
  a.stride = stride;
  a.py = py;
  a.px = px;
  a.cy = ty.shift;
  a.cx = tx.shift;
  a.ntj = tx.count;
  a.Qw = phase_rows(W, px, stride);
  a.QhQw = phase_rows(H, py, stride) * a.Qw;
  a.M = (int64_t)N * a.QhQw;
  rt::tc::gemm_k<BN, VEC, false>(a, wp, Cin, dx, a.M, Cin,
                                 (int64_t)ty.count * tx.count * Cout, k_chunk, nullptr);
}

// as the dW kernels: the 128 x 64 tile capped at 128 registers, two blocks
// per SM; the 128 x 128 tile one block
template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS, 2)
conv2d_dx_tc64_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                      float* __restrict__ dx, int N, int H, int W, int Cin, int Cout, int k,
                      int stride, int py, int px, const ConvGeo geo, int64_t k_chunk) {
  conv2d_dx_tc<64, VEC>(g, wp, dx, N, H, W, Cin, Cout, k, stride, py, px, geo, k_chunk);
}

template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
conv2d_dx_tc128_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                       float* __restrict__ dx, int N, int H, int W, int Cin, int Cout, int k,
                       int stride, int py, int px, const ConvGeo geo, int64_t k_chunk) {
  conv2d_dx_tc<128, VEC>(g, wp, dx, N, H, W, Cin, Cout, k, stride, py, px, geo, k_chunk);
}

template <int BN, int VEC>
int launch_fwd(const ConvFwdTcA& a, const float* w, float* y, int Cout, float* ws, int splits,
               cudaStream_t s) {
  auto* kernel = conv2d_tc128_kernel<VEC>;
  if constexpr (BN == 64) kernel = conv2d_tc64_kernel<VEC>;
  return rt::tc::launch<BN, ConvFwdTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(a, w, out, Cout, kc);
      },
      y, ws, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin, splits, s);
}

// one phase's GEMM, rows (N, its rows of H, its rows of W), K = its taps * Cout
template <int BN, int VEC>
int launch_dx(const float* g, const float* b, float* dx, int N, int H, int W, int Cin,
              int Cout, int k, int stride, int py, int px, const ConvGeo& geo, int64_t K,
              float* ws, int splits, cudaStream_t s) {
  auto* kernel = conv2d_dx_tc128_kernel<VEC>;
  if constexpr (BN == 64) kernel = conv2d_dx_tc64_kernel<VEC>;
  return rt::tc::launch<BN, ConvDxTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(g, b, out, N, H, W, Cin, Cout, k, stride,
                                                   py, px, geo, kc);
      },
      dx, ws, (int64_t)N * phase_rows(H, py, stride) * phase_rows(W, px, stride), Cin, K,
      splits, s);
}

template <int BN, int AVEC, int BVEC>
int launch_dw(const float* x, const float* g, float* dw, int N, int H, int W, int Cin,
              int Cout, int k, int stride, const ConvGeo& geo, float* ws, int splits,
              cudaStream_t s) {
  auto* kernel = conv2d_dw_tc128_kernel<AVEC, BVEC>;
  if constexpr (BN == 64) kernel = conv2d_dw_tc64_kernel<AVEC, BVEC>;
  return rt::tc::launch<BN, ConvDwTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(x, g, out, N, H, W, Cin, Cout, k,
                                                   stride, geo, kc);
      },
      dw, ws, (int64_t)k * k * Cin, Cout, (int64_t)N * geo.Ho * geo.Wo, splits, s);
}

template <int BN>
int launch_dw_vec(bool avec, bool bvec, const float* x, const float* g, float* dw,
                  int N, int H, int W, int Cin, int Cout, int k, int stride,
                  const ConvGeo& geo, float* ws, int splits, cudaStream_t s) {
  if (avec && bvec)
    return launch_dw<BN, 4, 4>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws, splits, s);
  if (avec)
    return launch_dw<BN, 4, 1>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws, splits, s);
  if (bvec)
    return launch_dw<BN, 1, 4>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws, splits, s);
  return launch_dw<BN, 1, 1>(x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws, splits, s);
}

}  // namespace

// The callers check shapes, dtype and contiguity, and allocate ws
// (splits * rows * cols floats) when splits > 1. Every entry takes the
// window grid (pad_top, pad_left, Ho, Wo) after the stride: JAX's explicit
// padding, lo = pad, Ho = (H + lo + hi - k) / s + 1 (the reference's: k/2,
// k/2, H/s, W/s).

// y (N, Ho, Wo, Cout) = conv(x (N, H, W, Cin), w (k, k, Cin, Cout)), K
// split `splits` ways through ws: tiles 128 x 64 where Cout <= 64, else
// 128 x 128 (build.py tc_tile_n); 16-byte copies where Cin and Cout are
// multiples of 4 and x and w 16-byte aligned.
extern "C" int rt_conv2d_nhwc_f32(const float* x, const float* w, float* y, int N,
                                  int H, int W, int Cin, int Cout, int k, int stride,
                                  int pad_top, int pad_left, int Ho, int Wo, float* ws,
                                  int splits, void* stream) {
  if (Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  const ConvFwdTcA a = im2col<false>(x, N, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo);
  const bool vec =
      Cin % 4 == 0 && Cout % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  auto* launch = Cout <= 64 ? (vec ? launch_fwd<64, 4> : launch_fwd<64, 1>)
                            : (vec ? launch_fwd<128, 4> : launch_fwd<128, 1>);
  return launch(a, w, y, Cout, ws, splits, (cudaStream_t)stream);
}

// dx (N, H, W, Cin) from g (N, Ho, Wo, Cout) and wp, the phases' slices of
// w^T = w.permute(0, 1, 3, 2) one after the other, phase (py, px) in
// row-major order, each (taps_y * taps_x * Cout, Cin) (PhaseTaps under the
// padding; a phase with no rows still has its slice). With
// splits > 1 (stride 1 only: one phase) the K split goes through ws. Tiles
// 128 x 64 where Cin <= 64, else 128 x 128 (build.py tc_tile_n); 16-byte
// copies where Cout and Cin are multiples of 4 and g and wp 16-byte aligned.
extern "C" int rt_conv2d_dx_nhwc_f32(const float* g, const float* wp, float* dx,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, int pad_top, int pad_left, int Ho, int Wo,
                                     float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((stride > 1 && splits != 1) || Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  const ConvGeo geo{pad_top, pad_left, Ho, Wo};
  const bool vec = Cout % 4 == 0 && Cin % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                   (uintptr_t)wp % 16 == 0;
  auto* phase = Cin <= 64 ? (vec ? launch_dx<64, 4> : launch_dx<64, 1>)
                          : (vec ? launch_dx<128, 4> : launch_dx<128, 1>);
  const float* b = wp;
  for (int py = 0; py < stride; ++py) {
    for (int px = 0; px < stride; ++px) {
      const int64_t K = (int64_t)PhaseTaps(py, k, stride, pad_top).count *
                        PhaseTaps(px, k, stride, pad_left).count * Cout;
      if (phase_rows(H, py, stride) > 0 && phase_rows(W, px, stride) > 0) {
        const int status = phase(g, b, dx, N, H, W, Cin, Cout, k, stride, py, px, geo, K,
                                 ws, splits, s);
        if (status != 0) return status;
      }
      b += K * Cin;
    }
  }
  return 0;
}

// dw (k, k, Cin, Cout) from x (N, H, W, Cin) and g (N, Ho, Wo, Cout):
// 128 x 64 tiles where Cout <= 64, else 128 x 128 (build.py tc_tile_n
// plans the splits from the same rule); 16-byte copies of x where
// Cin % 4 == 0 and x is 16-byte aligned, of g likewise.
extern "C" int rt_conv2d_dw_nhwc_f32(const float* x, const float* g, float* dw,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, int pad_top, int pad_left, int Ho, int Wo,
                                     float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Ho < 1 || Wo < 1) return (int)cudaErrorInvalidValue;
  const ConvGeo geo{pad_top, pad_left, Ho, Wo};
  const bool avec = Cin % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool bvec = Cout % 4 == 0 && (uintptr_t)g % 16 == 0;
  if (Cout <= 64)
    return launch_dw_vec<64>(avec, bvec, x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws,
                             splits, s);
  return launch_dw_vec<128>(avec, bvec, x, g, dw, N, H, W, Cin, Cout, k, stride, geo, ws,
                            splits, s);
}

// ---------------------------------------------------------------- bf16
//
// The same three GEMMs on bf16 tensors (the forward and dx on
// wgb_gemm.cuh's persistent wgmma loop below, every shape; dW on that
// core's main loop, its ragged or misaligned shapes on bf16_gemm.cuh): bf16
// x, w and g, an fp32 accumulator, bf16 out, rounded once. What JAX computes for bf16 inputs:
// the forward and dx are its conv kernel with `x.dtype` out (conv.py:55-57,
// :105, :163-170); dW is an fp32 matmul of the upcast inputs per tap, cast
// to w.dtype = bf16 (conv.py:180-195). The loaders index as the fp32 ones
// do. A 16-byte copy is 8 channels, so vec needs the channel count a
// multiple of 8 and a 16-byte aligned base.

namespace {

// dW A: A((i, j, ci), p) = x[n, s*oy + i - pad_top, s*ox + j - pad_left,
// ci] for the pixel p = (n, oy, ox); M contiguous (neighbouring rows are
// neighbouring channels of one tap)
struct ConvDwBfA {
  const uint16_t* __restrict__ x;
  int H, W, Cin, ksize, stride, Ho, Wo, pad_top, pad_left;
  int64_t M;  // k * k * Cin
  bool vec;   // Cin % 8 == 0 and x 16-byte aligned

  __device__ uint4 load8(int64_t m, int64_t p, int64_t kend) const {
    if (p >= kend) return bfg::zero4();
    const int pi = (int)p;  // the wrapper keeps N*Ho*Wo < 2^31
    const int n = pi / (Ho * Wo);
    const int rem = pi - n * Ho * Wo;
    const int oy = rem / Wo;
    const int cy = stride * oy - pad_top, cx = stride * (rem - oy * Wo) - pad_left;
    const uint16_t* base = x + (int64_t)n * H * W * Cin;
    if (vec) {
      if (m >= M) return bfg::zero4();
      const int tap = (int)(m / Cin), ci = (int)(m - (int64_t)tap * Cin);
      const int iy = cy + tap / ksize, ix = cx + tap % ksize;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) return bfg::zero4();
      return bfg::ld128(base + ((int64_t)iy * W + ix) * Cin + ci);
    }
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = 0;
      if (m + j < M) {
        const int tap = (int)((m + j) / Cin), ci = (int)(m + j - (int64_t)tap * Cin);
        const int iy = cy + tap / ksize, ix = cx + tap % ksize;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W)
          v[j] = bfg::ld16(base + ((int64_t)iy * W + ix) * Cin + ci);
      }
    }
    return bfg::pack8(v);
  }
};

}  // namespace

// The callers check shapes, dtype and contiguity, and allocate ws (splits *
// rows * cols floats) when splits > 1; the window grid (pad_top, pad_left,
// Ho, Wo) as the fp32 entries take it. Tensors are bf16, passed as their
// 16-bit patterns.

// dw (k, k, Cin, Cout) from x (N, H, W, Cin) and g (N, Ho, Wo, Cout) on
// bf16_gemm.cuh's mma.sync core: the route of the widths the wgmma core
// below does not take (ragged or misaligned operands, a window grid whose
// stride phases it cannot map)
extern "C" int rt_conv2d_dw_nhwc_bf16_mma(const uint16_t* x, const uint16_t* g, uint16_t* dw,
                                          int N, int H, int W, int Cin, int Cout, int k,
                                          int stride, int pad_top, int pad_left, int Ho, int Wo,
                                          float* ws, int splits, void* stream) {
  if (Ho < 1 || Wo < 1) return (int)cudaErrorInvalidValue;
  const int64_t M = (int64_t)k * k * Cin;
  const ConvDwBfA a{x,  H,  W,        Cin,      k, stride, Ho, Wo, pad_top, pad_left,
                    M, Cin % 8 == 0 && bfg::aligned16(x)};
  return bfg::launch<128>(a, bfg::row_mn(g, Cout), dw, ws, M, Cout, (int64_t)N * Ho * Wo,
                          splits, (cudaStream_t)stream);
}

// ------------------------------------------------ bf16 dW on wgb_gemm.cuh
//
// dW[(tap, ci), co] = sum over the output pixels p of x_tap[p, ci] g[p, co]:
// both operands MN-major in memory (channels contiguous), which wgmma takes
// as they are. A 128-row tile is two 64-row halves, one per warpgroup, each
// 64 channels of one tap (Cin % 64 == 0), so a half's slice of 64 pixels is
// one TMA box of x shifted by the tap; g's slice is the box of the same
// pixels. A slice is a bw x bh rectangle of one image's output grid
// (bw * bh = 64, the rectangle of the 64-pixel shapes that leaves the
// fewest padded pixels, dw_box; build.dw_box mirrors it); the parts of a
// box outside the grid, and the halo of x, arrive as zeros. At stride 2,
// x is read through four tensor maps, one per phase (iy % 2, ix % 2): the
// view x[n, 2a + ry, 2b + rx, c], whose (b, a) index the output grid, so
// the tap's shift (i - pad_top, j - pad_left, halved) is a whole offset and
// a tap outside the image falls outside the view (a 1x1 conv reads the one
// phase its tap reaches). A 1x1 conv at stride 1 with no padding and the
// input's grid has no halo: x and g are then read as (pixels, C) matrices,
// 64 pixels a slice, with no padding at all.
// The stem (Cin = 3) comes as a copy of x zero-padded to 8 channels (the
// wrapper's; its padded rows of dW are dropped): a tile is then 16 taps of
// 8 channels, gathered by the threads (kNarrow below).
//
// Bound on the H100 (bf16 FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s):
// five of ResNet-50's seven dW shapes at batch 32 by bytes, so each output
// tile reads its slices of x and g once, the tiles of one K range run side
// by side and share them through the L2, and the K split (build.wgb_split)
// keeps its fp32 partials few beside x and g.
namespace {

struct DwMaps {
  CUtensorMap x[4];  // x per stride phase 2 * ry + rx (one at stride 1)
  CUtensorMap g;     // g (N, Ho, Wo, Cout)
};

struct DwGeom {
  int Cin, ksize, stride, bw, bh, nbx, nby;
  int64_t slices, M;  // slices of the whole K; M = k * k * Cin
  int N;
  const uint16_t* x;  // the narrow tiles' x, gathered by the threads
  int H, W, Ho, Wo, pad_top, pad_left;
};

template <int BN, bool kNarrow>
struct DwBlock {
  const DwMaps& maps;
  const DwGeom& geo;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int64_t s0;  // the split's first slice
  int col0;
  // the wide tiles': each half's x map (stride phase), shift and channel
  int map[2], qx[2], qy[2], c0[2];
  bool live[2];
  // the narrow tiles': the thread's pixel of each slice (p = tid % 64) and
  // its four taps (tid / 64 + 4 j of the tile's 16), their shifts, and
  // where their 16 bytes land in a slot
  int py, px, dy[4], dx[4];
  uint32_t dst[4];
  bool tap_ok[4];

  __device__ bool on(int wg) const { return live[wg]; }
  __device__ void fix(int, int) const {}

  // tap's x map (its stride phase) and its shift in that map's pixels
  __device__ void shift(int tap, int& m, int& sx, int& sy) const {
    const int k = geo.ksize, s = geo.stride;
    const int ty = tap / k - geo.pad_top, tx = tap % k - geo.pad_left;
    // at stride 2, iy = 2 oy + ty = 2 (oy + sy) + ry with ry = ty mod 2
    const int ry = s == 2 ? ty & 1 : 0, rx = s == 2 ? tx & 1 : 0;
    m = 2 * ry + rx;
    sy = s == 2 ? (ty - ry) / 2 : ty;
    sx = s == 2 ? (tx - rx) / 2 : tx;
  }

  __device__ void setup(int64_t row0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t mh = row0 + 64 * h;
      live[h] = mh < geo.M;
      const int tap = (int)(mh / geo.Cin);
      c0[h] = (int)(mh - (int64_t)tap * geo.Cin);
      shift(tap, map[h], qx[h], qy[h]);
    }
    if constexpr (kNarrow) {
      const int p = threadIdx.x & 63;
      py = p / geo.bw;
      px = p - py * geo.bw;
      const int kk = geo.ksize * geo.ksize;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = (threadIdx.x >> 6) + 4 * j;
        const int tap = (int)(row0 / 8) + u;
        tap_ok[j] = tap < kk;
        dy[j] = tap / geo.ksize - geo.pad_top;
        dx[j] = tap % geo.ksize - geo.pad_left;
        dst[j] = (u / 8) * wgb::HALF + (u % 8) * wgb::ATOM + p * 16;
      }
    }
  }

  __device__ void load(int slot, int kt) const {
    const int64_t t = s0 + kt;
    const int per_img = geo.nby * geo.nbx;
    const int n = (int)(t / per_img);
    const int rem = (int)(t - (int64_t)n * per_img);
    const int by = rem / geo.nbx;
    const int ox = (rem - by * geo.nbx) * geo.bw, oy = by * geo.bh;
    const uint32_t st = rt::tc::smem_u32(sm.slot(slot));
    if constexpr (kNarrow) {  // every thread: 4 taps of its pixel, 16 bytes each
      const int y = oy + py, x = ox + px;
      const bool pix = y < geo.Ho && x < geo.Wo;
      const uint16_t* img = geo.x + (int64_t)n * geo.H * geo.W * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int iy = geo.stride * y + dy[j], ix = geo.stride * x + dx[j];
        const bool ok = tap_ok[j] && pix && (unsigned)iy < (unsigned)geo.H &&
                        (unsigned)ix < (unsigned)geo.W;
        wgb::cp16(st + dst[j], ok ? img + ((int64_t)iy * geo.W + ix) * 8 : geo.x, ok);
      }
    }
    if (threadIdx.x != 0) return;
    const uint32_t bar = rt::tc::smem_u32(&full[slot]);
    if constexpr (kNarrow) {
      rt::wg::mbar_expect_tx(&full[slot], (uint32_t)wgb::Tile<BN>::B_BYTES);
    } else {
      rt::wg::mbar_expect_tx(&full[slot], (uint32_t)((live[0] + live[1]) * wgb::HALF +
                                                     wgb::Tile<BN>::B_BYTES));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (live[h])
          wgb::tma_4d(st + h * wgb::HALF, &maps.x[map[h]], bar, c0[h], ox + qx[h], oy + qy[h],
                      n);
    }
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      wgb::tma_4d(st + wgb::Tile<BN>::A_BYTES + j * wgb::HALF, &maps.g, bar, col0 + 64 * j, ox,
                  oy, n);
  }
};

// kNarrow: Cin == 8, a tile is 16 taps of 8 channels (A_MN8), gathered by
// the threads with cp.async (sixteen 1 KB TMA boxes a slice cost the stem
// 3.6x its time with no A loads at all; dense pixels did not help: the
// requests, not the sectors); else Cin % 64 == 0, a tile two halves of 64
// channels of one tap (A_MN) by TMA
template <int BN, bool kNarrow>
__global__ void __launch_bounds__(wgb::THREADS, wgb::Tile<BN>::MIN_BLOCKS)
conv2d_dw_wg_kernel(const __grid_constant__ DwMaps maps, const __grid_constant__ DwGeom geo,
                    uint16_t* __restrict__ dw, float* __restrict__ ws, int64_t chunk) {
  extern __shared__ __align__(1024) uint8_t dw_wg_smem[];
  __shared__ __align__(8) uint64_t full[wgb::Tile<BN>::STAGES];
  const wgb::Smem<BN> sm = wgb::smem_layout<BN>(dw_wg_smem);
  const int64_t row0 = (int64_t)blockIdx.x * wgb::BM;
  const int64_t s0 = (int64_t)blockIdx.z * chunk;
  const int64_t s1 = geo.slices < s0 + chunk ? geo.slices : s0 + chunk;
  DwBlock<BN, kNarrow> blk{maps, geo, sm, full, s0, (int)blockIdx.y * BN};
  blk.setup(row0);
  wgb::init_barriers<wgb::Tile<BN>::STAGES>(full);
  float acc[wgb::Tile<BN>::NACC];
  wgb::mainloop<BN, kNarrow ? wgb::A_MN8 : wgb::A_MN>(blk, sm, full,
                                                      s1 > s0 ? (int)(s1 - s0) : 0, acc);
  wgb::store_tile<BN>(acc, sm, row0, blk.col0, geo.M, geo.N, dw,
                      ws ? ws + (int64_t)blockIdx.z * geo.M * geo.N : nullptr);
}

// the bw x bh = 64-pixel rectangle of an Ho x Wo output grid that leaves
// the fewest padded pixels, the wider on a tie (build.dw_box)
inline void dw_box(int Ho, int Wo, int& bw, int& bh) {
  static const int boxes[7][2] = {{64, 1}, {32, 2}, {16, 4}, {8, 8}, {4, 16}, {2, 32}, {1, 64}};
  int64_t best = -1;
  for (const auto& b : boxes) {
    const int64_t cost =
        (int64_t)((Wo + b[0] - 1) / b[0] * b[0]) * ((Ho + b[1] - 1) / b[1] * b[1]);
    if (best < 0 || cost < best) {
      best = cost;
      bw = b[0];
      bh = b[1];
    }
  }
}

// a 4-D map of dims {C, w, h, n} (C contiguous) with the given byte
// strides of w, h and n, for boxes {64, bw, bh, 1}
inline int dw_map(CUtensorMap* map, const uint16_t* base, int C, int64_t w, int64_t h, int64_t n,
                  int64_t sw, int64_t sh, int64_t sn, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)sw, (cuuint64_t)sh, (cuuint64_t)sn};
  const cuuint32_t box[4] = {64, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  return wgb::map_bf16(map, base, 4, dims, strides, box);
}

// whether dw_wg reads x and g as (pixels, C) matrices (build.dw_slices)
inline bool dw_flat(int H, int W, int k, int stride, const ConvGeo& geo) {
  return k == 1 && stride == 1 && geo.pad_top == 0 && geo.pad_left == 0 && geo.Ho == H &&
         geo.Wo == W;
}

template <int BN, bool kNarrow>
inline int dw_wg(const uint16_t* x, const uint16_t* g, uint16_t* dw, int N, int H, int W,
                 int Cin, int Cout, int k, int stride, const ConvGeo& cg, float* ws, int splits,
                 cudaStream_t s) {
  const int Ho = cg.Ho, Wo = cg.Wo;
  DwMaps maps;
  memset(&maps, 0, sizeof(maps));
  DwGeom geo{Cin, k,  stride, 0,  0,  0,          0,          0, (int64_t)k * k * Cin,
             Cout, x, H,      W,  Ho, Wo, cg.pad_top, cg.pad_left};
  const int64_t bx = 2 * (int64_t)Cin, bg = 2 * (int64_t)Cout;  // bytes of a pixel
  int status = 0;
  if (dw_flat(H, W, k, stride, cg)) {  // no halo: (pixels, C) matrices
    const int64_t P = (int64_t)N * H * W;
    geo.bw = 64;
    geo.bh = 1;
    geo.nbx = (int)((P + 63) / 64);
    geo.nby = 1;
    geo.slices = geo.nbx;
    if (!kNarrow) status = dw_map(&maps.x[0], x, Cin, P, 1, 1, bx, P * bx, P * bx, 64, 1);
    if (status == 0) status = dw_map(&maps.g, g, Cout, P, 1, 1, bg, P * bg, P * bg, 64, 1);
    // the narrow tiles gather x as one image of P pixels
    geo.H = geo.Ho = 1;
    geo.W = geo.Wo = (int)P;
  } else {
    dw_box(Ho, Wo, geo.bw, geo.bh);
    geo.nbx = (Wo + geo.bw - 1) / geo.bw;
    geo.nby = (Ho + geo.bh - 1) / geo.bh;
    geo.slices = (int64_t)N * geo.nby * geo.nbx;
    status = dw_map(&maps.g, g, Cout, Wo, Ho, N, bg, Wo * bg, (int64_t)Ho * Wo * bg, geo.bw,
                    geo.bh);
    // the phases the taps reach: both parities of dy where k > 1, the one
    // of the tap (-pad_top, -pad_left) at 1x1
    for (int ry = 0; ry < stride && status == 0 && !kNarrow; ++ry)
      for (int rx = 0; rx < stride && status == 0; ++rx) {
        if (stride == 2 && k == 1 && (ry != (-cg.pad_top & 1) || rx != (-cg.pad_left & 1)))
          continue;
        status = dw_map(&maps.x[2 * ry + rx], x + ((int64_t)ry * W + rx) * Cin, Cin,
                        (W - rx + stride - 1) / stride, (H - ry + stride - 1) / stride, N,
                        stride * bx, stride * (int64_t)W * bx, (int64_t)H * W * bx, geo.bw,
                        geo.bh);
      }
  }
  if (status != 0) return status;
  auto* kernel = conv2d_dw_wg_kernel<BN, kNarrow>;
  const int64_t chunk = (geo.slices + splits - 1) / splits;
  float* part = splits > 1 ? ws : nullptr;
  status = wgb::launch<BN>(
      kernel,
      [&](dim3 grid, int smem) {
        kernel<<<grid, wgb::THREADS, smem, s>>>(maps, geo, dw, part, chunk);
      },
      geo.M, Cout, splits);
  if (status != 0 || splits == 1) return status;
  const int64_t mn = geo.M * Cout;
  int64_t blocks = (mn + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  bfg::splitk_sum_bf16<<<(unsigned)blocks, 256, 0, s>>>(ws, dw, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dw (k, k, Cin, Cout) from x (N, H, W, Cin) and g (N, Ho, Wo, Cout) on
// the wgmma core: Cin % 64 == 0 or Cin == 8 (the wrapper pads the stem's 3
// channels to 8), Cout % 8 == 0, x and g 16-byte aligned, stride 1 or 2,
// H and W at least the stride (the wrapper routes every other shape to
// rt_conv2d_dw_nhwc_bf16_mma);
// tiles 128 x 64 where Cout <= 64, else 128 x 128; splits K splits of whole
// slices (ws: splits * k*k*Cin * Cout floats when splits > 1)
extern "C" int rt_conv2d_dw_nhwc_bf16(const uint16_t* x, const uint16_t* g, uint16_t* dw,
                                      int N, int H, int W, int Cin, int Cout, int k,
                                      int stride, int pad_top, int pad_left, int Ho, int Wo,
                                      float* ws, int splits, void* stream) {
  const bool narrow = Cin == 8;
  if ((Cin % 64 != 0 && !narrow) || Cout % 8 != 0 || !bfg::aligned16(x) ||
      !bfg::aligned16(g) || (stride != 1 && stride != 2) || (splits > 1 && ws == nullptr) ||
      H < stride || W < stride || Ho < 1 || Wo < 1)
    return (int)cudaErrorInvalidValue;
  auto* run = Cout <= 64 ? (narrow ? dw_wg<64, true> : dw_wg<64, false>)
                         : (narrow ? dw_wg<128, true> : dw_wg<128, false>);
  return run(x, g, dw, N, H, W, Cin, Cout, k, stride, ConvGeo{pad_top, pad_left, Ho, Wo}, ws,
             splits, (cudaStream_t)stream);
}

// --------------------------------------------- bf16 forward on wgb_gemm.cuh
//
// y[(n, oy, ox), co] = sum over (di, dj, ci) of x[n, s*oy - pad_top + di,
// s*ox - pad_left + dj, ci] w[di, dj, ci, co]: the implicit GEMM of K8-bf16
// (fused_conv.cuh's ConvWgBlock, K-major A) without its prologue and
// statistics, on wgb::persistent: one block per SM walks the units (m tile,
// n tile, K split), and the ring runs across their boundaries. Four A
// loaders; the caller names one (conv.fwd_bf16_route, a function of the
// shapes, the split and the alignment), and the entry refuses a loader the
// shapes or pointers do not allow:
// * FWD_GATHER: Cin % 8 == 0, Cout % 8 == 0, x and w 16-byte aligned:
//   ConvWgBlock<BN, true>, A gathered 16 bytes (8 channels of one tap) at a
//   time by cp.async, the weight (k*k*Cin, Cout) by TMA as it lies;
// * FWD_MATRIX: the same widths at 1x1, stride 1, no padding and the
//   input's grid, where each split is whole
//   slices: A is the (N*H*W, Cin) matrix it is, one TMA box of 128 rows x
//   64 channels a slice (MatWgBlock), thread 0 issuing every copy;
// * FWD_STEM: the stem (Cin = 3, 7x7, stride 2, Cout <= 64, aligned): a
//   kernel row's 7 taps x 3 channels are 21 contiguous values of x, so the
//   threads stage, for each output pixel and kernel row a slice touches
//   (at most 4), the 24 values from the one before the row by 4-byte
//   cp.async (an even element, as W is even and pad_left odd), and once every thread's
//   copies of the slice have landed they set A's rows out of that staging
//   in the plain K order, zeros where a tap falls outside the image
//   (StemStageBlock); the weight (147, Cout) by TMA;
// * FWD_SCALAR: every other shape (ragged widths, misaligned tensors):
//   ConvWgBlock<BN, false>, both operands loaded by the threads 2 bytes at
//   a time.
// A's K order is the plain (di, dj, ci) on every loader.
// K splits by build.tc_split at bf16_gemm.cuh's chunk (bfg::k_chunk_for,
// a multiple of 16 columns), and one fp32 add per k16 step in K order, so
// the result has the bits of bf16_gemm.cuh's kernel, which ran this entry
// before. Split partials go through ws (fp32 pairs from the registers) and
// splitk_sum_bf16 in split order; otherwise a unit's bf16 tile leaves from
// shared memory by TMA (wgb::store_tile_tma), or from the registers
// (FWD_SCALAR). The bf16 FC forward (matmul.cu rt_matmul_bf16) calls this
// entry as a 1x1/s1 conv of (M, 1, 1, K) with its own K split.
//
// Bound on the H100: bytes at batch 32 for the stem and the 1x1s with 64
// input channels, operations for the 3x3s and the deep 1x1s (PERF.md);
// persistence hides each unit's ring fill, and 1x1s cost no gather.
namespace {

constexpr int FWD_GATHER = 0, FWD_MATRIX = 1, FWD_SCALAR = 2, FWD_STEM = 3;
constexpr int STEM_CIN = 3, STEM_K = 7, STEM_ROW = STEM_K * STEM_CIN;  // 21 values a kernel row
constexpr int STEM_WIN = 24;   // a staged window: one value before a kernel row's 21, two after
constexpr int STEM_ROWS = 4;   // kernel rows a 64-deep slice touches (63 = 3 * 21)
constexpr int STEM_STAGES = 4;  // ring slots, each with its staging
constexpr int STEM_STG = wgb::BM * STEM_ROWS * STEM_WIN * 2;  // staging bytes a slot

// A by TMA: the (M, Cin) matrix of a 1x1/s1 conv, 128-row boxes
template <int BN>
struct MatWgBlock {
  const CUtensorMap* amap;
  const CUtensorMap* wmap;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int64_t row0 = 0, k_lo = 0;
  int col0 = 0;

  // a unit's split [k, k_end) is whole slices, or the last one of K
  __device__ void start(int64_t r, int c, int64_t k, int64_t, int) {
    row0 = r;
    col0 = c;
    k_lo = k;
  }
  __device__ void load(int slot, int kt) const {
    if (threadIdx.x != 0) return;
    const uint32_t st = rt::tc::smem_u32(sm.slot(slot)), bar = rt::tc::smem_u32(&full[slot]);
    const int kk = (int)(k_lo + (int64_t)kt * wgb::BK);
    rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::STAGE_BYTES);
    wgb::tma_2d(st, amap, bar, kk, (int)row0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      wgb::tma_2d(st + wgb::Tile<BN>::A_BYTES + j * wgb::HALF, wmap, bar, col0 + 64 * j, kk);
  }
  __device__ void fix(int, int) const {}
};

// A of the stem in the plain K order k = 21 di + 3 dj + ci, out of a staging
// of x's windows. The copying side: thread t stages kernel-row slots
// 2 (t % 2) + {0, 1} of row t / 2, 12 4-byte copies each; a copy with no
// tap inside the image (or outside the image's rows, or the tensor) reads
// nothing and lands zeros, and once its copies have landed the thread
// zeroes the single values of the others that are no tap (fix). The
// setting side (fix, after a block barrier): rows t / 8 + 32 i, i < 4,
// chunk column t % 8, as ConvWgBlock. What fix needs of a slot is recorded
// with it: the copier runs LOOK slices ahead, into the next unit. K is one
// split (147 columns, fewer than 16 k16 steps), so slice kt starts at 64 kt.
template <int BN>
struct StemStageBlock {
  const FusedConvBfA& a;
  const CUtensorMap* wmap;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  uint8_t* stage;  // STEM_STAGES x [BM rows][STEM_ROWS][STEM_WIN] bf16
  int64_t total;   // x's elements
  int col0 = 0, cr, ch, cc, rlo;
  int64_t ce = 0;      // x's element before the copy row's window at kernel row 0
  int cy = 0;          // that window's first image row
  uint32_t pairs = 0;  // bit p: copy p of a window holds a tap inside the image
  uint32_t zero = 0;   // bit v: value v of a window is copied but no such tap

  __device__ StemStageBlock(const FusedConvBfA& a_, const CUtensorMap* wmap_,
                            const wgb::Smem<BN>& sm_, uint64_t* full_, uint8_t* stage_)
      : a(a_), wmap(wmap_), sm(sm_), full(full_), stage(stage_),
        total(a_.M / ((int64_t)a_.Ho * a_.Wo) * a_.H * a_.W * STEM_CIN), cr(threadIdx.x >> 1),
        ch(threadIdx.x & 1), cc(threadIdx.x & 7), rlo(threadIdx.x >> 3) {}

  __device__ void start(int64_t row0, int c, int64_t, int64_t, int) {
    col0 = c;
    cy = -(1 << 29);  // a row past M: outside the image in every kernel row
    pairs = zero = 0;
    const int64_t m = row0 + cr;
    if (m >= a.M) return;
    const int howo = a.Ho * a.Wo;
    const int n = (int)m / howo;  // M < 2^31 (rt_conv2d_nhwc_bf16)
    const int rem = (int)m - n * howo;
    const int oy = rem / a.Wo;
    const int x = a.stride * (rem - oy * a.Wo) - a.pad_left;
    cy = a.stride * oy - a.pad_top;
    ce = ((int64_t)n * a.H * a.W + (int64_t)cy * a.W + x) * STEM_CIN - 1;
    uint32_t taps = 0;  // bit v: value v = 1 + 3 dj + ci is a tap inside the image
#pragma unroll
    for (int dj = 0; dj < STEM_K; ++dj)
      if ((unsigned)(x + dj) < (unsigned)a.W) taps |= 7u << (1 + STEM_CIN * dj);
#pragma unroll
    for (int p = 0; p < STEM_WIN / 2; ++p) {
      const uint32_t two = taps >> (2 * p) & 3u;
      if (two) {
        pairs |= 1u << p;
        zero |= (~two & 3u) << (2 * p);
      }
    }
  }

  __device__ void load(int slot, int kt) {
    const int kk = kt * wgb::BK, d0 = kk / STEM_ROW;
    const uint32_t dst = rt::tc::smem_u32(stage + slot * STEM_STG) +
                         cr * (STEM_ROWS * STEM_WIN * 2);
    uint32_t rows = 0;  // bit r: window 2 ch + r lies in the image's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ds = 2 * ch + r, di = d0 + ds;
      const bool row_ok = di < STEM_K && (unsigned)(cy + di) < (unsigned)a.H;
      rows |= (uint32_t)row_ok << r;
      const int64_t e0 = ce + (int64_t)di * a.W * STEM_CIN;
#pragma unroll
      for (int p = 0; p < STEM_WIN / 2; ++p) {
        const int64_t e = e0 + 2 * p;
        const bool ok = row_ok && (pairs >> p & 1u) && e >= 0 && e + 2 <= total;
        wgb::cp4(dst + (ds * STEM_WIN + 2 * p) * 2, ok ? a.x + e : a.x, ok);
      }
    }
    sm.info[slot * wgb::THREADS + threadIdx.x] = zero | rows << STEM_WIN;
    if (threadIdx.x == 0) {
      const uint32_t sa = rt::tc::smem_u32(sm.slot(slot)), bar = rt::tc::smem_u32(&full[slot]);
      rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::B_BYTES);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        wgb::tma_2d(sa + wgb::Tile<BN>::A_BYTES + j * wgb::HALF, wmap, bar, col0 + 64 * j, kk);
    }
  }

  // the thread's landed values that are no tap zeroed; then, once every
  // thread's are, A's rows of slice kt set from the staging
  __device__ void fix(int slot, int kt) const {
    uint16_t* stg = reinterpret_cast<uint16_t*>(stage + slot * STEM_STG);
    const uint32_t info = sm.info[slot * wgb::THREADS + threadIdx.x];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(info >> (STEM_WIN + r) & 1u)) continue;
      uint16_t* win = stg + cr * STEM_ROWS * STEM_WIN + (2 * ch + r) * STEM_WIN;
      for (uint32_t z = info & ((1u << STEM_WIN) - 1); z; z &= z - 1) win[__ffs(z) - 1] = 0;
    }
    __syncthreads();
    const int kk = kt * wgb::BK, d0 = kk / STEM_ROW;
    int at[8];  // index in a row's staging (-1: past K)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = kk + 8 * cc + e, di = k / STEM_ROW;
      at[e] = k < STEM_K * STEM_ROW ? (di - d0) * STEM_WIN + 1 + (k - STEM_ROW * di) : -1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rlo + 32 * i;
      uint16_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = at[e] >= 0 ? stg[r * STEM_ROWS * STEM_WIN + at[e]] : (uint16_t)0;
      *reinterpret_cast<uint4*>(sm.slot(slot) + wgb::swz(r, cc)) = bfg::pack8(v);
    }
  }
};

// y (M, N) bf16 (through ymap, or straight from the registers for
// FWD_SCALAR; or, with ws, split z's fp32 partials at ws + z * M * N) of
// the conv gathered by `a`, weight w (by TMA through wmap, and A through
// amap for FWD_MATRIX), over the units of un
template <int BN, int KIND>
__global__ void __launch_bounds__(wgb::THREADS, 1)
conv2d_fwd_wg_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap ymap,
                     const __grid_constant__ FusedConvBfA a, const uint16_t* __restrict__ w,
                     uint16_t* __restrict__ y, float* __restrict__ ws, int N,
                     const wgb::Units un) {
  constexpr int S = KIND == FWD_STEM ? STEM_STAGES : wgb::PTile<BN>::STAGES;
  extern __shared__ __align__(1024) uint8_t fwd_wg_smem[];
  __shared__ __align__(8) uint64_t full[S];
  const wgb::Smem<BN> sm = wgb::psmem_layout<BN, S>(fwd_wg_smem);
  wgb::init_barriers<S>(full);
  auto epi = [&](const float (&acc)[wgb::Tile<BN>::NACC], int64_t row0, int col0, int z) {
    if (ws)
      wgb::store_pairs<BN>(acc, row0, col0, a.M, N, nullptr, ws + (int64_t)z * a.M * N);
    else if constexpr (KIND == FWD_SCALAR)
      wgb::store_pairs<BN>(acc, row0, col0, a.M, N, y, nullptr);
    else
      wgb::store_tile_tma<BN>(acc, wgb::p_out<BN, S>(sm), &ymap, row0, col0);
  };
  if constexpr (KIND == FWD_MATRIX) {
    MatWgBlock<BN> blk{&amap, &wmap, sm, full};
    wgb::persistent<BN>(blk, sm, full, un, epi);
  } else if constexpr (KIND == FWD_STEM) {
    StemStageBlock<BN> blk(a, &wmap, sm, full, reinterpret_cast<uint8_t*>(sm.info + S * wgb::THREADS));
    wgb::persistent<BN, S>(blk, sm, full, un, epi);
  } else {
    ConvWgBlock<BN, KIND == FWD_GATHER> blk(a, &wmap, w, sm, full, 0, N, 0, 0);
    wgb::persistent<BN>(blk, sm, full, un, epi);
  }
  wgb::store_tma_wait();
}

template <int BN, int KIND>
int fwd_wg(const CUtensorMap& amap, const CUtensorMap& wmap, const CUtensorMap& ymap,
           const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* ws, int N,
           const wgb::Units& un, cudaStream_t s) {
  auto* kernel = conv2d_fwd_wg_kernel<BN, KIND>;
  constexpr int smem = KIND == FWD_STEM
                           ? wgb::PTile<BN, STEM_STAGES>::SMEM + STEM_STAGES * STEM_STG
                           : wgb::PTile<BN>::SMEM;
  float* part = un.splits > 1 ? ws : nullptr;
  return wgb::launch_persistent(
      kernel, smem, un.count(),
      [&](unsigned blocks, int bytes) {
        kernel<<<blocks, wgb::THREADS, bytes, s>>>(amap, wmap, ymap, a, w, y, part, N, un);
      },
      un.splits, ws, y, a.M * N, s);
}

}  // namespace

// y (N, Ho, Wo, Cout) = conv(x (N, H, W, Cin), w (k, k, Cin, Cout)) on
// the wgmma core, every shape: tiles 128 x 64 where Cout <= 64, else 128 x
// 128; splits K splits (build.tc_split; ws: splits * M * Cout floats when
// splits > 1); y 4-byte aligned; the A loader `route` (FWD_*).
extern "C" int rt_conv2d_nhwc_bf16(const uint16_t* x, const uint16_t* w, uint16_t* y, int N,
                                   int H, int W, int Cin, int Cout, int k, int stride,
                                   int pad_top, int pad_left, int Ho, int Wo, float* ws,
                                   int splits, int route, void* stream) {
  const int64_t M = (int64_t)N * Ho * Wo;
  const int64_t K = (int64_t)k * k * Cin;
  if (Ho < 0 || Wo < 0 || M >= INT32_MAX || K >= INT32_MAX || splits < 1 ||
      (splits > 1 && ws == nullptr) ||
      (uintptr_t)y % 4 != 0 ||
      (M + wgb::BM - 1) / wgb::BM * ((Cout + 63) / 64) * splits >= INT32_MAX)  // wgb::Units
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int64_t chunk = bfg::k_chunk_for(K, splits);
  const bool aligned = bfg::aligned16(x) && bfg::aligned16(w) && bfg::aligned16(y);
  const bool vec = Cin % 8 == 0 && Cout % 8 == 0 && aligned;
  const bool ok = route == FWD_SCALAR ||
                  (route == FWD_GATHER && vec) ||
                  (route == FWD_MATRIX && vec && k == 1 && stride == 1 && pad_top == 0 &&
                   pad_left == 0 && Ho == H && Wo == W &&
                   (splits == 1 || chunk % wgb::BK == 0)) ||
                  (route == FWD_STEM && Cin == STEM_CIN && k == STEM_K && stride == 2 &&
                   W % 2 == 0 && pad_left % 2 != 0 && Cout % 8 == 0 && Cout <= 64 &&
                   splits == 1 && aligned);
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, wmap, ymap;
  memset(&amap, 0, sizeof(amap));
  memset(&wmap, 0, sizeof(wmap));
  memset(&ymap, 0, sizeof(ymap));
  int status = 0;
  if (route != FWD_SCALAR) {
    status = wgb::cached_matrix_map(&wmap, w, K, Cout, wgb::BK);
    if (status == 0 && route == FWD_MATRIX)
      status = wgb::cached_matrix_map(&amap, x, M, Cin, wgb::BM);
    if (status == 0 && splits == 1) status = wgb::cached_matrix_map(&ymap, y, M, Cout, wgb::BM);
  }
  if (status != 0) return status;
  const FusedConvBfA a = conv_loader_bf16(x, nullptr, nullptr, N, H, W, Cin, k, stride, pad_top,
                                          pad_left, Ho, Wo, false, rt::Act{false, false, 0.f});
  const int wide = Cout <= 64 ? 0 : 1;
  const wgb::Units un{(M + wgb::BM - 1) / wgb::BM, (Cout + (wide ? 128 : 64) - 1) / (wide ? 128 : 64),
                      splits, K, chunk};
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
                         const FusedConvBfA&, const uint16_t*, uint16_t*, float*, int,
                         const wgb::Units&, cudaStream_t);
  static const Launch runs[2][4] = {
      {fwd_wg<64, FWD_GATHER>, fwd_wg<64, FWD_MATRIX>, fwd_wg<64, FWD_SCALAR>,
       fwd_wg<64, FWD_STEM>},
      {fwd_wg<128, FWD_GATHER>, fwd_wg<128, FWD_MATRIX>, fwd_wg<128, FWD_SCALAR>, nullptr}};
  return runs[wide][route](amap, wmap, ymap, a, w, y, ws, Cout, un, (cudaStream_t)stream);
}

// ------------------------------------------------- bf16 dx on wgb_gemm.cuh
//
// dx[(n, py + s*qy, px + s*qx), ci] = sum over the phase's taps (ti, tj) and
// co of g[n, qy + cy - ti, qx + cx - tj, co] w[fy + s*ti, fx + s*tj, ci, co]
// ((fy, cy) the first tap and shift of row phase py under pad_top,
// PhaseTaps; (fx, cx) of px under pad_left): per phase (py, px) one GEMM of
// N*Qh*Qw rows, Qh = ceil(H / s) and Qw = ceil(W / s) for every phase (the
// rows of a phase that fall past H or W, where s does not divide them, are
// computed and not stored), over K = its
// taps x Cout in (ti, tj, co) order, on wgb::persistent. B is w as it lies:
// B's column ci at a tap is w[tap, ci, :], Cout contiguous, so B is K-major
// and wgmma reads it without the transpose bit; nothing is cut from w or
// cached. The phases of a strided dx are units of one launch, the deepest
// phase's first (wgb::Units). Four loaders; the caller names one
// (conv.dx_bf16_route, a function of the shapes and the alignment), and the
// entry refuses a loader the shapes or pointers do not allow:
// * DX_MATRIX: a 1x1/s1 dx with no padding and the input's grid whose
//   splits are whole slices: A the (M, Cout)
//   matrix g by TMA boxes of 128 rows x 64 channels, B a box of 64 co x BN
//   ci of w, thread 0 issuing every copy;
// * DX_GATHER: A gathered 16 bytes (8 channels of g at one tap) at a time by
//   cp.async, B by TMA where every slice lies in one tap (k = 1, or Cout %
//   64 == 0 with whole slices);
// * DX_COPY: A as DX_GATHER, B's rows by 16-byte cp.async of 8 co of one tap;
// * DX_SCALAR: every other shape (ragged widths, misaligned tensors): both
//   operands by the threads' 2-byte loads.
// The first three need Cout % 8 == 0, Cin % 8 == 0 (dx's rows in 16-byte
// stores) and g, w and dx 16-byte aligned. A box of B reads BN rows of w
// from the tap's row of ci = col0 on: rows past Cin are the next tap's (or
// zeros past w), and they feed only columns past Cin, which are not stored.
// K splits at stride 1 by build.tc_split at bf16_gemm.cuh's chunk
// (bfg::k_chunk_for), one split a phase at stride > 1, one fp32 add per k16
// step in K order: the bits of bf16_gemm.cuh's kernel, which ran this entry
// before. At stride 1 a tile leaves by TMA (wgb::store_tile_tma), or as
// fp32 partials through ws summed by splitk_sum_bf16 in split order; at
// stride > 1 a phase's rows are not contiguous in dx, and a tile leaves
// through the staged row-mapped store (wgb::store_rows).
//
// Replaces, in bf16, the Pallas conv kernel as the VJP runs it for dx
// (resnet_tpu/kernels/conv.py:150-170, on the dilated gradient with the
// flipped, transposed filter), which this computes without the dilation's
// zeros or a flipped copy. Bound on the H100: bytes for the 1x1s and 3x3s
// with 64 to 128 channels at batch 32, operations for the projection and
// the deep 1x1s (PERF.md); the phases in one launch keep every SM busy
// where one phase alone has too few tiles.
namespace {

constexpr int DX_GATHER = 0, DX_MATRIX = 1, DX_SCALAR = 2, DX_COPY = 3;

struct DxGeom {
  const uint16_t* __restrict__ g;
  const uint16_t* __restrict__ w;
  int H, W, Ho, Wo, Cin, Cout, ksize, stride, pad_top, pad_left;
  int Qh, Qw;  // a phase's rows per image column and row: ceil(H / s), ceil(W / s)
  int M;       // rows of a phase: N * Qh * Qw (< 2^31)
};

// dx's row of row m of phase (py, px), or -1 past H or W (not stored)
struct PhaseRow {
  int H, W, Qh, Qw, stride, py, px;
  __device__ int64_t operator()(int64_t m) const {
    const int mm = (int)m, qhqw = Qh * Qw;
    const int n = mm / qhqw, rem = mm - n * qhqw, qy = rem / Qw;
    const int iy = py + stride * qy, ix = px + stride * (rem - qy * Qw);
    return iy < H && ix < W ? ((int64_t)n * H + iy) * W + ix : -1;
  }
};

// One block's copies for conv2d_dx_wg_kernel (wgb::persistent's Block): the
// thread copies chunk column cc = tid % 8 (8 K columns) of A's rows tid / 8
// + 32 i, i < 4, and of B's rows tid / 8 + 32 i, i < BN / 32, of each slice,
// its (ti, tj, co) cursor walked by 64 columns a slice; thread 0, whose
// chunk starts the slice, names the slice's tap for the TMA boxes.
template <int BN, int KIND>
struct DxWgBlock {
  const DxGeom& d;
  const CUtensorMap* amap;
  const CUtensorMap* bmap;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int row0 = 0, col0 = 0, cc, rlo;
  int k = 0, k_end = 0;        // the thread's chunk's K column in the next slice; the split's end
  int ti = 0, tj = 0, co = 0;  // its tap of the phase and channel
  int fy = 0, fx = 0, ntj = 0;  // the phase's first tap along i and j, its taps along j
  int64_t off[4];              // g's offset of each A row's image
  int oy[4], ox[4];            // each A row's (qy + cy, qx + cx)

  __device__ DxWgBlock(const DxGeom& d_, const CUtensorMap* amap_, const CUtensorMap* bmap_,
                       const wgb::Smem<BN>& sm_, uint64_t* full_)
      : d(d_), amap(amap_), bmap(bmap_), sm(sm_), full(full_), cc(threadIdx.x & 7),
        rlo(threadIdx.x >> 3) {}

  // the copies pointed at the unit of phase z (stride > 1: one split a
  // phase) and rows row0 + [0, 128), columns col0 + [0, BN), K columns
  // [k0, k1) of that phase
  __device__ void start(int64_t r0, int c0, int64_t k0, int64_t k1, int z) {
    row0 = (int)r0;
    col0 = c0;
    k_end = (int)k1;
    const int p = d.stride > 1 ? z : 0;
    const PhaseTaps ty(p / d.stride, d.ksize, d.stride, d.pad_top),
        tx(p % d.stride, d.ksize, d.stride, d.pad_left);
    fy = ty.first;
    fx = tx.first;
    ntj = tx.count;
    const int qhqw = d.Qh * d.Qw;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = row0 + rlo + 32 * i;
      off[i] = 0;
      oy[i] = -(1 << 29);  // a row past M: outside the gradient at every tap
      ox[i] = 0;
      if (m < d.M) {
        const int n = m / qhqw, rem = m - n * qhqw, qy = rem / d.Qw;
        off[i] = (int64_t)n * d.Ho * d.Wo * d.Cout;
        oy[i] = qy + ty.shift;
        ox[i] = rem - qy * d.Qw + tx.shift;
      }
    }
    k = (int)k0 + 8 * cc;
    const int tap = ntj ? k / d.Cout : 0;  // a phase with no taps has no slices
    co = k - tap * d.Cout;
    ti = ntj ? tap / ntj : 0;
    tj = tap - ti * ntj;
  }

  __device__ void fix(int, int) const {}

  // w's tap (fy + s*a, fx + s*b)
  __device__ int wtap(int a, int b) const {
    return (fy + d.stride * a) * d.ksize + fx + d.stride * b;
  }

  __device__ void advance() {
    k += wgb::BK;
    for (co += wgb::BK; co >= d.Cout; co -= d.Cout)
      if (++tj == ntj) {
        tj = 0;
        ++ti;
      }
  }

  __device__ void load(int slot, int) {
    uint8_t* st = sm.slot(slot);
    const uint32_t sa = rt::tc::smem_u32(st), sb = sa + wgb::Tile<BN>::A_BYTES;
    const uint32_t bar = rt::tc::smem_u32(&full[slot]);
    if constexpr (KIND == DX_MATRIX) {
      if (threadIdx.x == 0) {  // the slice's columns k .. k + 63 of g and of w's one tap
        rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::STAGE_BYTES);
        wgb::tma_2d(sa, amap, bar, k, row0);
        wgb::tma_2d(sb, bmap, bar, k, col0);
      }
    } else if constexpr (KIND != DX_SCALAR) {
      const bool kin = k < k_end;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int y = oy[i] - ti, x = ox[i] - tj;
        const bool ok = kin && (unsigned)y < (unsigned)d.Ho && (unsigned)x < (unsigned)d.Wo;
        const uint16_t* src = ok ? d.g + off[i] + ((int64_t)y * d.Wo + x) * d.Cout + co : d.g;
        wgb::cp16(sa + wgb::swz(rlo + 32 * i, cc), src, ok);
      }
      if constexpr (KIND == DX_GATHER) {
        if (threadIdx.x == 0) {
          rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::B_BYTES);
          wgb::tma_2d(sb, bmap, bar, co, wtap(ti, tj) * d.Cin + col0);
        }
      } else {
        const uint16_t* wt = d.w + ((int64_t)wtap(ti, tj) * d.Cin + col0) * d.Cout + co;
#pragma unroll
        for (int i = 0; i < BN / 32; ++i) {
          const int r = rlo + 32 * i;
          const bool ok = kin && col0 + r < d.Cin;
          wgb::cp16(sb + wgb::swz(r, cc), ok ? wt + (int64_t)r * d.Cout : d.w, ok);
        }
        if (threadIdx.x == 0) rt::wg::mbar_expect_tx(&full[slot], 0);  // no TMA: arrive
      }
    } else {
      // the chunk's 8 columns decoded once for every row: tap (te, je),
      // channel ce, or past the split's end
      int te[8], je[8], ce[8];
      bool in[8];
      int a = ti, b = tj, c = co;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        te[e] = a;
        je[e] = b;
        ce[e] = c;
        in[e] = k + e < k_end;
        if (++c == d.Cout) {
          c = 0;
          if (++b == ntj) {
            b = 0;
            ++a;
          }
        }
      }
      // every load issued before any store
      uint16_t va[4][8], vb[BN / 32][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int y = oy[i] - te[e], x = ox[i] - je[e];
          const bool ok = in[e] && (unsigned)y < (unsigned)d.Ho && (unsigned)x < (unsigned)d.Wo;
          va[i][e] = ok ? bfg::ld16(d.g + off[i] + ((int64_t)y * d.Wo + x) * d.Cout + ce[e]) : 0;
        }
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int ci = col0 + rlo + 32 * i;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vb[i][e] = in[e] && ci < d.Cin ? bfg::ld16(d.w + ((int64_t)wtap(te[e], je[e]) * d.Cin +
                                                          ci) * d.Cout + ce[e])
                                         : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(st + wgb::swz(rlo + 32 * i, cc)) = bfg::pack8(va[i]);
#pragma unroll
      for (int i = 0; i < BN / 32; ++i)
        *reinterpret_cast<uint4*>(st + wgb::Tile<BN>::A_BYTES + wgb::swz(rlo + 32 * i, cc)) =
            bfg::pack8(vb[i]);
      if (threadIdx.x == 0) rt::wg::mbar_expect_tx(&full[slot], 0);  // no TMA: arrive
    }
    advance();
  }
};

// dx (through ymap at stride 1, from the registers for DX_SCALAR, by the
// row-mapped store at stride > 1; or, with ws, split z's fp32 partials at ws
// + z * M * Cin) of the phases' GEMMs over the units of un
template <int BN, int KIND>
__global__ void __launch_bounds__(wgb::THREADS, 1)
conv2d_dx_wg_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap bmap,
                    const __grid_constant__ CUtensorMap ymap, const __grid_constant__ DxGeom d,
                    uint16_t* __restrict__ dx, float* __restrict__ ws, const wgb::Units un) {
  constexpr int S = wgb::PTile<BN>::STAGES;
  extern __shared__ __align__(1024) uint8_t dx_wg_smem[];
  __shared__ __align__(8) uint64_t full[S];
  const wgb::Smem<BN> sm = wgb::psmem_layout<BN>(dx_wg_smem);
  wgb::init_barriers<S>(full);
  auto epi = [&](const float (&acc)[wgb::Tile<BN>::NACC], int64_t row0, int col0, int z) {
    if (ws) {
      wgb::store_pairs<BN>(acc, row0, col0, d.M, d.Cin, nullptr, ws + (int64_t)z * d.M * d.Cin);
    } else if (KIND != DX_SCALAR && d.stride == 1) {
      wgb::store_tile_tma<BN>(acc, wgb::p_out<BN>(sm), &ymap, row0, col0);
    } else {
      const PhaseRow rows{d.H, d.W, d.Qh, d.Qw, d.stride, z / d.stride, z % d.stride};
      if constexpr (KIND == DX_SCALAR)
        wgb::store_pairs<BN>(acc, row0, col0, d.M, d.Cin, dx, nullptr, rows);
      else
        wgb::store_rows<BN>(acc, wgb::p_out<BN>(sm), row0, col0, d.M, d.Cin, dx, rows);
    }
  };
  DxWgBlock<BN, KIND> blk(d, &amap, &bmap, sm, full);
  wgb::persistent<BN, S, 0>(blk, sm, full, un, epi);
  wgb::store_tma_wait();
}

template <int BN, int KIND>
int dx_wg(const CUtensorMap& amap, const CUtensorMap& bmap, const CUtensorMap& ymap,
          const DxGeom& d, uint16_t* dx, float* ws, const wgb::Units& un, cudaStream_t s) {
  auto* kernel = conv2d_dx_wg_kernel<BN, KIND>;
  float* part = un.splits > 1 ? ws : nullptr;
  return wgb::launch_persistent(
      kernel, wgb::PTile<BN>::SMEM, un.count(),
      [&](unsigned blocks, int bytes) {
        kernel<<<blocks, wgb::THREADS, bytes, s>>>(amap, bmap, ymap, d, dx, part, un);
      },
      un.splits, ws, dx, (int64_t)d.M * d.Cin, s);
}

}  // namespace

// dx (N, H, W, Cin) from g (N, Ho, Wo, Cout) and w (k, k, Cin, Cout) on
// the wgmma core's persistent loop, every shape: tiles 128 x 64 where Cin <=
// 64, else 128 x 128; splits K splits at stride 1 (build.tc_split; ws:
// splits * N*H*W * Cin floats when splits > 1), one at stride > 1 (the
// phases' units, stride <= 4); dx 4-byte aligned; the loaders `route`
// (DX_*).
extern "C" int rt_conv2d_dx_nhwc_bf16(const uint16_t* g, const uint16_t* w, uint16_t* dx,
                                      int N, int H, int W, int Cin, int Cout, int k,
                                      int stride, int pad_top, int pad_left, int Ho, int Wo,
                                      float* ws, int splits, int route, void* stream) {
  if (stride < 1 || Ho < 0 || Wo < 0) return (int)cudaErrorInvalidValue;
  const int Qh = (H + stride - 1) / stride, Qw = (W + stride - 1) / stride;
  const int64_t M = (int64_t)N * Qh * Qw;
  const int phases = stride * stride;
  if (M >= INT32_MAX || (int64_t)k * k * Cout >= INT32_MAX ||
      (int64_t)k * k * Cin >= INT32_MAX || stride < 1 || phases > wgb::MAX_PHASES ||
      splits < 1 || (stride > 1 && splits != 1) || (splits > 1 && ws == nullptr) ||
      (uintptr_t)dx % 4 != 0 ||
      (M + wgb::BM - 1) / wgb::BM * ((Cin + 63) / 64) * splits * phases >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int bn = Cin <= 64 ? 64 : 128;
  wgb::Units un{(M + wgb::BM - 1) / wgb::BM, (Cin + bn - 1) / bn, splits, (int64_t)k * k * Cout,
                0};
  if (stride == 1) {
    un.chunk = bfg::k_chunk_for(un.K, splits);
  } else {  // the phases by depth, the deepest first, then in row-major order
    un.phases = phases;
    for (int p = 0; p < phases; ++p) {
      const int64_t depth = (int64_t)PhaseTaps(p / stride, k, stride, pad_top).count *
                            PhaseTaps(p % stride, k, stride, pad_left).count * Cout;
      int r = p;
      for (; r > 0 && un.pK[r - 1] < depth; --r) {
        un.pK[r] = un.pK[r - 1];
        un.phase[r] = un.phase[r - 1];
      }
      un.pK[r] = depth;
      un.phase[r] = (int8_t)p;
    }
    un.chunk = un.pK[0];
  }
  const bool aligned = bfg::aligned16(g) && bfg::aligned16(w) && bfg::aligned16(dx);
  const bool vec = Cout % 8 == 0 && Cin % 8 == 0 && aligned;
  const bool whole = splits == 1 || un.chunk % wgb::BK == 0;
  const bool ok = route == DX_SCALAR || (route == DX_COPY && vec) ||
                  (route == DX_MATRIX && vec && k == 1 && stride == 1 && pad_top == 0 &&
                   pad_left == 0 && Ho == H && Wo == W && whole) ||
                  (route == DX_GATHER && vec && (k == 1 || Cout % wgb::BK == 0) && whole);
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, bmap, ymap;
  memset(&amap, 0, sizeof(amap));
  memset(&bmap, 0, sizeof(bmap));
  memset(&ymap, 0, sizeof(ymap));
  int status = 0;
  if (route == DX_GATHER || route == DX_MATRIX)
    status = wgb::cached_matrix_map(&bmap, w, (int64_t)k * k * Cin, Cout, bn);
  if (status == 0 && route == DX_MATRIX)
    status = wgb::cached_matrix_map(&amap, g, (int64_t)N * Ho * Wo, Cout, wgb::BM);
  if (status == 0 && route != DX_SCALAR && stride == 1 && splits == 1)
    status = wgb::cached_matrix_map(&ymap, dx, M, Cin, wgb::BM);
  if (status != 0) return status;
  const DxGeom d{g, w, H, W, Ho, Wo, Cin, Cout, k, stride, pad_top, pad_left, Qh, Qw, (int)M};
  using Launch = int (*)(const CUtensorMap&, const CUtensorMap&, const CUtensorMap&,
                         const DxGeom&, uint16_t*, float*, const wgb::Units&, cudaStream_t);
  static const Launch runs[2][4] = {
      {dx_wg<64, DX_GATHER>, dx_wg<64, DX_MATRIX>, dx_wg<64, DX_SCALAR>, dx_wg<64, DX_COPY>},
      {dx_wg<128, DX_GATHER>, dx_wg<128, DX_MATRIX>, dx_wg<128, DX_SCALAR>,
       dx_wg<128, DX_COPY>}};
  return runs[bn == 128][route](amap, bmap, ymap, d, dx, ws, un, (cudaStream_t)stream);
}
