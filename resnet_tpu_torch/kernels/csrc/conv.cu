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

#include "im2col.cuh"
#include "tc_gemm.cuh"

namespace {

// taps i in [0, k) that reach input rows of phase p: i = first + s*t
struct PhaseTaps {
  int first, count, shift;  // shift: (p + k/2 - first) / s
  __host__ __device__ PhaseTaps(int p, int k, int s) {
    first = (p + k / 2) % s;
    count = first < k ? (k - 1 - first) / s + 1 : 0;
    shift = (p + k / 2 - first) / s;
  }
};

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

// dW A for tc_gemm.cuh: A((i, j, ci), p) = x[n, s*oy + i - k/2,
// s*ox + j - k/2, ci] for the pixel p = (n, oy, ox); neighbouring rows are
// neighbouring channels of one tap
struct ConvDwTcA {
  static constexpr bool kKMajor = false;
  const float* __restrict__ x;
  int H, W, Cin, k, stride, Ho, Wo;
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
    r.di = tap / k - k / 2;
    r.dj = tap % k - k / 2;
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

// the forward: im2col.cuh's gather, no prologue, windows centred (k/2, k/2)
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
                                             int64_t k_chunk) {
  ConvDwTcA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.stride = stride;
  a.Ho = H / stride;
  a.Wo = W / stride;
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
                      int k, int stride, int64_t k_chunk) {
  conv2d_dw_tc<64, AVEC, BVEC>(x, g, dw, N, H, W, Cin, Cout, k, stride, k_chunk);
}

template <int AVEC, int BVEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
conv2d_dw_tc128_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ dw, int N, int H, int W, int Cin, int Cout,
                       int k, int stride, int64_t k_chunk) {
  conv2d_dw_tc<128, AVEC, BVEC>(x, g, dw, N, H, W, Cin, Cout, k, stride, k_chunk);
}

template <int BN, int VEC>
__device__ __forceinline__ void conv2d_dx_tc(const float* __restrict__ g,
                                             const float* __restrict__ wp,
                                             float* __restrict__ dx, int N, int H, int W,
                                             int Cin, int Cout, int k, int stride, int py,
                                             int px, int64_t k_chunk) {
  const PhaseTaps ty(py, k, stride), tx(px, k, stride);
  ConvDxTcA a;
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
  rt::tc::gemm_k<BN, VEC, false>(a, wp, Cin, dx, a.M, Cin,
                                 (int64_t)ty.count * tx.count * Cout, k_chunk, nullptr);
}

// as the dW kernels: the 128 x 64 tile capped at 128 registers, two blocks
// per SM; the 128 x 128 tile one block
template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS, 2)
conv2d_dx_tc64_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                      float* __restrict__ dx, int N, int H, int W, int Cin, int Cout, int k,
                      int stride, int py, int px, int64_t k_chunk) {
  conv2d_dx_tc<64, VEC>(g, wp, dx, N, H, W, Cin, Cout, k, stride, py, px, k_chunk);
}

template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
conv2d_dx_tc128_kernel(const float* __restrict__ g, const float* __restrict__ wp,
                       float* __restrict__ dx, int N, int H, int W, int Cin, int Cout, int k,
                       int stride, int py, int px, int64_t k_chunk) {
  conv2d_dx_tc<128, VEC>(g, wp, dx, N, H, W, Cin, Cout, k, stride, py, px, k_chunk);
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

// one phase's GEMM, rows (N, H/s, W/s) of that phase, K = its taps * Cout
template <int BN, int VEC>
int launch_dx(const float* g, const float* b, float* dx, int N, int H, int W, int Cin,
              int Cout, int k, int stride, int py, int px, int64_t K, float* ws, int splits,
              cudaStream_t s) {
  auto* kernel = conv2d_dx_tc128_kernel<VEC>;
  if constexpr (BN == 64) kernel = conv2d_dx_tc64_kernel<VEC>;
  return rt::tc::launch<BN, ConvDxTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(g, b, out, N, H, W, Cin, Cout, k, stride,
                                                   py, px, kc);
      },
      dx, ws, (int64_t)N * (H / stride) * (W / stride), Cin, K, splits, s);
}

template <int BN, int AVEC, int BVEC>
int launch_dw(const float* x, const float* g, float* dw, int N, int H, int W, int Cin,
              int Cout, int k, int stride, float* ws, int splits, cudaStream_t s) {
  auto* kernel = conv2d_dw_tc128_kernel<AVEC, BVEC>;
  if constexpr (BN == 64) kernel = conv2d_dw_tc64_kernel<AVEC, BVEC>;
  return rt::tc::launch<BN, ConvDwTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(x, g, out, N, H, W, Cin, Cout, k,
                                                   stride, kc);
      },
      dw, ws, (int64_t)k * k * Cin, Cout, (int64_t)N * (H / stride) * (W / stride),
      splits, s);
}

template <int BN>
int launch_dw_vec(bool avec, bool bvec, const float* x, const float* g, float* dw,
                  int N, int H, int W, int Cin, int Cout, int k, int stride, float* ws,
                  int splits, cudaStream_t s) {
  if (avec && bvec)
    return launch_dw<BN, 4, 4>(x, g, dw, N, H, W, Cin, Cout, k, stride, ws, splits, s);
  if (avec)
    return launch_dw<BN, 4, 1>(x, g, dw, N, H, W, Cin, Cout, k, stride, ws, splits, s);
  if (bvec)
    return launch_dw<BN, 1, 4>(x, g, dw, N, H, W, Cin, Cout, k, stride, ws, splits, s);
  return launch_dw<BN, 1, 1>(x, g, dw, N, H, W, Cin, Cout, k, stride, ws, splits, s);
}

}  // namespace

// The callers check stride | H, stride | W, shapes, dtype and contiguity,
// and allocate ws (splits * rows * cols floats) when splits > 1.

// y (N, H/s, W/s, Cout) = conv(x (N, H, W, Cin), w (k, k, Cin, Cout)), K
// split `splits` ways through ws: tiles 128 x 64 where Cout <= 64, else
// 128 x 128 (build.py tc_tile_n); 16-byte copies where Cin and Cout are
// multiples of 4 and x and w 16-byte aligned.
extern "C" int rt_conv2d_nhwc_f32(const float* x, const float* w, float* y, int N,
                                  int H, int W, int Cin, int Cout, int k, int stride,
                                  float* ws, int splits, void* stream) {
  const ConvFwdTcA a =
      im2col<false>(x, N, H, W, Cin, k, stride, k / 2, k / 2, H / stride, W / stride);
  const bool vec =
      Cin % 4 == 0 && Cout % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)w % 16 == 0;
  auto* launch = Cout <= 64 ? (vec ? launch_fwd<64, 4> : launch_fwd<64, 1>)
                            : (vec ? launch_fwd<128, 4> : launch_fwd<128, 1>);
  return launch(a, w, y, Cout, ws, splits, (cudaStream_t)stream);
}

// dx (N, H, W, Cin) from g (N, H/s, W/s, Cout) and wp, the phases' slices of
// w^T = w.permute(0, 1, 3, 2) one after the other, phase (py, px) in
// row-major order, each (taps_y * taps_x * Cout, Cin) (PhaseTaps). With
// splits > 1 (stride 1 only: one phase) the K split goes through ws. Tiles
// 128 x 64 where Cin <= 64, else 128 x 128 (build.py tc_tile_n); 16-byte
// copies where Cout and Cin are multiples of 4 and g and wp 16-byte aligned.
extern "C" int rt_conv2d_dx_nhwc_f32(const float* g, const float* wp, float* dx,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stride > 1 && splits != 1) return (int)cudaErrorInvalidValue;
  const bool vec = Cout % 4 == 0 && Cin % 4 == 0 && (uintptr_t)g % 16 == 0 &&
                   (uintptr_t)wp % 16 == 0;
  auto* phase = Cin <= 64 ? (vec ? launch_dx<64, 4> : launch_dx<64, 1>)
                          : (vec ? launch_dx<128, 4> : launch_dx<128, 1>);
  const float* b = wp;
  for (int py = 0; py < stride; ++py) {
    for (int px = 0; px < stride; ++px) {
      const int64_t K = (int64_t)PhaseTaps(py, k, stride).count *
                        PhaseTaps(px, k, stride).count * Cout;
      const int status = phase(g, b, dx, N, H, W, Cin, Cout, k, stride, py, px, K, ws,
                               splits, s);
      if (status != 0) return status;
      b += K * Cin;
    }
  }
  return 0;
}

// dw (k, k, Cin, Cout) from x (N, H, W, Cin) and g (N, H/s, W/s, Cout):
// 128 x 64 tiles where Cout <= 64, else 128 x 128 (build.py tc_tile_n
// plans the splits from the same rule); 16-byte copies of x where
// Cin % 4 == 0 and x is 16-byte aligned, of g likewise.
extern "C" int rt_conv2d_dw_nhwc_f32(const float* x, const float* g, float* dw,
                                     int N, int H, int W, int Cin, int Cout, int k,
                                     int stride, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool avec = Cin % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool bvec = Cout % 4 == 0 && (uintptr_t)g % 16 == 0;
  if (Cout <= 64)
    return launch_dw_vec<64>(avec, bvec, x, g, dw, N, H, W, Cin, Cout, k, stride, ws,
                             splits, s);
  return launch_dw_vec<128>(avec, bvec, x, g, dw, N, H, W, Cin, Cout, k, stride, ws,
                            splits, s);
}
