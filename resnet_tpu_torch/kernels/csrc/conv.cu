// Direct NHWC convolution with HWIO weights, fp32 in, out and accumulator.
//
// Replaces the Pallas kernel resnet_tpu/kernels/conv.py::_conv_kernel (its
// public function conv2d_pallas): a k*k sum of tap GEMMs
// (Ho*Wo, Cin) @ (Cin, Cout) with the reference's centered windows.
//
// Geometry (resnet_tpu/ops/padding.py::reference_padding): Ho = H / s,
// iy = s*oy - k/2 + i, ix = s*ox - k/2 + j, and taps that fall outside the
// image are skipped (read as 0). No padded copy of x is made, and Cout is not
// tiled to 256 and zero-padded as on the TPU: ragged tiles are masked.
//
// As a GEMM: M = N*Ho*Wo output pixels, K = k*k*Cin, Ncols = Cout. The HWIO
// weight is already the row-major (K, Cout) B matrix, read with neighbouring
// threads on neighbouring co. The A operand is x seen through im2col on the
// fly: row m = (n, oy, ox), column kk = ((i*k + j)*Cin + ci), so neighbouring
// threads read neighbouring ci of one pixel. Offsets are 64-bit.
//
// Bound on the H100: compute. ResNet-50's convs do 2*K FLOPs per output
// element with K from 147 to 4608; this kernel runs them on the fp32 FMA
// units from shared-memory tiles. wgmma/TMA tiling (and bf16/TF32 tensor
// cores) are left for later PRs.

#include "tiled_gemm.cuh"

namespace {

struct ConvA {
  const float* __restrict__ x;
  int H, W, Cin, k, K;
  int HoWo, Wo, stride;
  int64_t M;
  // per row of this thread: offset of its image, top-left tap, validity
  int64_t img[rt::A_PER_THREAD];
  int iy0[rt::A_PER_THREAD], ix0[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  // current column: tap (di, dj), channel ci
  int di, dj, ci;
  bool k_ok;

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

  __device__ void set_k(int kk) {
    k_ok = kk < K;
    const int tap = kk / Cin;
    ci = kk - tap * Cin;
    di = tap / k;
    dj = tap - di * k;
  }

  __device__ float load(int r) const {
    const int iy = iy0[r] + di;
    const int ix = ix0[r] + dj;
    if (!row_ok[r] || !k_ok || iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.f;
    return x[img[r] + ((int64_t)iy * W + ix) * Cin + ci];
  }
};

__global__ void __launch_bounds__(rt::THREADS)
conv2d_nhwc_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int N, int H, int W, int Cin,
                       int Cout, int k, int stride) {
  ConvA a;
  a.x = x;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.k = k;
  a.K = k * k * Cin;
  a.Wo = W / stride;
  a.HoWo = (H / stride) * a.Wo;
  a.stride = stride;
  a.M = (int64_t)N * a.HoWo;
  rt::tiled_gemm(a, w, y, a.M, Cout, a.K);
}

}  // namespace

// y (N, H/s, W/s, Cout) = conv(x (N, H, W, Cin), w (k, k, Cin, Cout)).
// The caller checks stride | H, stride | W, shapes, dtype and contiguity.
extern "C" int rt_conv2d_nhwc_f32(const float* x, const float* w, float* y, int N,
                                  int H, int W, int Cin, int Cout, int k,
                                  int stride, void* stream) {
  const int64_t M = (int64_t)N * (H / stride) * (W / stride);
  conv2d_nhwc_f32_kernel<<<rt::gemm_grid(M, Cout), rt::THREADS, 0,
                           (cudaStream_t)stream>>>(x, w, y, N, H, W, Cin, Cout, k,
                                                   stride);
  return (int)cudaGetLastError();
}
