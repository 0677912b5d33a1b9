// Batch-norm apply and the BN(+ReLU) backward over an (M, C) row-major
// view, fp32.
//
// Replaces two Pallas kernel families of resnet_tpu/kernels/bn.py:
//
//   K5 ::_apply_kernel (called by _apply; public through
//      kernels/fused.py::bias_act and bn.py::batch_norm_act):
//        y = clip(relu(x * scale[c] + shift[c]))   (relu and cap optional)
//      rt_bn_apply_f32: one elementwise pass. The TPU version pads the view
//      to (512, 128)-blocks; here it is one flat range whose element i has
//      channel i mod C (rowwise.cuh). float4 loads and stores when x and y
//      are 16-byte aligned, a scalar loop for the remainder (or the whole
//      range when they are not).
//
//   K6 ::_bwd_reduce_kernel and ::_bwd_dx_kernel (bn.py::_bn_bwd_impl, the
//      backward of batch_norm_act): with x_hat = (x - mean) * inv_std and
//      dy_g = dy gated by the recomputed ReLU (x_hat * gamma + beta > 0),
//        s1 = sum over rows of dy_g, s2 = sum of dy_g * x_hat,
//        dx = gamma * inv_std * (dy_g - s1 / M - x_hat * s2 / M),
//        dgamma = s2, dbeta = s1.
//      rt_bn_bwd_f32: the TPU reduction carries (s1, s2) in VMEM along a
//      sequential grid; blocks on a GPU run in no order, so it is two
//      passes shaped like csrc/moments.cu (per row chunk partials, then a
//      per-channel sum in double in a fixed order, which also forms the
//      three per-channel coefficients of dx), then an elementwise dx pass.
//      No atomics: a run repeats exactly.
//
// Each product and sum the plain PyTorch versions round on their own is
// rounded on its own here too (__fmul_rn, __fadd_rn: no contraction into an
// FMA), so the elementwise results match them bit for bit.
//
// Bound on the H100: device-memory bandwidth. K5 reads 4 and writes 4 bytes
// per element for 2 FLOPs; K6 reads x and dy twice (reduction, then dx) and
// writes dx, against the 12 bytes per element its function must move.
// wgmma has no role here; fusing the dx pass into the reduction's second
// read (a grid-wide sync) is later work.

#include "rowwise.cuh"

namespace {

using rt::Act;
using rt::ChannelWalk;

constexpr int CT = 32;  // channels per block of the reduction
constexpr int RT = 8;   // row lanes per block in the first pass
constexpr int FL = 32;  // chunk lanes per block in the second pass

__device__ __forceinline__ float affine(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}

__global__ void bn_apply_vec4(const float4* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ shift, float4* __restrict__ y,
                              int64_t n4, int C, Act act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(4 * i, 4 * stride, C);
  for (; i < n4; i += stride, ch.advance()) {
    const float4 v = x[i];
    const int c0 = ch.at(0), c1 = ch.at(1), c2 = ch.at(2), c3 = ch.at(3);
    y[i] = make_float4(act(affine(v.x, scale[c0], shift[c0])),
                       act(affine(v.y, scale[c1], shift[c1])),
                       act(affine(v.z, scale[c2], shift[c2])),
                       act(affine(v.w, scale[c3], shift[c3])));
  }
}

__global__ void bn_apply_scalar(const float* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ shift, float* __restrict__ y,
                                int64_t begin, int64_t end, int C, Act act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance())
    y[i] = act(affine(x[i], scale[ch.c], shift[ch.c]));
}

// x_hat and the gated gradient of one element
__device__ __forceinline__ float gated(float x, float dy, float mu, float iv, float g,
                                       float b, bool relu, float& xh) {
  xh = __fmul_rn(__fsub_rn(x, mu), iv);
  return (relu && !(affine(xh, g, b) > 0.f)) ? 0.f : dy;
}

__global__ void __launch_bounds__(CT * RT)
bn_bwd_partial(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ mean, const float* __restrict__ inv,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               float* __restrict__ part, int64_t M, int C, int64_t chunk, bool relu) {
  const int c = blockIdx.x * CT + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = M < r0 + chunk ? M : r0 + chunk;
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float mu = mean[c], iv = inv[c], g = gamma[c], b = beta[c];
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += RT) {
      float xh;
      const float d = gated(x[r * C + c], dy[r * C + c], mu, iv, g, b, relu, xh);
      s1 += d;
      s2 += d * xh;
    }
  }
  __shared__ float sh[2][RT][CT];
  sh[0][threadIdx.y][threadIdx.x] = s1;
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

// aux rows: 0 s1 (dbeta), 1 s2 (dgamma), then the coefficients of dx:
// 2 gamma * inv_std, 3 s1 / M, 4 s2 / M
__global__ void __launch_bounds__(CT * FL)
bn_bwd_final(const float* __restrict__ part, const float* __restrict__ inv,
             const float* __restrict__ gamma, float* __restrict__ aux, int64_t M, int C,
             int n_chunks) {
  const int c = blockIdx.x * CT + threadIdx.x;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int k = threadIdx.y; k < n_chunks; k += FL) {
      a += part[(2 * (int64_t)k) * C + c];
      b += part[(2 * (int64_t)k + 1) * C + c];
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
    const float s1 = (float)sa, s2 = (float)sb, m = (float)M;
    aux[c] = s1;
    aux[C + c] = s2;
    aux[2 * C + c] = __fmul_rn(gamma[c], inv[c]);
    aux[3 * C + c] = __fdiv_rn(s1, m);
    aux[4 * C + c] = __fdiv_rn(s2, m);
  }
}

__global__ void bn_bwd_dx(const float* __restrict__ x, const float* __restrict__ dy,
                          const float* __restrict__ mean, const float* __restrict__ inv,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ aux, float* __restrict__ dx, int64_t n,
                          int C, bool relu) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < n; i += stride, ch.advance()) {
    const int c = ch.c;
    float xh;
    const float d = gated(x[i], dy[i], mean[c], inv[c], gamma[c], beta[c], relu, xh);
    dx[i] = __fmul_rn(aux[2 * C + c],
                      __fsub_rn(__fsub_rn(d, aux[3 * C + c]), __fmul_rn(xh, aux[4 * C + c])));
  }
}

}  // namespace

// y = act(x * scale + shift) over n elements of an (n / C, C) view; scale
// and shift hold C floats. The caller checks shapes, dtype and contiguity.
extern "C" int rt_bn_apply_f32(const float* x, const float* scale, const float* shift,
                               float* y, int64_t n, int C, int relu, int has_cap, float cap,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Act act{relu != 0, has_cap != 0, cap};
  const bool aligned = (((uintptr_t)x | (uintptr_t)y) % 16) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    bn_apply_vec4<<<rt::ew_blocks(n4), rt::EW_THREADS, 0, s>>>(
        (const float4*)x, scale, shift, (float4*)y, n4, C, act);
  if (4 * n4 < n)
    bn_apply_scalar<<<rt::ew_blocks(n - 4 * n4), rt::EW_THREADS, 0, s>>>(
        x, scale, shift, y, 4 * n4, n, C, act);
  return (int)cudaGetLastError();
}

// dx (M, C) and aux (5, C) (rows: dbeta, dgamma, then scratch) of
// batch_norm_act from x, dy (M, C) and the per-channel mean, inv_std, gamma
// and beta; part holds 2 * n_chunks * C floats, n_chunks = ceil(M / chunk).
// The caller checks M > 0, shapes, dtype and contiguity.
extern "C" int rt_bn_bwd_f32(const float* x, const float* dy, const float* mean,
                             const float* inv, const float* gamma, const float* beta,
                             float* part, float* aux, float* dx, int64_t M, int C,
                             int64_t chunk, int n_chunks, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ct = (unsigned)((C + CT - 1) / CT);
  bn_bwd_partial<<<dim3(ct, (unsigned)n_chunks), dim3(CT, RT), 0, s>>>(
      x, dy, mean, inv, gamma, beta, part, M, C, chunk, relu != 0);
  bn_bwd_final<<<ct, dim3(CT, FL), 0, s>>>(part, inv, gamma, aux, M, C, n_chunks);
  const int64_t n = M * C;
  bn_bwd_dx<<<rt::ew_blocks(n), rt::EW_THREADS, 0, s>>>(x, dy, mean, inv, gamma, beta, aux,
                                                         dx, n, C, relu != 0);
  return (int)cudaGetLastError();
}
