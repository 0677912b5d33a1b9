// Batch-norm apply and the BN(+ReLU) backward over an (M, C) row-major
// view, fp32 or bf16.
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
// bf16 (rt_bn_apply_bf16, rt_bn_bwd_bf16): the same bodies, one template
// over the storage type (rowwise.cuh), as the Pallas kernels take bf16:
// x and dy are read into fp32 (bn.py:135, :174-175, :192-193), the
// per-channel rows stay fp32 (the wrapper casts gamma and beta, as
// _bn_bwd_impl's rows are cast at bn.py:210), s1 and s2 are fp32 sums, and
// y and dx are rounded to bf16 once (bn.py:140, :201). 16-byte accesses
// move eight values where x, dy, y and dx are 16-byte aligned.
//
// Bound on the H100: device-memory bandwidth. K5 reads 4 and writes 4 bytes
// per element for 2 FLOPs (bf16: 2 and 2); K6 reads x and dy twice
// (reduction, then dx) and writes dx, against the 12 bytes per element
// its function must move (bf16: 6).
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

// y = act(x * scale + shift) over nv 16-byte groups of x (Vec16<T>::N values)
template <class T>
__global__ void bn_apply_vec(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ shift, T* __restrict__ y, int64_t nv,
                             int C, Act act) {
  using V = rt::Vec16<T>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(V::N * i, V::N * stride, C);
  for (; i < nv; i += stride, ch.advance()) {
    float v[V::N];
    V::load(x + V::N * i, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const int c = ch.at(j);
      v[j] = act(affine(v[j], scale[c], shift[c]));
    }
    V::store(y + V::N * i, v);
  }
}

template <class T>
__global__ void bn_apply_scalar(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ shift, T* __restrict__ y,
                                int64_t begin, int64_t end, int C, Act act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance())
    rt::st(y + i, act(affine(rt::ld(x + i), scale[ch.c], shift[ch.c])));
}

// x_hat and the gated gradient of one element
__device__ __forceinline__ float gated(float x, float dy, float mu, float iv, float g,
                                       float b, bool relu, float& xh) {
  xh = __fmul_rn(__fsub_rn(x, mu), iv);
  return (relu && !(affine(xh, g, b) > 0.f)) ? 0.f : dy;
}

template <class T>
__global__ void __launch_bounds__(CT * RT)
bn_bwd_partial(const T* __restrict__ x, const T* __restrict__ dy,
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
      const float d =
          gated(rt::ld(x + r * C + c), rt::ld(dy + r * C + c), mu, iv, g, b, relu, xh);
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

// dx of one element from its x, dy and channel c
struct BwdDx {
  const float* __restrict__ mean;
  const float* __restrict__ inv;
  const float* __restrict__ gamma;
  const float* __restrict__ beta;
  const float* __restrict__ aux;
  int C;
  bool relu;
  __device__ float operator()(float x, float dy, int c) const {
    float xh;
    const float d = gated(x, dy, mean[c], inv[c], gamma[c], beta[c], relu, xh);
    return __fmul_rn(aux[2 * C + c],
                     __fsub_rn(__fsub_rn(d, aux[3 * C + c]), __fmul_rn(xh, aux[4 * C + c])));
  }
};

template <class T>
__global__ void bn_bwd_dx_vec(const T* __restrict__ x, const T* __restrict__ dy,
                              T* __restrict__ dx, int64_t nv, int C, BwdDx f) {
  using V = rt::Vec16<T>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(V::N * i, V::N * stride, C);
  for (; i < nv; i += stride, ch.advance()) {
    float a[V::N], g[V::N];
    V::load(x + V::N * i, a);
    V::load(dy + V::N * i, g);
#pragma unroll
    for (int j = 0; j < V::N; ++j) a[j] = f(a[j], g[j], ch.at(j));
    V::store(dx + V::N * i, a);
  }
}

template <class T>
__global__ void bn_bwd_dx_scalar(const T* __restrict__ x, const T* __restrict__ dy,
                                 T* __restrict__ dx, int64_t begin, int64_t end, int C,
                                 BwdDx f) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance())
    rt::st(dx + i, f(rt::ld(x + i), rt::ld(dy + i), ch.c));
}

template <class T>
int bn_apply(const T* x, const float* scale, const float* shift, T* y, int64_t n, int C,
             Act act, cudaStream_t s) {
  constexpr int N = rt::Vec16<T>::N;
  const int64_t nv = rt::aligned16(x) && rt::aligned16(y) ? n / N : 0;
  if (nv > 0)
    bn_apply_vec<T><<<rt::ew_blocks(nv), rt::EW_THREADS, 0, s>>>(x, scale, shift, y, nv, C,
                                                                  act);
  if (N * nv < n)
    bn_apply_scalar<T><<<rt::ew_blocks(n - N * nv), rt::EW_THREADS, 0, s>>>(
        x, scale, shift, y, N * nv, n, C, act);
  return (int)cudaGetLastError();
}

template <class T>
int bn_bwd(const T* x, const T* dy, const float* mean, const float* inv, const float* gamma,
           const float* beta, float* part, float* aux, T* dx, int64_t M, int C, int64_t chunk,
           int n_chunks, bool relu, cudaStream_t s) {
  const unsigned ct = (unsigned)((C + CT - 1) / CT);
  bn_bwd_partial<T><<<dim3(ct, (unsigned)n_chunks), dim3(CT, RT), 0, s>>>(
      x, dy, mean, inv, gamma, beta, part, M, C, chunk, relu);
  bn_bwd_final<<<ct, dim3(CT, FL), 0, s>>>(part, inv, gamma, aux, M, C, n_chunks);
  constexpr int N = rt::Vec16<T>::N;
  const int64_t n = M * C;
  const BwdDx f{mean, inv, gamma, beta, aux, C, relu};
  const int64_t nv = rt::aligned16(x) && rt::aligned16(dy) && rt::aligned16(dx) ? n / N : 0;
  if (nv > 0)
    bn_bwd_dx_vec<T><<<rt::ew_blocks(nv), rt::EW_THREADS, 0, s>>>(x, dy, dx, nv, C, f);
  if (N * nv < n)
    bn_bwd_dx_scalar<T><<<rt::ew_blocks(n - N * nv), rt::EW_THREADS, 0, s>>>(
        x, dy, dx, N * nv, n, C, f);
  return (int)cudaGetLastError();
}

}  // namespace

// y = act(x * scale + shift) over n elements of an (n / C, C) view; scale
// and shift hold C floats. The caller checks shapes, dtype and contiguity.
extern "C" int rt_bn_apply_f32(const float* x, const float* scale, const float* shift,
                               float* y, int64_t n, int C, int relu, int has_cap, float cap,
                               void* stream) {
  return bn_apply(x, scale, shift, y, n, C, Act{relu != 0, has_cap != 0, cap},
                  (cudaStream_t)stream);
}

extern "C" int rt_bn_apply_bf16(const __nv_bfloat16* x, const float* scale, const float* shift,
                                __nv_bfloat16* y, int64_t n, int C, int relu, int has_cap,
                                float cap, void* stream) {
  return bn_apply(x, scale, shift, y, n, C, Act{relu != 0, has_cap != 0, cap},
                  (cudaStream_t)stream);
}

// dx (M, C) and aux (5, C) (rows: dbeta, dgamma, then scratch) of
// batch_norm_act from x, dy (M, C) and the per-channel mean, inv_std, gamma
// and beta (fp32 rows); part holds 2 * n_chunks * C floats, n_chunks =
// ceil(M / chunk). The caller checks M > 0, shapes, dtype and contiguity.
extern "C" int rt_bn_bwd_f32(const float* x, const float* dy, const float* mean,
                             const float* inv, const float* gamma, const float* beta,
                             float* part, float* aux, float* dx, int64_t M, int C,
                             int64_t chunk, int n_chunks, int relu, void* stream) {
  return bn_bwd(x, dy, mean, inv, gamma, beta, part, aux, dx, M, C, chunk, n_chunks,
                relu != 0, (cudaStream_t)stream);
}

extern "C" int rt_bn_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                              const float* mean, const float* inv, const float* gamma,
                              const float* beta, float* part, float* aux, __nv_bfloat16* dx,
                              int64_t M, int C, int64_t chunk, int n_chunks, int relu,
                              void* stream) {
  return bn_bwd(x, dy, mean, inv, gamma, beta, part, aux, dx, M, C, chunk, n_chunks,
                relu != 0, (cudaStream_t)stream);
}
