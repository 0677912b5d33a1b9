// Guarded Adam over every parameter tensor in one launch, in place.
//
// Replaces the Pallas kernel resnet_tpu/kernels/adam.py::_adam_kernel
// (public function fused_adam_flat), whose caller ravels all parameters,
// gradients and moments into flat vectors and unravels the result. Here a
// small device table of (p, g, m, v, numel, first block) rows, one per
// tensor, takes the place of the raveled copies: block b finds its tensor by
// binary search over the first-block column and updates CHUNK elements of
// it. p, m and v are updated IN PLACE, which saves three copies of the model
// (and the ravel and unravel passes) per step.
//
// The arithmetic is adam.py:38-53, in fp32, with the hyper row
// h = [lr, wd, b1, b2, eps, b1^t, b2^t, guard] read from device memory (the
// learning rate and the decay products are device scalars, so no host sync):
//   g' = g + wd*p; m' = b1*m + (1-b1)*g'; v' = b2*v + (1-b2)*g'^2
//   m', v' keep m, v where g is non-finite            (guard > 0)
//   p' = p - (lr * (m'/(1-b1^t)) / (sqrt(v'/(1-b2^t)) + eps) + wd*p)
//   p' keeps p where p' is non-finite                 (guard > 0)
//
// Bound on the H100: device-memory bandwidth, 16 bytes read and 12 written
// per parameter (about 8 FLOPs and one sqrt each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t CHUNK = 4096;  // elements per block
constexpr int COLS = 6;          // p, g, m, v, numel, first block

__global__ void __launch_bounds__(THREADS)
adam_multi_tensor(const int64_t* __restrict__ table, int n_tensors,
                  const float* __restrict__ h) {
  __shared__ int t_sh;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * COLS + 5] <= (int64_t)blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    t_sh = lo;
  }
  __syncthreads();
  const int64_t* row = table + t_sh * COLS;
  float* p = (float*)row[0];
  const float* g = (const float*)row[1];
  float* m = (float*)row[2];
  float* v = (float*)row[3];
  const int64_t numel = row[4];
  const int64_t begin = ((int64_t)blockIdx.x - row[5]) * CHUNK;
  const int64_t end = numel < begin + CHUNK ? numel : begin + CHUNK;

  const float lr = h[0], wd = h[1], b1 = h[2], b2 = h[3], eps = h[4];
  const float cmd = h[5], cvd = h[6];
  const bool guard = h[7] > 0.f;
  for (int64_t i = begin + threadIdx.x; i < end; i += THREADS) {
    const float pv = p[i], gv = g[i], mv = m[i], vv = v[i];
    const float g_wd = gv + wd * pv;
    float nm = b1 * mv + (1.f - b1) * g_wd;
    float nv = b2 * vv + (1.f - b2) * g_wd * g_wd;
    if (guard && !isfinite(gv)) {
      nm = mv;
      nv = vv;
    }
    const float m_adj = nm / (1.f - cmd);
    const float v_adj = nv / (1.f - cvd);
    float np = pv - (lr * m_adj / (sqrtf(v_adj) + eps) + wd * pv);
    if (guard && !isfinite(np)) np = pv;
    p[i] = np;
    m[i] = nm;
    v[i] = nv;
  }
}

}  // namespace

// table: n_tensors rows of COLS int64 on the device, first-block column
// ascending from 0, every numel > 0; n_blocks = sum of ceil(numel / CHUNK).
// h: 8 floats on the device.
extern "C" int rt_adam_f32(const int64_t* table, int n_tensors, int n_blocks,
                           const float* h, void* stream) {
  adam_multi_tensor<<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, n_tensors, h);
  return (int)cudaGetLastError();
}
