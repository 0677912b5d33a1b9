// Per-channel batch-norm statistics of an (M, C) row-major view in one read:
// mean = sum(x) / M and the biased var = max(sum(x^2) / M - mean^2, 0).
//
// Replaces the Pallas kernel resnet_tpu/kernels/bn.py::_stats_kernel
// (public function moments). The TPU version walks the rows as a
// sequential grid axis and carries (sum, sum of squares) in VMEM scratch
// from one step to the next; blocks on a GPU run in no order, so here the
// reduction has two passes:
//
//   moments_partial  block (CT channels) x (one chunk of `chunk` rows):
//                    CT x RT threads, neighbouring threads on neighbouring
//                    channels so each warp reads one contiguous 128-byte
//                    run of a row; each thread sums every RT-th row of the
//                    chunk in fp32, the block adds its RT lanes in shared
//                    memory and writes the chunk's (sum, sum of squares);
//   moments_final    per channel, the chunk partials summed in double in a
//                    fixed order, then the epilogue of bn.py:83-86 in fp32.
//
// The wrapper picks `chunk` so that about 8 blocks run per SM. No atomics:
// a run repeats exactly.
//
// Bound on the H100: device-memory bandwidth. The statistics read the
// activation once (4 bytes per element, 2 FLOPs each); the partials are
// C * 2 * n_chunks floats, under 1% of the read at ResNet-50's shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 32;  // channels per block
constexpr int RT = 8;   // row lanes per block in the first pass
constexpr int FL = 32;  // chunk lanes per block in the second pass

__global__ void __launch_bounds__(CT * RT)
moments_partial(const float* __restrict__ x, float* __restrict__ part, int64_t M,
                int C, int64_t chunk) {
  const int c = blockIdx.x * CT + threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = M < r0 + chunk ? M : r0 + chunk;
  float s = 0.f, s2 = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int64_t r = r0 + threadIdx.y; r < r1; r += RT) {
      const float v = x[r * C + c];
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

__global__ void __launch_bounds__(CT * FL)
moments_final(const float* __restrict__ part, float* __restrict__ mean,
              float* __restrict__ var, int64_t M, int C, int n_chunks) {
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
    // bn.py:83-86 in fp32, each operation rounded on its own (no FMA)
    const float m = (float)M;
    const float mu = __fdiv_rn((float)sa, m);
    const float v = __fsub_rn(__fdiv_rn((float)sb, m), __fmul_rn(mu, mu));
    mean[c] = mu;
    var[c] = v < 0.f ? 0.f : v;  // a NaN propagates, as in jnp.maximum
  }
}

}  // namespace

// mean, var (C,) of x (M, C); part holds 2 * n_chunks * C floats, with
// n_chunks = ceil(M / chunk). The caller checks M > 0, shapes, dtype and
// contiguity.
extern "C" int rt_moments_f32(const float* x, float* part, float* mean, float* var,
                              int64_t M, int C, int64_t chunk, int n_chunks,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned ct = (unsigned)((C + CT - 1) / CT);
  moments_partial<<<dim3(ct, (unsigned)n_chunks), dim3(CT, RT), 0, s>>>(x, part, M, C,
                                                                        chunk);
  moments_final<<<ct, dim3(CT, FL), 0, s>>>(part, mean, var, M, C, n_chunks);
  return (int)cudaGetLastError();
}
