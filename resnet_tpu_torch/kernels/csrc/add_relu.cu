// Residual join: out = max(a + b, 0), fp32.
//
// Replaces the Pallas kernel resnet_tpu/kernels/fused.py::_add_relu_kernel
// (public function add_relu). The TPU version pads the (rows, C) view to
// (512, 128)-blocks; here the tensor is one flat range.
//
// Bound on the H100: device-memory bandwidth (8 bytes read and 4 written
// per element, no reuse). The body moves 16 bytes per thread per operand as
// float4 when all three pointers are 16-byte aligned; the remainder (or the
// whole tensor, when unaligned) goes through a scalar loop. Grid-stride
// loops keep the block count bounded. The comparison is written so a NaN in
// a + b propagates, as jnp.maximum and torch.relu do. wgmma has no role in
// an elementwise pass; TMA bulk copies, and fusing the join into the expand
// conv's epilogue, are left for later PRs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float relu_sum(float x, float y) {
  const float s = x + y;
  return s < 0.f ? 0.f : s;
}

__global__ void add_relu_vec4(const float4* __restrict__ a, const float4* __restrict__ b,
                              float4* __restrict__ o, int64_t n4) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 x = a[i];
    const float4 y = b[i];
    o[i] = make_float4(relu_sum(x.x, y.x), relu_sum(x.y, y.y), relu_sum(x.z, y.z),
                       relu_sum(x.w, y.w));
  }
}

__global__ void add_relu_scalar(const float* __restrict__ a, const float* __restrict__ b,
                                float* __restrict__ o, int64_t begin, int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    o[i] = relu_sum(a[i], b[i]);
}

unsigned blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

}  // namespace

extern "C" int rt_add_relu_f32(const float* a, const float* b, float* o, int64_t n,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)o) % 16) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    add_relu_vec4<<<blocks_for(n4), THREADS, 0, s>>>(
        (const float4*)a, (const float4*)b, (float4*)o, n4);
  if (4 * n4 < n)
    add_relu_scalar<<<blocks_for(n - 4 * n4), THREADS, 0, s>>>(a, b, o, 4 * n4, n);
  return (int)cudaGetLastError();
}
