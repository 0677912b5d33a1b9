// Residual join: out = max(a + b, 0), fp32, and its backward
// da = db = g * [a + b > 0].
//
// Replaces the Pallas kernels resnet_tpu/kernels/fused.py::_add_relu_kernel
// (public function add_relu) and ::_add_relu_mask_kernel (its custom VJP,
// fused.py:80-83). The TPU versions pad the (rows, C) view to
// (512, 128)-blocks; here the tensor is one flat range. The backward
// recomputes the gate from a + b (nothing but the inputs is saved), with the
// strict > of the reference, so a NaN sum passes no gradient.
//
// Bound on the H100: device-memory bandwidth (forward 8 bytes read and 4
// written per element, backward 12 read and 4 written, no reuse). The body
// moves 16 bytes per thread per operand as float4 when all the pointers
// are 16-byte aligned; the remainder (or the
// whole tensor, when unaligned) goes through a scalar loop. Grid-stride
// loops keep the block count bounded. The comparison is written so a NaN in
// a + b propagates, as jnp.maximum and torch.relu do. wgmma has no role in
// an elementwise pass; TMA bulk copies, and fusing the join into the expand
// conv's epilogue, are left for later PRs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_gemm.cuh"  // pack8, half_of

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

__global__ void add_relu_mask_vec4(const float4* __restrict__ a,
                                   const float4* __restrict__ b,
                                   const float4* __restrict__ g, float4* __restrict__ o,
                                   int64_t n4) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 x = a[i];
    const float4 y = b[i];
    const float4 d = g[i];
    o[i] = make_float4(x.x + y.x > 0.f ? d.x : 0.f, x.y + y.y > 0.f ? d.y : 0.f,
                       x.z + y.z > 0.f ? d.z : 0.f, x.w + y.w > 0.f ? d.w : 0.f);
  }
}

__global__ void add_relu_mask_scalar(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const float* __restrict__ g, float* __restrict__ o,
                                     int64_t begin, int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    o[i] = a[i] + b[i] > 0.f ? g[i] : 0.f;
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

// o = g * [a + b > 0], the backward of rt_add_relu_f32 for both inputs.
extern "C" int rt_add_relu_mask_f32(const float* a, const float* b, const float* g,
                                    float* o, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)g | (uintptr_t)o) % 16) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  if (n4 > 0)
    add_relu_mask_vec4<<<blocks_for(n4), THREADS, 0, s>>>(
        (const float4*)a, (const float4*)b, (const float4*)g, (float4*)o, n4);
  if (4 * n4 < n)
    add_relu_mask_scalar<<<blocks_for(n - 4 * n4), THREADS, 0, s>>>(a, b, g, o, 4 * n4,
                                                                     n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
//
// The same join on bf16 tensors, as _add_relu_kernel computes it for bf16
// inputs (fused.py:28-34): a + b in fp32, ReLU, one rounding to bf16; the
// mask passes g (bf16) where the fp32 sum is > 0. 16-byte loads of 8
// values where every pointer is 16-byte aligned; the rest one value at a
// time, so the tail never reads past n.

namespace {

__device__ __forceinline__ float bf(uint16_t v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

__device__ __forceinline__ uint16_t relu_bf(uint16_t x, uint16_t y) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(relu_sum(bf(x), bf(y))));
}

__device__ __forceinline__ uint16_t gate_bf(uint16_t x, uint16_t y, uint16_t d) {
  return bf(x) + bf(y) > 0.f ? d : (uint16_t)0;
}

__global__ void add_relu_bf16_vec8(const uint4* __restrict__ a, const uint4* __restrict__ b,
                                   uint4* __restrict__ o, int64_t n8) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint4 x = a[i], y = b[i];
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = relu_bf(bfg::half_of(x, j), bfg::half_of(y, j));
    o[i] = bfg::pack8(v);
  }
}

__global__ void add_relu_bf16_scalar(const uint16_t* __restrict__ a,
                                     const uint16_t* __restrict__ b, uint16_t* __restrict__ o,
                                     int64_t begin, int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    o[i] = relu_bf(a[i], b[i]);
}

__global__ void add_relu_mask_bf16_vec8(const uint4* __restrict__ a,
                                        const uint4* __restrict__ b,
                                        const uint4* __restrict__ g, uint4* __restrict__ o,
                                        int64_t n8) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint4 x = a[i], y = b[i], d = g[i];
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = gate_bf(bfg::half_of(x, j), bfg::half_of(y, j), bfg::half_of(d, j));
    o[i] = bfg::pack8(v);
  }
}

__global__ void add_relu_mask_bf16_scalar(const uint16_t* __restrict__ a,
                                          const uint16_t* __restrict__ b,
                                          const uint16_t* __restrict__ g,
                                          uint16_t* __restrict__ o, int64_t begin,
                                          int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    o[i] = gate_bf(a[i], b[i], g[i]);
}

}  // namespace

extern "C" int rt_add_relu_bf16(const uint16_t* a, const uint16_t* b, uint16_t* o, int64_t n,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)o) % 16) == 0;
  const int64_t n8 = aligned ? n / 8 : 0;
  if (n8 > 0)
    add_relu_bf16_vec8<<<blocks_for(n8), THREADS, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)o, n8);
  if (8 * n8 < n)
    add_relu_bf16_scalar<<<blocks_for(n - 8 * n8), THREADS, 0, s>>>(a, b, o, 8 * n8, n);
  return (int)cudaGetLastError();
}

// o = g * [a + b > 0], the backward of rt_add_relu_bf16 for both inputs.
extern "C" int rt_add_relu_mask_bf16(const uint16_t* a, const uint16_t* b, const uint16_t* g,
                                     uint16_t* o, int64_t n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned =
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)g | (uintptr_t)o) % 16) == 0;
  const int64_t n8 = aligned ? n / 8 : 0;
  if (n8 > 0)
    add_relu_mask_bf16_vec8<<<blocks_for(n8), THREADS, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (const uint4*)g, (uint4*)o, n8);
  if (8 * n8 < n)
    add_relu_mask_bf16_scalar<<<blocks_for(n - 8 * n8), THREADS, 0, s>>>(a, b, g, o, 8 * n8,
                                                                         n);
  return (int)cudaGetLastError();
}
