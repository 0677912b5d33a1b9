// Tiled fp32 SGEMM, row-major (M, K) @ (K, N) -> (M, N).
//
// Replaces the Pallas kernel resnet_tpu/kernels/matmul.py::_matmul_kernel
// (public function matmul), which the JAX package uses for the FC head. The
// TPU version pads every operand to 128-multiples and walks K as a
// sequential grid axis with a VMEM accumulator; here each block loops over K
// itself with its accumulators in registers, and the ragged edges of M, N
// and K are masked in the kernel instead of padded (tiled_gemm.cuh).
//
// Bound on the H100: compute for large M. The serving FC is
// (batch, 2048) @ (2048, 1000): at small batch it is bound by reading the
// 8 MB weight once per 64-row tile of M. wgmma/TMA tiling and split-K are
// left for later PRs.

#include "tiled_gemm.cuh"

namespace {

struct RowMajorA {
  const float* __restrict__ a;
  int64_t M;
  int K;
  int64_t row[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  int col;
  bool k_ok;

  __device__ void set_row(int r, int64_t m) {
    row_ok[r] = m < M;
    row[r] = m * K;
  }
  __device__ void set_k(int kk) {
    k_ok = kk < K;
    col = kk;
  }
  __device__ float load(int r) const {
    return (row_ok[r] && k_ok) ? a[row[r] + col] : 0.f;
  }
};

__global__ void __launch_bounds__(rt::THREADS)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int64_t M, int N, int K) {
  RowMajorA loader;
  loader.a = a;
  loader.M = M;
  loader.K = K;
  rt::tiled_gemm(loader, b, c, M, N, K);
}

}  // namespace

extern "C" int rt_matmul_f32(const float* a, const float* b, float* c, int64_t M,
                             int N, int K, void* stream) {
  matmul_f32_kernel<<<rt::gemm_grid(M, N), rt::THREADS, 0, (cudaStream_t)stream>>>(
      a, b, c, M, N, K);
  return (int)cudaGetLastError();
}
