// Tiled fp32 SGEMM and its two transposed forms for the backward.
//
// Replaces the Pallas kernel resnet_tpu/kernels/matmul.py::_matmul_kernel
// (public function matmul), which the JAX package uses for the FC head, and
// its custom VJP (matmul.py:94-98): da = g @ b^T and db = a^T @ g on the
// same kernel. The TPU version pads every operand to 128-multiples and walks
// K as a sequential grid axis with a VMEM accumulator; here each block loops
// over its share of K with its accumulators in registers, the ragged edges
// of M, N and K are masked instead of padded, and a transpose is a loader
// flag of the shared core (tiled_gemm.cuh), so b^T (8 MB for the FC) is
// never copied.
//
//   rt_matmul_f32     C = A @ B,   A (M, K), B (K, N) row-major;
//   rt_matmul_nt_f32  C = A @ B^T, A (M, K), B (N, K) row-major (da);
//   rt_matmul_tn_f32  C = A^T @ B, A (K, M), B (K, N) row-major (db).
//
// Bound on the H100: the FC at batch 8-32 is bound by reading its 8 MB
// weight (2.5 us at 3.35 TB/s), far from the FMA peak. With few output
// tiles (M = batch) the wrapper splits K so more blocks share that read.
// wgmma/TMA tiling is left for later PRs.

#include "tiled_gemm.cuh"

namespace {

struct RowMajorA {
  static constexpr bool kMFast = false;
  const float* __restrict__ a;
  int64_t M, K;
  int64_t row[rt::A_PER_THREAD];
  bool row_ok[rt::A_PER_THREAD];
  int64_t col;

  __device__ void set_row(int r, int64_t m) {
    row_ok[r] = m < M;
    row[r] = m * K;
  }
  __device__ void set_k(int64_t kk) { col = kk; }
  __device__ float load(int r) const { return row_ok[r] ? a[row[r] + col] : 0.f; }
  __device__ int64_t out_row(int64_t gm) const { return gm; }
};

// A(m, k) = a[k, m] for a row-major (K, M) matrix
struct TransposedA {
  static constexpr bool kMFast = true;
  const float* __restrict__ a;
  int64_t M;
  int64_t m;
  bool row_ok;

  __device__ void set_row(int64_t mm) {
    row_ok = mm < M;
    m = mm;
  }
  __device__ float load(int64_t kk) const { return row_ok ? a[kk * M + m] : 0.f; }
  __device__ int64_t out_row(int64_t gm) const { return gm; }
};

template <bool B_T>
__global__ void __launch_bounds__(rt::THREADS)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int64_t M, int N, int64_t K, int64_t k_chunk) {
  RowMajorA loader;
  loader.a = a;
  loader.M = M;
  loader.K = K;
  rt::tiled_gemm<B_T>(loader, b, B_T ? K : N, c, M, N, K, k_chunk);
}

__global__ void __launch_bounds__(rt::THREADS)
matmul_tn_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int64_t M, int N, int64_t K,
                     int64_t k_chunk) {
  TransposedA loader;
  loader.a = a;
  loader.M = M;
  rt::tiled_gemm<false>(loader, b, N, c, M, N, K, k_chunk);
}

}  // namespace

// The callers check shapes, dtype and contiguity, and allocate ws
// (splits * M * N floats) when splits > 1.

extern "C" int rt_matmul_f32(const float* a, const float* b, float* c, int64_t M,
                             int N, int K, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        matmul_f32_kernel<false><<<grid, rt::THREADS, 0, s>>>(a, b, out, M, N, K, kc);
      },
      c, ws, M, N, K, splits, s);
}

extern "C" int rt_matmul_nt_f32(const float* a, const float* b, float* c, int64_t M,
                                int N, int K, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        matmul_f32_kernel<true><<<grid, rt::THREADS, 0, s>>>(a, b, out, M, N, K, kc);
      },
      c, ws, M, N, K, splits, s);
}

extern "C" int rt_matmul_tn_f32(const float* a, const float* b, float* c, int64_t M,
                                int N, int K, float* ws, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return rt::launch_gemm(
      [&](dim3 grid, float* out, int64_t kc) {
        matmul_tn_f32_kernel<<<grid, rt::THREADS, 0, s>>>(a, b, out, M, N, K, kc);
      },
      c, ws, M, N, K, splits, s);
}
