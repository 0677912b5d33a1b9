// Shared-memory tiled fp32 GEMM core of the FC forward above 32 rows
// (matmul.cu rt_matmul_f32), and the split-K sum that every GEMM of the
// port uses.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major (M, N). One 256-thread
// block computes a BM x BN tile of C; each thread holds a TM x TN tile of
// accumulators in registers. Per K-step the block stages a BK-deep slice of
// A (transposed, padded against bank conflicts) and of B in shared memory.
// Ragged edges of M, N and K are masked in the loads and stores; nothing is
// padded in device memory.
//
// A is read through a loader whose neighbouring threads take neighbouring
// k (a row-major A). Each thread loads A_PER_THREAD rows of one k column:
//   set_row(r, m)  row r of this thread is global row m (m may be >= M);
//   set_k(k)       the column loaded in this K-step (always < K);
//   load(r)        A(row r, k), or 0 outside the matrix.
// B is row-major (K, N) with leading dimension ldb.
//
// Split-K: gridDim.z splits K into chunks of k_chunk (a multiple of BK).
// With one split the block writes C; with several, split z writes its fp32
// partial tile to C + z*M*N (a workspace the wrapper allocates) and
// splitk_sum adds the partials in split order. No atomics, so a run repeats
// exactly.
//
// Plain FMA units, fp32 throughout. Every conv GEMM runs on the split-TF32
// tensor-core core, tc_gemm.cuh, the FC forward at M <= 32 and the FC
// backward on matmul.cu's streaming kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int A_PER_THREAD = BM * BK / THREADS;   // A values a thread loads per K-step
constexpr int A_ROW_STEP = THREADS / BK;          // rows apart
constexpr int B_PER_THREAD = BK * BN / THREADS;
constexpr int B_ROW_STEP = THREADS / BN;          // k apart

static_assert(A_PER_THREAD * A_ROW_STEP == BM, "A slice tiling");
static_assert(B_PER_THREAD * B_ROW_STEP == BK, "B slice tiling");

// blockIdx.x walks M (up to 2^31 - 1 tiles), blockIdx.y walks N, blockIdx.z
// the K splits.
template <class ALoader>
__device__ __forceinline__ void tiled_gemm(ALoader& a, const float* __restrict__ B,
                                           int64_t ldb, float* __restrict__ C,
                                           int64_t M, int N, int64_t K,
                                           int64_t k_chunk) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int64_t k_lo = (int64_t)blockIdx.z * k_chunk;
  const int64_t k_hi = K < k_lo + k_chunk ? K : k_lo + k_chunk;
  C += (int64_t)blockIdx.z * M * N;

  const int a_k = tid % BK;
  const int a_m = tid / BK;
#pragma unroll
  for (int r = 0; r < A_PER_THREAD; ++r) a.set_row(r, row0 + a_m + r * A_ROW_STEP);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_lo; k0 < k_hi; k0 += BK) {
    const bool k_in = k0 + a_k < k_hi;
    a.set_k(k_in ? k0 + a_k : k_lo);
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r)
      As[a_k][a_m + r * A_ROW_STEP] = k_in ? a.load(r) : 0.f;
    const int b_n = tid % BN;
    const int gn = col0 + b_n;
#pragma unroll
    for (int r = 0; r < B_PER_THREAD; ++r) {
      const int kk = tid / BN + r * B_ROW_STEP;
      const int64_t gk = k0 + kk;
      Bs[kk][b_n] = (gk < k_hi && gn < N) ? B[gk * ldb + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < N) C[gm * N + gc] = acc[i][j];
    }
  }
}

namespace {

// out[i] = sum over z of part[z * mn + i], added in split order.
__global__ void splitk_sum(const float* __restrict__ part, float* __restrict__ out,
                           int64_t mn, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[(int64_t)z * mn + i];
    out[i] = s;
  }
}

}  // namespace

// K rows per split: ceil(K / splits) rounded up to a whole K-step.
inline int64_t k_chunk_for(int64_t K, int splits) {
  const int64_t c = (K + splits - 1) / splits;
  return (c + BK - 1) / BK * BK;
}

// Launch a GEMM kernel `kern(args..., C, k_chunk)` over an (M, N) output
// with `splits` K splits: straight into `out` when splits == 1, else into
// `ws` (splits * M * N floats) followed by splitk_sum into `out`. The caller
// checks the N-tile count fits gridDim.y and splits fits gridDim.z.
template <class Launch>
inline int launch_gemm(Launch&& kern, float* out, float* ws, int64_t M, int N,
                       int64_t K, int splits, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  kern(grid, splits == 1 ? out : ws, k_chunk_for(K, splits));
  if (splits > 1) {
    const int64_t mn = M * N;
    int64_t blocks = (mn + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    splitk_sum<<<(unsigned)blocks, 256, 0, stream>>>(ws, out, mn, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace rt
