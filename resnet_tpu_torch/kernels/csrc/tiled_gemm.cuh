// Shared-memory tiled fp32 GEMM core for the conv and matmul kernels.
//
// C[m, n] = sum_k A(m, k) * B[k, n], with B row-major (K, N) and C row-major
// (M, N). A is read through a loader, so the same tile loop serves a plain
// row-major matrix (matmul.cu) and the implicit im2col view of an NHWC
// activation (conv.cu). One 256-thread block computes a BM x BN tile of C;
// each thread holds a TM x TN tile of accumulators in registers. Per K-step
// the block stages a BK-deep slice of A (transposed, padded against bank
// conflicts) and of B in shared memory. Ragged edges of M, N and K are
// masked in the loads and stores; nothing is padded in device memory.
//
// Plain FMA units, fp32 throughout: wgmma/TMA tiling and tensor-core paths
// are work for later PRs.
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
constexpr int A_PER_THREAD = BM * BK / THREADS;   // rows of the A slice a thread loads
constexpr int A_ROW_STEP = THREADS / BK;
constexpr int B_PER_THREAD = BK * BN / THREADS;
constexpr int B_ROW_STEP = THREADS / BN;

static_assert(A_PER_THREAD * A_ROW_STEP == BM, "A slice tiling");
static_assert(B_PER_THREAD * B_ROW_STEP == BK, "B slice tiling");

// The loader holds, for each of this thread's A_PER_THREAD rows, whatever it
// needs to read A(row, k):
//   set_row(r, m)  row r of this thread is global row m (m may be >= M);
//   set_k(k)       the column this thread loads in the current K-step;
//   load(r)        A(row r, k), or 0 outside the matrix.
// blockIdx.x walks M (up to 2^31 - 1 tiles), blockIdx.y walks N.
template <class ALoader>
__device__ __forceinline__ void tiled_gemm(ALoader& a, const float* __restrict__ B,
                                           float* __restrict__ C, int64_t M, int N,
                                           int K) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  const int a_k = tid % BK;
  const int a_m = tid / BK;
#pragma unroll
  for (int r = 0; r < A_PER_THREAD; ++r) a.set_row(r, row0 + a_m + r * A_ROW_STEP);

  // neighbouring threads take neighbouring columns of B: coalesced reads
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const int gn = col0 + b_n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    a.set_k(k0 + a_k);
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) As[a_k][a_m + r * A_ROW_STEP] = a.load(r);
#pragma unroll
    for (int r = 0; r < B_PER_THREAD; ++r) {
      const int kk = b_k + r * B_ROW_STEP;
      const int gk = k0 + kk;
      Bs[kk][b_n] = (gk < K && gn < N) ? B[(int64_t)gk * N + gn] : 0.f;
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

// Grid for an (M, N) output; the caller checks the N-tile count fits gridDim.y.
inline dim3 gemm_grid(int64_t M, int N) {
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
}

}  // namespace rt
