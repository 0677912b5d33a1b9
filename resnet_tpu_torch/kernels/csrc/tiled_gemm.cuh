// Shared-memory tiled fp32 GEMM core for the conv and matmul kernels.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major (M, N). One 256-thread
// block computes a BM x BN tile of C; each thread holds a TM x TN tile of
// accumulators in registers. Per K-step the block stages a BK-deep slice of
// A (transposed, padded against bank conflicts) and of B in shared memory.
// Ragged edges of M, N and K are masked in the loads and stores; nothing is
// padded in device memory.
//
// A is read through a loader, so one tile loop serves a plain row-major
// matrix, its transpose, and the implicit im2col views of the conv and its
// two gradients. A loader says which thread mapping suits its memory order:
//
//   kMFast = false: neighbouring threads take neighbouring k (a row-major A,
//     an NHWC activation along its channels). Each thread loads A_PER_THREAD
//     rows of one k column:
//       set_row(r, m)  row r of this thread is global row m (m may be >= M);
//       set_k(k)       the column loaded in this K-step (always < K);
//       load(r)        A(row r, k), or 0 outside the matrix.
//   kMFast = true: neighbouring threads take neighbouring m (a transposed
//     A, the dW gather along input channels). Each thread owns one row and
//     loads A_PER_THREAD k of it:
//       set_row(m)     the thread's global row (m may be >= M);
//       load(k)        A(row, k) for k < K, or 0 outside the matrix.
//
// Every loader also maps a GEMM row to the row of C it is stored in,
// out_row(m); the identity for all but the phase-split conv dx.
//
// B is row-major (K, N) with leading dimension ldb, or with B_T its
// transpose stored row-major as (N, K); the B_T load puts neighbouring
// threads on neighbouring k, so both read coalesced.
//
// Split-K: gridDim.z splits K into chunks of k_chunk (a multiple of BK).
// With one split the block writes C; with several, split z writes its fp32
// partial tile to C + z*M*N (a workspace the wrapper allocates) and
// splitk_sum adds the partials in split order. No atomics, so a run repeats
// exactly. The dW GEMMs need it: the stem at batch 32 has M = 147, N = 64
// and K = 401,408, which is 3 output tiles for 132 SMs.
//
// Column statistics (kStats, the fused conv's epilogue): after storing its
// tile, a block of a single-split GEMM also writes the per-column sum and
// sum of squares of the values it stored, over its own rows, to
// tile_sums[(blockIdx.x * 2 + {0, 1}) * N + col]. Each thread adds its TM
// rows, then one thread per column adds the BM / TM thread rows in order
// (through the A and B tiles' shared memory, free after the K loop), so a
// run repeats exactly. A null tile_sums skips it (the split-K launches,
// whose tiles hold partials).
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
constexpr int A_PER_THREAD = BM * BK / THREADS;   // A values a thread loads per K-step
constexpr int A_ROW_STEP = THREADS / BK;          // kMFast = false: rows apart
constexpr int A_K_STEP = THREADS / BM;            // kMFast = true: k apart
constexpr int B_PER_THREAD = BK * BN / THREADS;
constexpr int B_ROW_STEP = THREADS / BN;          // row-major B: k apart
constexpr int B_COL_STEP = THREADS / BK;          // B_T: n apart

static_assert(A_PER_THREAD * A_ROW_STEP == BM, "A slice tiling");
static_assert(A_PER_THREAD * A_K_STEP == BK, "A slice tiling (m-fast)");
static_assert(B_PER_THREAD * B_ROW_STEP == BK, "B slice tiling");
static_assert(B_PER_THREAD * B_COL_STEP == BN, "B slice tiling (transposed)");
static_assert(BK >= BM / TM, "column statistics stage one row per thread row");

// blockIdx.x walks M (up to 2^31 - 1 tiles), blockIdx.y walks N, blockIdx.z
// the K splits.
template <bool B_T, bool kStats = false, class ALoader>
__device__ __forceinline__ void tiled_gemm(ALoader& a, const float* __restrict__ B,
                                           int64_t ldb, float* __restrict__ C,
                                           int64_t M, int N, int64_t K,
                                           int64_t k_chunk,
                                           float* __restrict__ tile_sums = nullptr) {
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

  int a_k, a_m;
  if constexpr (ALoader::kMFast) {
    a_m = tid % BM;
    a_k = tid / BM;
    a.set_row(row0 + a_m);
  } else {
    a_k = tid % BK;
    a_m = tid / BK;
#pragma unroll
    for (int r = 0; r < A_PER_THREAD; ++r) a.set_row(r, row0 + a_m + r * A_ROW_STEP);
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_lo; k0 < k_hi; k0 += BK) {
    if constexpr (ALoader::kMFast) {
#pragma unroll
      for (int r = 0; r < A_PER_THREAD; ++r) {
        const int kk = a_k + r * A_K_STEP;
        As[kk][a_m] = (k0 + kk < k_hi) ? a.load(k0 + kk) : 0.f;
      }
    } else {
      const bool k_in = k0 + a_k < k_hi;
      a.set_k(k_in ? k0 + a_k : k_lo);
#pragma unroll
      for (int r = 0; r < A_PER_THREAD; ++r)
        As[a_k][a_m + r * A_ROW_STEP] = k_in ? a.load(r) : 0.f;
    }
    if constexpr (B_T) {
      const int b_k = tid % BK;
      const int64_t gk = k0 + b_k;
#pragma unroll
      for (int r = 0; r < B_PER_THREAD; ++r) {
        const int nn = tid / BK + r * B_COL_STEP;
        const int gn = col0 + nn;
        Bs[b_k][nn] = (gk < k_hi && gn < N) ? B[(int64_t)gn * ldb + gk] : 0.f;
      }
    } else {
      const int b_n = tid % BN;
      const int gn = col0 + b_n;
#pragma unroll
      for (int r = 0; r < B_PER_THREAD; ++r) {
        const int kk = tid / BN + r * B_ROW_STEP;
        const int64_t gk = k0 + kk;
        Bs[kk][b_n] = (gk < k_hi && gn < N) ? B[gk * ldb + gn] : 0.f;
      }
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
      if (gc < N) C[a.out_row(gm) * N + gc] = acc[i][j];
    }
  }

  if constexpr (kStats) {
    if (tile_sums == nullptr) return;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float s = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (row0 + ty * TM + i < M) {
          s += acc[i][j];
          s2 += acc[i][j] * acc[i][j];
        }
      }
      As[ty][tx * TN + j] = s;
      Bs[ty][tx * TN + j] = s2;
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int col = tid % BN;
      const int which = tid / BN;
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < BM / TM; ++r) t += which ? Bs[r][col] : As[r][col];
      if (col0 + col < N)
        tile_sums[((int64_t)blockIdx.x * 2 + which) * N + col0 + col] = t;
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
