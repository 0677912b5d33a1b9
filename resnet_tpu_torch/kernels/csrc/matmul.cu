// fp32 GEMMs of the FC: a skinny-M streaming kernel for the forward at
// small batch, a tiled SGEMM above it, and the two transposed forms for
// the backward.
//
// Replaces the Pallas kernel resnet_tpu/kernels/matmul.py::_matmul_kernel
// (matmul.py:26, public function matmul), which the JAX package uses for
// the FC head, and its custom VJP (matmul.py:94-98): da = g @ b^T and
// db = a^T @ g on the same kernel. The TPU version pads every operand to
// 128-multiples and walks K as a sequential grid axis with a VMEM
// accumulator; here the ragged edges of M, N and K are masked instead of
// padded, and a transpose is a loader flag of the shared core
// (tiled_gemm.cuh), so b^T (8 MB for the FC) is never copied.
//
//   rt_matmul_skinny_f32  C = A @ B for M <= 32 (the FC at batch 1-32);
//   rt_matmul_f32         C = A @ B, A (M, K), B (K, N) row-major, above;
//   rt_matmul_nt_f32      C = A @ B^T, A (M, K), B (N, K) row-major (da);
//   rt_matmul_tn_f32      C = A^T @ B, A (K, M), B (K, N) row-major (db).
// kernels/matmul.py matmul_route picks the forward's kernel by M.
//
// Bound on the H100: the FC at batch 1-32 is bound by reading its 8.2 MB
// weight once (2.5 us at 3.35 TB/s); at M <= 32 it does at most 16 FLOP per
// byte of B, far below the FMA units' balance point. The 64x64 tiles of
// the tiled core spent 56-63 of 64 rows on masked zeros and reached 64
// blocks, so it was latency-bound at 34x that read. The skinny kernel
// spreads the read over slabs of 32 columns times K chunks of at most 256
// rows (288 blocks of 128 threads for the FC, over 2 per SM), streams each
// block's B with 16-byte cp.async copies along N through a ring of 5
// stages of 16 rows (a ring of 8 in dynamic shared memory measured the
// same), stages A's chunk for all M rows once in shared memory
// (transposed, so a thread reads 4 rows with one load), and keeps
// M rows x 4 columns of fp32 FMA accumulators per thread, M rounded up to
// 8. The 16 K-groups of a block are added in a fixed order through shared
// memory, the K chunks by splitk_sum in split order: no atomics. A ragged
// N, N % 4 != 0 and a misaligned B take 4-byte copies with zero fill.
// Measured (-Xptxas -v, nvcc 12.9, sm_90a): 56, 90, 122 and 160 registers
// for M rounded to 8, 16, 24 and 32, no spills, 22,528 to 47,104 bytes of
// static shared memory. On the H100 the FC takes 6.5-6.8 us of device time
// plus 1.6 us for splitk_sum at M = 1-8 (cuBLAS 7.4 + 1.9 us at M = 8).

#include <stdint.h>

#include "tc_gemm.cuh"  // cp_async
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

namespace skinny {
constexpr int THREADS = 128;
constexpr int COLS = 32;              // N-slab of a block
constexpr int CT = COLS / 4;          // threads across a slab, 4 columns each
constexpr int KG = THREADS / CT;      // K-groups: rows of B in flight per stage
constexpr int STAGES = 5;
constexpr int KC_MAX = 256;           // K rows of a block at most
constexpr int MAX_M = 32;
}  // namespace skinny

// One block: K rows [k_lo, k_hi) of the N-slab blockIdx.y, split
// blockIdx.x. Thread (kg, ct) holds rows 0..MP-1 x columns 4ct..4ct+3 of
// the slab over the B rows kg, kg + KG, ... of the chunk.
template <int MP>
__global__ void __launch_bounds__(skinny::THREADS)
matmul_skinny_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ c, int M, int N, int K, int k_chunk, int vec) {
  using namespace skinny;
  constexpr int LDA = MP + 4;  // 4 K-groups of a warp read 4 rows: 4 bank groups
  __shared__ __align__(16) float As[KC_MAX * LDA];        // A's chunk, As[kk][m]
  __shared__ __align__(16) float Bs[STAGES * KG * COLS];  // the ring; then the sums

  const int tid = threadIdx.x;
  const int ct = tid % CT, kg = tid / CT;
  const int split = blockIdx.x;
  const int col0 = blockIdx.y * COLS;
  const int k_lo = split * k_chunk;
  const int k_hi = K < k_lo + k_chunk ? K : k_lo + k_chunk;
  const int nk = k_hi > k_lo ? (k_hi - k_lo + KG - 1) / KG : 0;
  c += (int64_t)split * M * N;

  const int gc = col0 + 4 * ct;
  auto load_stage = [&](int t) {
    float* dst = Bs + ((t % STAGES) * KG + kg) * COLS + 4 * ct;
    const int gk = k_lo + t * KG + kg;
    const bool row_ok = gk < k_hi;
    const float* src = b + (int64_t)gk * N + gc;
    if (vec && gc + 3 < N) {
      rt::tc::cp_async<4>(dst, row_ok ? src : b, row_ok);
    } else {  // ragged or misaligned: the slab's tail, or every copy
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && gc + j < N;
        rt::tc::cp_async<1>(dst + j, ok ? src + j : b, ok);
      }
    }
  };

  // A's chunk for all MP rows (zeros past M and k_hi), transposed by
  // 4-byte copies, in the first group with B's first stage; then the rest
  // of B's first stages
  const int rows = nk * KG;
#pragma unroll 1
  for (int m = 0; m < MP; ++m) {
    for (int kk = tid; kk < rows; kk += THREADS) {
      const bool ok = m < M && k_lo + kk < k_hi;
      rt::tc::cp_async<1>(As + kk * LDA + m, ok ? a + (int64_t)m * K + k_lo + kk : a, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    rt::tc::cp_async_commit();
  }

  float acc[MP][4];
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    rt::tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt (and, the first time, A) for every thread
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    rt::tc::cp_async_commit();
    const float4 bv =
        *reinterpret_cast<const float4*>(Bs + ((kt % STAGES) * KG + kg) * COLS + 4 * ct);
    const float* ar = As + (kt * KG + kg) * LDA;
#pragma unroll
    for (int m = 0; m < MP; m += 4) {
      const float4 av = *reinterpret_cast<const float4*>(ar + m);
      const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[m + i][0] = fmaf(am[i], bv.x, acc[m + i][0]);
        acc[m + i][1] = fmaf(am[i], bv.y, acc[m + i][1]);
        acc[m + i][2] = fmaf(am[i], bv.z, acc[m + i][2]);
        acc[m + i][3] = fmaf(am[i], bv.w, acc[m + i][3]);
      }
    }
  }
  rt::tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the sums

  // the K-groups in order, 4 rows at a time: thread t then owns row t / 32
  // of the 4 and column t % 32 of the slab
  float* red = Bs;  // [KG][4][COLS]
#pragma unroll
  for (int m0 = 0; m0 < MP; m0 += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red + (kg * 4 + i) * COLS + 4 * ct) =
          make_float4(acc[m0 + i][0], acc[m0 + i][1], acc[m0 + i][2], acc[m0 + i][3]);
    __syncthreads();
    const int i = tid / COLS, col = tid % COLS;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < KG; ++g) sum += red[(g * 4 + i) * COLS + col];
    if (m0 + i < M && col0 + col < N) c[(int64_t)(m0 + i) * N + col0 + col] = sum;
    __syncthreads();
  }
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

// C = A @ B for 1 <= M <= 32: `splits` K chunks of
// ceil(K / splits) rounded up to a whole stage, at most 256 rows each
// (kernels/matmul.py plans it); with splits > 1 through ws and splitk_sum.
extern "C" int rt_matmul_skinny_f32(const float* a, const float* b, float* c, int M,
                                    int N, int K, float* ws, int splits, void* stream) {
  using namespace skinny;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t per = ((int64_t)K + splits - 1) / splits;
  const int k_chunk = (int)((per + KG - 1) / KG * KG);
  if (M < 1 || M > MAX_M || k_chunk > KC_MAX) return (int)cudaErrorInvalidValue;
  const int vec = N % 4 == 0 && (uintptr_t)b % 16 == 0;
  const dim3 grid((unsigned)splits, (unsigned)((N + COLS - 1) / COLS));
  float* out = splits == 1 ? c : ws;
  const int mp = (M + 7) / 8 * 8;
  auto* kernel = mp == 8    ? matmul_skinny_kernel<8>
                 : mp == 16 ? matmul_skinny_kernel<16>
                 : mp == 24 ? matmul_skinny_kernel<24>
                            : matmul_skinny_kernel<32>;
  kernel<<<grid, THREADS, 0, s>>>(a, b, out, M, N, K, k_chunk, vec);
  if (splits > 1) {
    const int64_t mn = (int64_t)M * N;
    rt::splitk_sum<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(ws, c, mn, splits);
  }
  return (int)cudaGetLastError();
}
