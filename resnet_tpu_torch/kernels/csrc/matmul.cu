// fp32 GEMMs of the FC: a skinny-M streaming kernel for the forward at
// small batch, a tiled SGEMM above it, and one streaming kernel for the
// backward's two products.
//
// Replaces the Pallas kernel resnet_tpu/kernels/matmul.py::_matmul_kernel
// (matmul.py:26, public function matmul), which the JAX package uses for
// the FC head, and its custom VJP (matmul.py:94-98): da = g @ b^T and
// db = a^T @ g on the same kernel. The TPU version pads every operand to
// 128-multiples and walks K as a sequential grid axis with a VMEM
// accumulator; here the ragged edges of M, N and K are masked instead of
// padded, and b^T (8 MB for the FC) is never copied.
//
//   rt_matmul_skinny_f32  C = A @ B for M <= 32 (the FC at batch 1-32);
//   rt_matmul_f32         C = A @ B, A (M, K), B (K, N) row-major, above;
//   rt_matmul_bwd_f32     da = g @ b^T and db = a^T @ g, one launch.
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
//
// The backward is bound by memory too. At the training FC (a (32, 2048),
// b (2048, 1000), g (32, 1000)) da reads b's 8.2 MB once and db writes
// 8.2 MB, each for 131 MFLOP: 16 FLOP per byte, under the FMA units' 20
// (67 TFLOP/s over 3.35 TB/s), so it runs on fp32 FMA, exact in fp32, and
// the tensor cores would buy nothing. One launch holds both products (one
// host call instead of two, no split-K sum): the grid's first blocks take
// da, the rest db, all resident at once.
// * da = g @ b^T: a block owns R = 16 rows of b (columns of da) and MT = 32
//   rows of g, and streams both along the contraction N with 16-byte
//   cp.async copies through a ring of STAGES slices of NC = 32 columns.
//   Thread (mg, rg) of warp ng holds 4 x 4 accumulators, rows mg + 8i and
//   columns rg + 4j, over the 4 contraction columns 4 ng .. 4 ng + 3 of each
//   slice, read as float4 from rows padded to 36 floats (a quarter-warp's
//   float4 reads fall on distinct banks); the 8 warps' partials are added
//   in warp order through shared memory at the end. M > 32 takes more row
//   tiles of the same blocks (b read once per tile).
// * db = a^T @ g: a block owns a 64 x 128 tile of db and stages 32 rows of
//   a's 64 columns and of g's 128 columns at a time (the FC's whole
//   contraction M = 32 at once); thread (ty, tx) holds 4 rows x 8 columns
//   (two float4 of neighbouring threads' columns) and stores them with
//   16-byte writes, so the 8.2 MB write is coalesced.
// K % 4 != 0, N % 4 != 0 or a misaligned operand take 4-byte copies with
// zero fill and scalar stores. Every sum runs in one fixed order: a run
// repeats bit for bit. build.py matmul_bwd_plan plans the blocks.

#include <climits>
#include <cstring>
#include <stdint.h>

#include "bf16_gemm.cuh"
#include "tc_gemm.cuh"  // cp_async
#include "tiled_gemm.cuh"
#include "wgb_gemm.cuh"  // the bf16 forward's persistent loop

namespace {

struct RowMajorA {
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

__global__ void __launch_bounds__(rt::THREADS)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int64_t M, int N, int64_t K, int64_t k_chunk) {
  RowMajorA loader;
  loader.a = a;
  loader.M = M;
  loader.K = K;
  rt::tiled_gemm(loader, b, N, c, M, N, K, k_chunk);
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

namespace bwd {
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// da: R rows of b (columns of da) and MT rows of g (of da) a block, over the
// whole contraction N, in slices of NC columns through a ring of STAGES
constexpr int R = 16;
constexpr int MT = 32;
constexpr int NC = 32;
constexpr int STAGES = 5;
constexpr int LDN = NC + 4;  // a staged row: 4 mod 32 floats, 16-byte aligned
constexpr int DA_STAGE = (MT + R) * LDN;
// db: a TK x TN tile a block, over the whole contraction M, MC rows a step
constexpr int TK = 64;
constexpr int TN = 128;
constexpr int MC = 32;
constexpr int LDK = TK + 4;
constexpr int LDG = TN + 4;
constexpr int DB_FLOATS = MC * (LDK + LDG);
constexpr int SMEM_FLOATS = STAGES * DA_STAGE > DB_FLOATS ? STAGES * DA_STAGE : DB_FLOATS;
static_assert(MT == 8 * 4 && R == 4 * 4 && NC == 4 * WARPS, "da thread tiling");
static_assert(TK == 4 * (THREADS / 16) && TN == 2 * 4 * 16, "db thread tiling");
static_assert(WARPS * MT * R <= SMEM_FLOATS, "da's partials fit the ring");
}  // namespace bwd

// da[m0 .. m0 + MT, r0 .. r0 + R] = g[m0 .., :] @ b[r0 .., :]^T. Thread
// (mg, rg) of warp ng holds rows m0 + mg + 8i and columns r0 + rg + 4j
// (i, j < 4) over contraction columns 4 ng .. 4 ng + 3 of every slice.
template <int VEC>
__device__ __forceinline__ void da_block(const float* __restrict__ b,
                                         const float* __restrict__ g, float* __restrict__ da,
                                         int M, int K, int N, int slab, int mtile, float* sm) {
  using namespace bwd;
  const int tid = threadIdx.x, lane = tid & 31, ng = tid >> 5;
  const int mg = lane >> 2, rg = lane & 3;
  const int m0 = mtile * MT, r0 = slab * R;
  const int nslices = (N + NC - 1) / NC;

  // slice t: MT rows of g, then R rows of b, NC columns each, VEC a copy
  auto load_slice = [&](int t) {
    constexpr int PER_ROW = NC / VEC;
    constexpr int COPIES = ((MT + R) * PER_ROW + THREADS - 1) / THREADS;
    float* dst = sm + (t % STAGES) * DA_STAGE;
    const int n0 = t * NC;
#pragma unroll
    for (int e = 0; e < COPIES; ++e) {
      const int i = tid + e * THREADS;
      if (i >= (MT + R) * PER_ROW) break;
      const int row = i / PER_ROW, col = (i % PER_ROW) * VEC;
      const bool is_g = row < MT;
      const int src_row = is_g ? m0 + row : r0 + row - MT;
      const float* base = is_g ? g : b;
      const bool ok = src_row < (is_g ? M : K) && n0 + col < N;
      rt::tc::cp_async<VEC>(dst + row * LDN + col,
                            ok ? base + (int64_t)src_row * N + n0 + col : base, ok);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nslices) load_slice(t);
    rt::tc::cp_async_commit();
  }
  for (int t = 0; t < nslices; ++t) {
    rt::tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice t for every thread; slot t - 1 is free
    if (t + STAGES - 1 < nslices) load_slice(t + STAGES - 1);
    rt::tc::cp_async_commit();
    const float* gs = sm + (t % STAGES) * DA_STAGE + 4 * ng;
    const float* bs = gs + MT * LDN;
    float4 gv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) gv[i] = *reinterpret_cast<const float4*>(gs + (mg + 8 * i) * LDN);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(bs + (rg + 4 * j) * LDN);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = fmaf(gv[i].x, bv[j].x, acc[i][j]);
        s = fmaf(gv[i].y, bv[j].y, s);
        s = fmaf(gv[i].z, bv[j].z, s);
        acc[i][j] = fmaf(gv[i].w, bv[j].w, s);
      }
  }
  rt::tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partials

  float* red = sm;  // [WARPS][MT][R]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(ng * MT + mg + 8 * i) * R + rg + 4 * j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < MT * R; o += THREADS) {
    const int m = o / R, r = o % R;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * MT + m) * R + r];
    if (m0 + m < M && r0 + r < K) da[(int64_t)(m0 + m) * K + r0 + r] = sum;
  }
}

// db[k0 .. k0 + TK, n0 .. n0 + TN] = a[:, k0 ..]^T @ g[:, n0 ..]. Thread
// (ty, tx) holds rows k0 + 4 ty + i (i < 4) and columns n0 + 4 tx + e and
// n0 + 64 + 4 tx + e (e < 4) over every row of a and g, in order.
template <int VEC>
__device__ __forceinline__ void db_block(const float* __restrict__ a,
                                         const float* __restrict__ g, float* __restrict__ db,
                                         int M, int K, int N, int ktile, int ntile, float* sm) {
  using namespace bwd;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = ktile * TK, n0 = ntile * TN;
  float* as = sm;             // [MC][LDK]
  float* gs = sm + MC * LDK;  // [MC][LDG]

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  constexpr int A_ROW = TK / VEC, G_ROW = TN / VEC;
  constexpr int COPIES = MC * (A_ROW + G_ROW) / THREADS;
  static_assert(COPIES * THREADS == MC * (A_ROW + G_ROW), "db copy tiling");
  for (int mc = 0; mc < M; mc += MC) {
    // MC rows of a's TK columns and of g's TN columns (zeros past M, K, N)
#pragma unroll 4
    for (int e = 0; e < COPIES; ++e) {
      const int i = tid + e * THREADS;
      const bool is_a = i < MC * A_ROW;
      const int j = is_a ? i : i - MC * A_ROW;
      const int per = is_a ? A_ROW : G_ROW;
      const int row = j / per, col = (j % per) * VEC;
      const int c = (is_a ? k0 : n0) + col, width = is_a ? K : N;
      const float* base = is_a ? a : g;
      const bool ok = mc + row < M && c < width;
      rt::tc::cp_async<VEC>((is_a ? as + row * LDK : gs + row * LDG) + col,
                            ok ? base + (int64_t)(mc + row) * width + c : base, ok);
    }
    rt::tc::cp_async_commit();
    rt::tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int m = 0; m < MC; ++m) {
      const float4 av = *reinterpret_cast<const float4*>(as + m * LDK + 4 * ty);
      const float4 g0 = *reinterpret_cast<const float4*>(gs + m * LDG + 4 * tx);
      const float4 g1 = *reinterpret_cast<const float4*>(gs + m * LDG + 64 + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gr[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], gr[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are free for the next rows
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= K) continue;
    float* row = db + (int64_t)k * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      if constexpr (VEC == 4) {
        if (c < N)
          *reinterpret_cast<float4*>(row + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < N) row[c + e] = acc[i][4 * h + e];
      }
    }
  }
}

// Blocks [0, da_blocks) compute da, the rest db (matmul_bwd_plan's order)
template <int VEC>
__global__ void __launch_bounds__(bwd::THREADS)
matmul_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ g, float* __restrict__ da, float* __restrict__ db,
                  int M, int K, int N, int da_blocks) {
  __shared__ __align__(16) float sm[bwd::SMEM_FLOATS];
  const int id = blockIdx.x;
  if (id < da_blocks) {
    const int slabs = (K + bwd::R - 1) / bwd::R;
    da_block<VEC>(b, g, da, M, K, N, id % slabs, id / slabs, sm);
  } else {
    const int ntiles = (N + bwd::TN - 1) / bwd::TN;
    const int t = id - da_blocks;
    db_block<VEC>(a, g, db, M, K, N, t / ntiles, t % ntiles, sm);
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
        matmul_f32_kernel<<<grid, rt::THREADS, 0, s>>>(a, b, out, M, N, K, kc);
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

// da = g @ b^T (M, K) and db = a^T @ g (K, N) for a (M, K), b (K, N) and
// g (M, N), in one launch of da_blocks + db_blocks blocks: da_blocks =
// ceil(K / R) * ceil(M / MT), or 0 with da null; db_blocks = ceil(K / TK) *
// ceil(N / TN), or 0 with db null (build.py matmul_bwd_plan); any other
// count is refused. 16-byte copies where K and N are multiples of 4 and
// every pointer is 16-byte aligned.
extern "C" int rt_matmul_bwd_f32(const float* a, const float* b, const float* g, float* da,
                                 float* db, int M, int K, int N, int da_blocks, int db_blocks,
                                 void* stream) {
  using namespace bwd;
  const int64_t want_da = da ? (int64_t)((K + R - 1) / R) * ((M + MT - 1) / MT) : 0;
  const int64_t want_db = db ? (int64_t)((K + TK - 1) / TK) * ((N + TN - 1) / TN) : 0;
  if (M < 0 || K < 0 || N < 0 || da_blocks != want_da || db_blocks != want_db ||
      want_da + want_db == 0 || want_da + want_db > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   ((uintptr_t)a | (uintptr_t)b | (uintptr_t)g | (uintptr_t)da |
                    (uintptr_t)db) % 16 == 0;
  auto* kernel = vec ? matmul_bwd_kernel<4> : matmul_bwd_kernel<1>;
  kernel<<<(unsigned)(da_blocks + db_blocks), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, g, da, db, M, K, N, da_blocks);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
//
// The FC in bf16: fp32 accumulator, bf16 out = result_type(a, b)
// (matmul.py:53), da and db in bf16 (matmul.py:96-97), each rounded once.
// The forward runs on wgb_gemm.cuh's persistent wgmma loop for every M,
// with the K split the caller plans (build.skinny_split for M <= 32,
// build.split_k above) in bf16_gemm.cuh's chunks, one fp32 add per k16 step
// in K order: the bits of that core's kernel, which ran it before.
// The caller names the loaders (matmul.fwd_bf16_route); the entry refuses
// one the shapes or pointers do not allow.
// * M <= 32 (the FC at batch 1-32): the operands swapped, c^T (N, M) = b^T
//   (N, K) a^T (K, M), so N fills wgmma's 64-row side and M is its n (8, 16
//   or 32): a 128-row tile is 128 of the N columns. FC_SWAP (K and N
//   multiples of 8, a and b 16-byte aligned): b read by two TMA boxes of 64
//   columns x 64 K rows a slice, MN-major with the transpose bit, as it
//   lies; a^T K-major as a lies, its M rows x 64 K columns copied 16 bytes
//   at a time with zeros past the split's end. FC_SWAP_SCALAR (a ragged N or
//   K, a misaligned operand): both by the threads' 2-byte loads into the
//   same layout. The units are (128 columns of N, split): the FC's 8 x 9 at
//   240 K columns a split.
// * otherwise: K1's bf16 forward (conv.cu) on a as an (M, 1, 1, K) image and
//   b as a 1x1 weight (1, 1, K, N), called through its C entry point so its
//   kernels compile once: b by TMA, a by 16-byte copies or TMA boxes, or,
//   for a ragged N or K or a misaligned operand, the threads' 2-byte loads.
// Split partials go through ws and splitk_sum_bf16 in split order (a
// ticket and the tile's last block adding them in the same launch was
// slower: its sum is a serial tail; PERF.md).
// Bound on the H100: bytes (b's 4.1 MB, 1.2 us at 3.35 TB/s); a
// persistent-loop call costs ~4-8 us however small (PERF.md), which the
// swap keeps near 4 for the FC. The backward is one launch of its own
// kernel below (neither b^T nor a^T is copied). Tensors are bf16, passed as
// their 16-bit patterns.

extern "C" int rt_conv2d_nhwc_bf16(const uint16_t* x, const uint16_t* w, uint16_t* y, int N,
                                   int H, int W, int Cin, int Cout, int k, int stride,
                                   int pad_top, int pad_left, int Ho, int Wo, float* ws,
                                   int splits, int route, void* stream);

namespace {

// One block's copies for matmul_fwd_wg_kernel (wgb::persistent's Block):
// thread 0 asks TMA for b's two 64-column boxes of the slice; thread t <
// 8 BN copies row t / 8 of a, its 8 K columns 8 (t % 8) on, into the
// K-major B slot
template <int BN>
struct FcWgBlock {
  const CUtensorMap* bmap;
  const uint16_t* __restrict__ a;
  int M, K;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int n0 = 0, k_lo = 0, k_end = 0;

  __device__ void start(int64_t r0, int, int64_t k0, int64_t k1, int) {
    n0 = (int)r0;
    k_lo = (int)k0;
    k_end = (int)k1;
  }
  __device__ void fix(int, int) const {}
  __device__ void load(int slot, int kt) const {
    const uint32_t sa = rt::tc::smem_u32(sm.slot(slot)), bar = rt::tc::smem_u32(&full[slot]);
    const int kk = k_lo + kt * wgb::BK, t = threadIdx.x;
    if (t < 8 * BN) {
      const int m = t / 8, k = kk + 8 * (t % 8);
      const bool ok = m < M && k < k_end;
      wgb::cp16(sa + wgb::Tile<BN>::A_BYTES + wgb::swz(m, t % 8), ok ? a + (int64_t)m * K + k : a,
                ok);
    }
    if (t == 0) {
      rt::wg::mbar_expect_tx(&full[slot], wgb::Tile<BN>::A_BYTES);
      wgb::tma_2d(sa, bmap, bar, n0, kk);
      wgb::tma_2d(sa + wgb::HALF, bmap, bar, n0 + 64, kk);
    }
  }
};

// One block's loads for matmul_fwd_wg_kernel where an operand is ragged
// or misaligned (FC_SWAP_SCALAR): the threads' 2-byte loads of both. The
// thread loads 8 columns 8 (t % 16) on of b's K rows t / 16 + 16 i, i < 4,
// of the slice (zeros past N or the split's end) into A's MN-major halves,
// and, t < 8 BN, row t / 8 of a, its 8 K columns 8 (t % 8) on, into the
// K-major B slot; each slice's loads land before it returns (keeping a
// slice's values in registers until the next slice's loads were issued
// was slower: PERF.md)
template <int BN>
struct FcScalarBlock {
  const uint16_t* __restrict__ a;
  const uint16_t* __restrict__ b;
  int M, N, K;
  const wgb::Smem<BN>& sm;
  uint64_t* full;
  int n0 = 0, k_lo = 0, k_end = 0;

  __device__ void start(int64_t r0, int, int64_t k0, int64_t k1, int) {
    n0 = (int)r0;
    k_lo = (int)k0;
    k_end = (int)k1;
  }
  __device__ void fix(int, int) const {}
  __device__ void load(int slot, int kt) const {
    uint8_t* st = sm.slot(slot);
    const int kk = k_lo + kt * wgb::BK, t = threadIdx.x, c = t % 16, n = n0 + 8 * c;
    uint16_t va[4][8], vb[8];  // every load issued before any store
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kk + t / 16 + 16 * i;
      const uint16_t* q = b + (int64_t)k * N + n;
#pragma unroll
      for (int e = 0; e < 8; ++e) va[i][e] = k < k_end && n + e < N ? bfg::ld16(q + e) : 0;
    }
    if (t < 8 * BN) {
      const int m = t / 8, k = kk + 8 * (t % 8);
      const uint16_t* q = a + (int64_t)m * K + k;
#pragma unroll
      for (int e = 0; e < 8; ++e) vb[e] = m < M && k + e < k_end ? bfg::ld16(q + e) : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(st + (c / 8) * wgb::HALF + wgb::swz(t / 16 + 16 * i, c % 8)) =
          bfg::pack8(va[i]);
    if (t < 8 * BN)
      *reinterpret_cast<uint4*>(st + wgb::Tile<BN>::A_BYTES + wgb::swz(t / 8, t % 8)) =
          bfg::pack8(vb);
    if (t == 0) rt::wg::mbar_expect_tx(&full[slot], 0);  // no TMA: arrive
  }
};

// c (M, N) bf16, or with ws split z's fp32 partials at ws + z * M * N, of
// c^T = b^T a^T over the units of un (128 columns of N each, the splits of
// K), b by TMA through bmap (TMA) or both operands by the threads' 2-byte
// loads: the thread's sums of columns n and rows m of c, d[4j + e] at n =
// n0 + 16 warp + gid + 8 (e / 2), m = 8j + 2 tig + e % 2
template <int BN, bool TMA>
__global__ void __launch_bounds__(wgb::THREADS, 1)
matmul_fwd_wg_kernel(const __grid_constant__ CUtensorMap bmap, const uint16_t* __restrict__ a,
                     const uint16_t* __restrict__ b, uint16_t* __restrict__ c,
                     float* __restrict__ ws, int M, int N, int K, const wgb::Units un) {
  constexpr int S = wgb::PTile<BN>::STAGES;
  extern __shared__ __align__(1024) uint8_t fc_wg_smem[];
  __shared__ __align__(8) uint64_t full[S];
  const wgb::Smem<BN> sm = wgb::psmem_layout<BN>(fc_wg_smem);
  wgb::init_barriers<S>(full);
  const int warp = threadIdx.x >> 5, gid = (threadIdx.x & 31) >> 2, tig = threadIdx.x & 3;
  auto epi = [&](const float (&acc)[wgb::Tile<BN>::NACC], int64_t n0, int, int z) {
    float* part = ws ? ws + (int64_t)z * M * N : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = (int)n0 + warp * 16 + gid + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + 2 * tig + e;
          if (m >= M) continue;
          const float v = acc[4 * j + 2 * h + e];
          if (part)
            part[(int64_t)m * N + n] = v;
          else
            c[(int64_t)m * N + n] = bfg::to_bf16(v);
        }
    }
  };
  if constexpr (TMA) {
    FcWgBlock<BN> blk{&bmap, a, M, K, sm, full};
    wgb::persistent<BN, S, 0, wgb::A_MN>(blk, sm, full, un, epi);
  } else {
    FcScalarBlock<BN> blk{a, b, M, N, K, sm, full};
    wgb::persistent<BN, S, 0, wgb::A_MN>(blk, sm, full, un, epi);
  }
}

template <int BN, bool TMA>
int fc_wg(const CUtensorMap& bmap, const uint16_t* a, const uint16_t* b, uint16_t* c, float* ws,
          int M, int N, int K, const wgb::Units& un, cudaStream_t s) {
  auto* kernel = matmul_fwd_wg_kernel<BN, TMA>;
  float* part = un.splits > 1 ? ws : nullptr;
  return wgb::launch_persistent(
      kernel, wgb::PTile<BN>::SMEM, un.count(),
      [&](unsigned blocks, int bytes) {
        kernel<<<blocks, wgb::THREADS, bytes, s>>>(bmap, a, b, c, part, M, N, K, un);
      },
      un.splits, ws, c, (int64_t)M * N, s);
}

// rt_matmul_bf16's routes past conv.cu's FWD_* (an (M, 1, 1, K) conv)
constexpr int FC_SWAP = 4, FC_SWAP_SCALAR = 5;

}  // namespace

// c (M, N) = a (M, K) @ b (K, N), every M; ws: splits * M * N floats when
// splits > 1; the loaders `route`: FC_SWAP (M <= 32, K and N multiples of
// 8, a and b 16-byte aligned), FC_SWAP_SCALAR (M <= 32), or conv.cu's
// FWD_* for an (M, 1, 1, K) conv, which that entry checks
extern "C" int rt_matmul_bf16(const uint16_t* a, const uint16_t* b, uint16_t* c, int64_t M,
                              int N, int K, float* ws, int splits, int route, void* stream) {
  if (M < 0 || M >= INT32_MAX || splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (route < FC_SWAP)
    return rt_conv2d_nhwc_bf16(a, b, c, (int)M, 1, 1, K, N, 1, 1, 0, 0, 1, 1, ws, splits, route,
                               stream);
  const bool ok = M <= 32 && (route == FC_SWAP_SCALAR ||
                   (route == FC_SWAP && K % 8 == 0 && N % 8 == 0 && bfg::aligned16(a) &&
                    bfg::aligned16(b)));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  CUtensorMap bmap;
  memset(&bmap, 0, sizeof(bmap));
  if (route == FC_SWAP) {
    const int status = wgb::cached_matrix_map(&bmap, b, K, N, wgb::BK);
    if (status != 0) return status;
  }
  const wgb::Units un{(N + wgb::BM - 1) / wgb::BM, 1, splits, K, bfg::k_chunk_for(K, splits)};
  using Launch = int (*)(const CUtensorMap&, const uint16_t*, const uint16_t*, uint16_t*, float*,
                         int, int, int, const wgb::Units&, cudaStream_t);
  static const Launch runs[3][2] = {{fc_wg<8, true>, fc_wg<8, false>},
                                    {fc_wg<16, true>, fc_wg<16, false>},
                                    {fc_wg<32, true>, fc_wg<32, false>}};
  return runs[M <= 8 ? 0 : M <= 16 ? 1 : 2][route == FC_SWAP_SCALAR](
      bmap, a, b, c, ws, (int)M, N, K, un, (cudaStream_t)stream);
}

// ------------------------------------------------ the bf16 FC backward
//
// da = g @ b^T and db = a^T @ g in one launch of da_blocks + db_blocks
// blocks (build.matmul_bwd_plan_bf16), da's first, on mma.sync m16n8k16
// (bf16 in, fp32 out): every operand is read as it lies, through ldmatrix.
// * da: a block owns R = 16 columns of da (rows of b) and MT = 32 rows (of
//   g) over the whole contraction N, streamed through a cp.async ring of
//   STAGES slices of NC = 128 columns; the FC at batch 32 is 128 such
//   blocks. g's rows and b's rows are both K-major for the product (g's
//   row = A's row, b's row = B's column), so plain ldmatrix takes them.
//   Warp w computes the 16 x 8 tile w % 4 over the contraction's even (w <
//   4) or odd k16 steps; the two halves are added in that order at the end.
// * db: a block owns a TK x TN = 128 x 128 tile of db over the whole
//   contraction M, MC = 32 rows of a and g a step; both operands are
//   MN-major for the product (a's row holds db's rows, g's row its
//   columns), which ldmatrix.trans turns into the fragments. The tile is
//   rounded to bf16, staged in shared memory and written in 16-byte row
//   stores. Bound on the H100: bytes (at the FC b's 4 MB read for da and
//   db's 4 MB written, 2 MFLOP per 16 KB), so both products share the
//   card in one launch and every operand is read as it lies.
// Each k16 step's products go into a fresh fragment that an fp32 add folds
// into the sum (bf16_gemm.cuh's rule), every sum in one fixed order, no
// atomics: a call repeats bit for bit. 16-byte copies where K and N are
// multiples of 8 and a, b and g 16-byte aligned; 2-byte loads through the
// registers otherwise (the ragged case), and scalar stores where db's rows
// are no whole 16-byte chunks.
namespace {
namespace bwd16 {
constexpr int THREADS = 256;
constexpr int R = 16;
constexpr int MT = 32;
constexpr int NC = 128;
constexpr int STAGES = 3;
constexpr int LD = NC + 8;  // bf16 a staged row: consecutive rows 16 bytes apart in bank
constexpr int DA_ROWS = MT + R;
constexpr int TK = 128;
constexpr int TN = 128;
constexpr int MC = 32;
constexpr int SMEM = STAGES * DA_ROWS * LD * 2;  // da's ring; db's tiles and staged tile fit
static_assert(2 * MC * LD * 2 <= SMEM && TK * LD * 2 <= SMEM, "db's tiles fit the ring");
static_assert(TK == NC && TN == NC, "db's rows are staged at the ring's stride");
}  // namespace bwd16

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rt::tc::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(rt::tc::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(rt::tc::smem_u32(p)));
}

// acc += A (16 x 16, a) * B (16 x 8, b0 b1) through a fresh fragment
__device__ __forceinline__ void mma_fold(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], d[e]);
}

// 8 values p[0 .. 7] of a row into shared dst: one 16-byte cp.async with
// VEC, else 2-byte loads through the registers; `n` of them exist (the rest,
// and all where !ok, zeros; base: any valid address, read by nothing)
template <int VEC>
__device__ __forceinline__ void copy8(uint16_t* dst, const uint16_t* p, bool ok, int n,
                                      const uint16_t* base) {
  if constexpr (VEC == 8) {
    rt::tc::cp_async<4>(reinterpret_cast<float*>(dst),
                        reinterpret_cast<const float*>(ok ? p : base), ok);
  } else {
    uint16_t v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ok && e < n ? bfg::ld16(p + e) : 0;
    *reinterpret_cast<uint4*>(dst) = bfg::pack8(v);
  }
}

// da[m0 .., r0 .. r0 + R] = g[m0 .., :] @ b[r0 .., :]^T
template <int VEC>
__device__ __forceinline__ void da_block16(const uint16_t* __restrict__ b,
                                           const uint16_t* __restrict__ g,
                                           uint16_t* __restrict__ da, int M, int K, int N,
                                           int slab, int mtile, uint16_t* sm) {
  using namespace bwd16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = mtile * MT, r0 = slab * R;
  const int mi = (warp & 3) >> 1, ni = warp & 1, half = warp >> 2;
  const int nslices = (N + NC - 1) / NC;

  // slice t: MT rows of g, then R rows of b, NC columns each, 8 a copy
  auto load_slice = [&](int t) {
    uint16_t* dst = sm + (t % STAGES) * DA_ROWS * LD;
    const int n0 = t * NC;
    for (int i = tid; i < DA_ROWS * (NC / 8); i += THREADS) {
      const int row = i / (NC / 8), col = i % (NC / 8) * 8;
      const bool is_g = row < MT;
      const int src = is_g ? m0 + row : r0 + row - MT;
      const bool ok = src < (is_g ? M : K) && n0 + col < N;
      const uint16_t* base = is_g ? g : b;
      copy8<VEC>(dst + row * LD + col, base + (int64_t)src * N + n0 + col, ok, N - n0 - col,
                 base);
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nslices) load_slice(t);
    rt::tc::cp_async_commit();
  }
  for (int t = 0; t < nslices; ++t) {
    rt::tc::cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice t for every thread; slot t - 1 is free
    if (t + STAGES - 1 < nslices) load_slice(t + STAGES - 1);
    rt::tc::cp_async_commit();
    const uint16_t* gs = sm + (t % STAGES) * DA_ROWS * LD;
    const uint16_t* bs = gs + MT * LD;
    const int j = lane >> 3, r = lane & 7;
#pragma unroll
    for (int s = half; s < NC / 16; s += 2) {
      uint32_t af[4], bf[2];
      ldsm_x4(af, gs + (mi * 16 + r + 8 * (j & 1)) * LD + s * 16 + 8 * (j >> 1));
      ldsm_x2(bf, bs + (ni * 8 + r) * LD + s * 16 + 8 * (j & 1));
      mma_fold(acc, af, bf[0], bf[1]);
    }
  }
  rt::tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the halves' sums

  float* red = reinterpret_cast<float*>(sm);  // [4 tiles][32 lanes][4]
  if (half == 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[((warp & 3) * 32 + lane) * 4 + e] = acc[e];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + mi * 16 + gid + 8 * (e >> 1), c = r0 + ni * 8 + 2 * tig + (e & 1);
      const float v = __fadd_rn(acc[e], red[((warp & 3) * 32 + lane) * 4 + e]);
      if (m < M && c < K) da[(int64_t)m * K + c] = bfg::to_bf16(v);
    }
  }
}

// db[k0 .. k0 + TK, n0 .. n0 + TN] = a[:, k0 ..]^T @ g[:, n0 ..]. Warp w
// holds rows k0 + 64 (w % 2) + [0, 64) and columns n0 + 32 (w / 2) + [0, 32)
template <int VEC>
__device__ __forceinline__ void db_block16(const uint16_t* __restrict__ a,
                                           const uint16_t* __restrict__ g,
                                           uint16_t* __restrict__ db, int M, int K, int N,
                                           int ktile, int ntile, uint16_t* sm) {
  using namespace bwd16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k0 = ktile * TK, n0 = ntile * TN;
  const int wm = warp & 1, wn = warp >> 1;
  const int j = lane >> 3, r = lane & 7;
  uint16_t* as = sm;            // [MC][LD]: a's rows, db's rows contiguous
  uint16_t* gs = sm + MC * LD;  // [MC][LD]: g's rows, db's columns contiguous

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][q][e] = 0.f;

  for (int mc = 0; mc < M; mc += MC) {
    for (int i = tid; i < 2 * MC * (TK / 8); i += THREADS) {
      const bool is_a = i < MC * (TK / 8);
      const int q = is_a ? i : i - MC * (TK / 8);
      const int row = q / (TK / 8), col = q % (TK / 8) * 8;
      const int c = (is_a ? k0 : n0) + col, width = is_a ? K : N;
      const bool ok = mc + row < M && c < width;
      copy8<VEC>((is_a ? as : gs) + row * LD + col,
                 (is_a ? a : g) + (int64_t)(mc + row) * width + c, ok, width - c, g);
    }
    rt::tc::cp_async_commit();
    rt::tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int s = 0; s < MC / 16; ++s) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)  // A = a^T: stored rows are the contraction
        ldsm_x4_t(af[i], as + (s * 16 + r + 8 * (j >> 1)) * LD + wm * 64 + i * 16 + 8 * (j & 1));
#pragma unroll
      for (int p = 0; p < 2; ++p)  // B = g: two 8-column tiles a load
        ldsm_x4_t(bf[p], gs + (s * 16 + r + 8 * (j & 1)) * LD + wn * 32 + p * 16 + 8 * (j >> 1));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_fold(acc[i][q], af[i], bf[q >> 1][2 * (q & 1)], bf[q >> 1][2 * (q & 1) + 1]);
    }
    __syncthreads();  // the tiles are free for the next rows, or the output
  }

  // rounded to bf16, staged as [TK][LD], then whole rows out
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(sm + (wm * 64 + i * 16 + gid + 8 * h) * LD + wn * 32 +
                                     q * 8 + 2 * tig) =
            (uint32_t)bfg::to_bf16(acc[i][q][2 * h]) |
            ((uint32_t)bfg::to_bf16(acc[i][q][2 * h + 1]) << 16);
  __syncthreads();
  const bool vec = N % 8 == 0 && (uintptr_t)db % 16 == 0;
  for (int i = tid; i < TK * (TN / 8); i += THREADS) {
    const int row = i / (TN / 8), col = i % (TN / 8) * 8;
    const int k = k0 + row, c = n0 + col;
    if (k >= K || c >= N) continue;
    const uint16_t* src = sm + row * LD + col;
    uint16_t* dst = db + (int64_t)k * N + c;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c + e < N; ++e) dst[e] = src[e];
    }
  }
}

// blocks [0, da_blocks) compute da, the rest db (matmul_bwd_plan_bf16's order)
template <int VEC>
__global__ void __launch_bounds__(bwd16::THREADS)
matmul_bwd_bf16_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                       const uint16_t* __restrict__ g, uint16_t* __restrict__ da,
                       uint16_t* __restrict__ db, int M, int K, int N, int da_blocks) {
  __shared__ __align__(16) uint16_t sm[bwd16::SMEM / 2];
  const int id = blockIdx.x;
  if (id < da_blocks) {
    const int slabs = (K + bwd16::R - 1) / bwd16::R;
    da_block16<VEC>(b, g, da, M, K, N, id % slabs, id / slabs, sm);
  } else {
    const int ntiles = (N + bwd16::TN - 1) / bwd16::TN;
    const int t = id - da_blocks;
    db_block16<VEC>(a, g, db, M, K, N, t / ntiles, t % ntiles, sm);
  }
}

}  // namespace

// da (M, K) = g (M, N) @ b^T and db (K, N) = a^T @ g for a (M, K), b (K, N)
// and g (M, N), in one launch of da_blocks + db_blocks blocks: da_blocks =
// ceil(K / 16) * ceil(M / 32), or 0 with da null; db_blocks = ceil(K / 128)
// * ceil(N / 128), or 0 with db null (build.py matmul_bwd_plan_bf16); any
// other count is refused
extern "C" int rt_matmul_bwd_bf16(const uint16_t* a, const uint16_t* b, const uint16_t* g,
                                  uint16_t* da, uint16_t* db, int M, int K, int N, int da_blocks,
                                  int db_blocks, void* stream) {
  using namespace bwd16;
  const int64_t want_da = da ? (int64_t)((K + R - 1) / R) * ((M + MT - 1) / MT) : 0;
  const int64_t want_db = db ? (int64_t)((K + TK - 1) / TK) * ((N + TN - 1) / TN) : 0;
  if (M < 0 || K < 0 || N < 0 || da_blocks != want_da || db_blocks != want_db ||
      want_da + want_db == 0 || want_da + want_db > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = K % 8 == 0 && N % 8 == 0 && bfg::aligned16(a) && bfg::aligned16(b) &&
                   bfg::aligned16(g);
  auto* kernel = vec ? matmul_bwd_bf16_kernel<8> : matmul_bwd_bf16_kernel<1>;
  kernel<<<(unsigned)(da_blocks + db_blocks), THREADS, 0, (cudaStream_t)stream>>>(
      a, b, g, da, db, M, K, N, da_blocks);
  return (int)cudaGetLastError();
}
