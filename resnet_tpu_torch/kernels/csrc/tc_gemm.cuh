// Split-TF32 ("3xTF32") tensor-core GEMM core with a cp.async ring, fp32
// accurate. Carries conv dW (conv.cu); the other GEMMs of the port are on
// tiled_gemm.cuh.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major (M, N). One 256-thread
// block computes a BM x BN tile of C (128 x 128, or 128 x 64 where N <= 64)
// with eight warps, each a WM x 32 sub-tile of m16n8k8 products.
//
// Replaces, for dW, the per-tap Pallas matmul of the conv VJP
// (resnet_tpu/kernels/conv.py:172-196, _matmul_raw of
// resnet_tpu/kernels/matmul.py:26): there each tap's (Cin, N*Ho*Wo) window
// times the (N*Ho*Wo, Cout) gradient runs on the MXU with an fp32 VMEM
// accumulator over a sequential K grid axis.
//
// Bound on the H100: operations. ResNet-50's dW GEMMs reduce over 1,568 to
// 401,408 pixels with M*N of 9K to 1.2M outputs, 2.7 to 59 GFLOP at batch
// 32; the fp32 FMA units (67 TFLOP/s) took 14-23% of their peak through a
// 64x64 shared-memory tile that spends 8 shared loads per 16 FMAs.
//
// What the design does about it:
// * Arithmetic: each operand is split once, as it is read from shared
//   memory, into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi), and the
//   tile accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first)
//   with mma.sync.m16n8k8 .tf32. The three products of each 8-deep step go
//   into a fresh fragment, which an fp32 add folds into the accumulator:
//   the tensor core rounds its fp32 sums toward zero, and fed the running
//   accumulator over a 3,000-step chunk that bias added up to 2-4e-5 of
//   max|C| on the card, where round-to-nearest adds give ~1e-6. The
//   dropped a_lo*b_lo and the 11-bit split leave an error of the order of
//   fp32 accumulation; one TF32 pass alone gives ~3e-4, which the port's
//   fp32 contract (1e-4 of max|plain|) does not admit. Three passes at 495
//   TFLOP/s leave ~2.5x the fp32 FMA peak.
// * mma.sync, not wgmma: wgmma takes tf32 operands only K-major in shared
//   memory, and both dW operands are contiguous along M and N (channels),
//   not along the pixel reduction. The fragments here read M- and N-major
//   tiles directly; rows are padded by 8 floats, so the 32 lanes of a
//   fragment load hit 32 banks.
// * Staging: a ring of STAGES (3) slices of BK (32) columns of K in dynamic
//   shared memory, filled by cp.async (16-byte copies where the loader
//   and B allow it, 4-byte otherwise) while the tensor cores work on the
//   oldest slice. Out-of-range rows, columns and K, and whatever the
//   loader masks (a conv tap outside the image), are zero-filled by the
//   copy's src-size operand: nothing is padded in device memory.
// * The A gather is a loader (the same idea as tiled_gemm.cuh): the K
//   column's description (for dW: the pixel's offset and its (iy, ix)) is
//   computed once per block per K-step by one thread per column into a
//   double-buffered table in shared memory, each of those threads walking
//   its column forward by BK with carries instead of divisions; a copying
//   thread keeps one row group for the whole K loop, decoded once.
// * Split-K as in tiled_gemm.cuh: gridDim.z splits K into chunks of
//   k_chunk (a multiple of BK); several splits write fp32 partials to a
//   workspace that splitk_sum adds in split order. No atomics: a run
//   repeats bit for bit.
//
// The loader contract (A is M-fast: neighbouring rows of one K column are
// neighbouring in memory, AVEC of them per copy):
//   Cursor cursor(k)           a walker at column k (only k < K is asked)
//   void advance(Cursor&)      the same walker BK columns further
//   Col col(const Cursor&, in) what a copy needs of that column; `in` is
//                              false past the block's K range
//   Row row(m)                 this thread's row group m .. m+AVEC-1
//   const float* src(row, col, ok&)  the address of A(m, k); ok false
//                              zero-fills the copy
// A K-fast A (the conv forward's and dx's im2col, a row-major matrix)
// needs a K-major A tile and its own fragment reads; that is a variant of
// this core for the PRs that move those GEMMs here.
//
// Measured (-Xptxas -v, nvcc 12.9, sm_90a; conv.cu's dW kernels): 3
// stages of 32 columns; 128 x 128 tiles 176-183 registers, no spills,
// 105,472 bytes of dynamic shared memory, one block per SM; 128 x 64
// tiles capped at 128 registers (24-48 bytes of spills), 80,896 bytes, two
// blocks per SM.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled_gemm.cuh"  // splitk_sum

namespace rt {
namespace tc {

constexpr int BM = 128;
constexpr int BK = 32;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;  // a row stride of 8 (mod 32) floats: conflict-free fragments
constexpr int LDA = BM + PAD;

template <int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128, "BN");
  static constexpr int LDB = BN + PAD;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = 4;        // n8 tiles per warp: 32 columns
  static constexpr int STAGE_FLOATS = BK * LDA + BK * LDB;
};

// dynamic shared memory of one block: the ring, then the two column tables
template <int BN, class ALoader>
constexpr int smem_bytes() {
  return STAGES * Tile<BN>::STAGE_FLOATS * 4 + 2 * BK * (int)sizeof(typename ALoader::Col);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one cp.async of VEC floats; ok false writes zeros and reads nothing
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    static_assert(VEC == 1, "VEC");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), each a tf32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B is row-major (K, N) with leading dimension ldb, BVEC floats per copy
// (4 needs ldb % 4 == 0, N % 4 == 0 and a 16-byte aligned B). blockIdx.x
// walks M, blockIdx.y N, blockIdx.z the K splits.
template <int BN, int AVEC, int BVEC, class ALoader>
__device__ __forceinline__ void gemm(const ALoader& a, const float* __restrict__ B,
                                     int64_t ldb, float* __restrict__ C, int64_t M, int N,
                                     int64_t K, int64_t k_chunk) {
  using T = Tile<BN>;
  using Col = typename ALoader::Col;
  extern __shared__ __align__(16) float tc_smem[];
  Col* tab = reinterpret_cast<Col*>(tc_smem + STAGES * T::STAGE_FLOATS);  // [2][BK]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm0 = (warp / T::WARPS_N) * T::WM;
  const int wn0 = (warp % T::WARPS_N) * 32;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int64_t k_lo = (int64_t)blockIdx.z * k_chunk;
  const int64_t k_hi = K < k_lo + k_chunk ? K : k_lo + k_chunk;
  const int nk = k_hi > k_lo ? (int)((k_hi - k_lo + BK - 1) / BK) : 0;
  C += (int64_t)blockIdx.z * M * N;

  // copy roles: A row group and first K row; B column group and first K row
  constexpr int A_TPR = BM / AVEC;
  constexpr int A_KSTEP = THREADS / A_TPR;
  constexpr int A_COPIES = BK / A_KSTEP;
  constexpr int B_TPR = BN / BVEC;
  constexpr int B_KSTEP = THREADS / B_TPR;
  constexpr int B_COPIES = BK / B_KSTEP;
  static_assert(A_COPIES * A_KSTEP == BK && B_COPIES * B_KSTEP == BK, "copy tiling");
  const int a_m = (tid % A_TPR) * AVEC, a_k = tid / A_TPR;
  const int b_n = (tid % B_TPR) * BVEC, b_k = tid / B_TPR;
  const typename ALoader::Row arow = a.row(row0 + a_m);
  const bool b_col_ok = col0 + b_n < N;
  typename ALoader::Cursor cur{};
  if (tid < BK) cur = a.cursor(k_lo + tid < K ? k_lo + tid : 0);

  // the columns of K-step t into table t & 1 (one thread per column)
  auto write_tab = [&](int t) {
    if (tid < BK) {
      tab[(t & 1) * BK + tid] = a.col(cur, k_lo + (int64_t)t * BK + tid < k_hi);
      a.advance(cur);
    }
  };
  auto load_stage = [&](int t) {
    float* as = tc_smem + (t % STAGES) * T::STAGE_FLOATS;
    float* bs = as + BK * LDA;
    const Col* cols = tab + (t & 1) * BK;
#pragma unroll
    for (int r = 0; r < A_COPIES; ++r) {
      const int kk = a_k + r * A_KSTEP;
      bool ok;
      const float* src = a.src(arow, cols[kk], ok);
      cp_async<AVEC>(as + kk * LDA + a_m, src, ok);
    }
    const int64_t k0 = k_lo + (int64_t)t * BK;
#pragma unroll
    for (int r = 0; r < B_COPIES; ++r) {
      const int kk = b_k + r * B_KSTEP;
      const bool ok = b_col_ok && k0 + kk < k_hi;
      cp_async<BVEC>(bs + kk * T::LDB + b_n, ok ? B + (k0 + kk) * ldb + col0 + b_n : B, ok);
    }
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // prologue: STAGES - 1 slices in flight; a sync between a table's write
  // and its readers, and between its readers and its next write
  write_tab(0);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_stage(s);
      write_tab(s + 1);
    }
    cp_async_commit();
    __syncthreads();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();              // ... for every thread; slot kt - 1 is free
    const int t = kt + STAGES - 1;
    if (t < nk) {
      load_stage(t);
      write_tab(t + 1);
    }
    cp_async_commit();

    const float* as = tc_smem + (kt % STAGES) * T::STAGE_FLOATS;
    const float* bs = as + BK * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      uint32_t ah[T::MT][4], al[T::MT][4], bh[T::NT][2], bl[T::NT][2];
      const float* ar = as + (ks + tig) * LDA + wm0 + gid;
      const float* br = bs + (ks + tig) * T::LDB + wn0 + gid;
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        split_tf32(ar[i * 16], ah[i][0], al[i][0]);
        split_tf32(ar[i * 16 + 8], ah[i][1], al[i][1]);
        split_tf32(ar[4 * LDA + i * 16], ah[i][2], al[i][2]);
        split_tf32(ar[4 * LDA + i * 16 + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        split_tf32(br[j * 8], bh[j][0], bl[j][0]);
        split_tf32(br[4 * T::LDB + j * 8], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, al[i], bh[j]);
          mma_tf32(d, ah[i], bl[j]);
          mma_tf32(d, ah[i], bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
        }
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (gid, 2 tig + {0, 1}); c2, c3 eight rows below
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = row0 + wm0 + i * 16 + gid + h * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int gc = col0 + wn0 + j * 8 + 2 * tig;
        if (gc < N) C[gm * N + gc] = acc[i][j][2 * h];
        if (gc + 1 < N) C[gm * N + gc + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// K columns per split: ceil(K / splits) rounded up to a whole K-step
inline int64_t k_chunk_for(int64_t K, int splits) {
  const int64_t c = (K + splits - 1) / splits;
  return (c + BK - 1) / BK * BK;
}

// Launch `kernel(args..., C, k_chunk)` of tile width BN over an (M, N)
// output with `splits` K splits, as rt::launch_gemm does: into `out` for
// one split, else into `ws` (splits * M * N floats) and splitk_sum. The
// kernel's dynamic shared memory limit is raised at every call (a host-side
// attribute, no device work), so any device the caller is on takes it.
template <int BN, class ALoader, class Kernel, class Launch>
inline int launch(Kernel* kernel, Launch&& kern, float* out, float* ws, int64_t M, int N,
                  int64_t K, int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN, ALoader>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  kern(grid, smem, splits == 1 ? out : ws, k_chunk_for(K, splits));
  if (splits > 1) {
    const int64_t mn = M * N;
    int64_t blocks = (mn + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    splitk_sum<<<(unsigned)blocks, 256, 0, stream>>>(ws, out, mn, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace rt
