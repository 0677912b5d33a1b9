// Split-TF32 ("3xTF32") tensor-core GEMM core with a cp.async ring, fp32
// accurate. Carries the conv GEMMs of the port: the conv forward, dW and dx
// (conv.cu) and the fused conv, K8 (fused_conv.cu); K10's three GEMMs run
// on the wgmma core, wg_gemm.cuh. The forward and K8 share one gather,
// im2col.cuh.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major (M, N). One 256-thread
// block computes a BM x BN tile of C (128 x 128, or 128 x 64 where N <= 64)
// with eight warps, each a WM x 32 sub-tile of m16n8k8 products.
//
// Replaces, for the forward, the Pallas conv kernel
// (resnet_tpu/kernels/conv.py:42); for dW, the per-tap Pallas matmul of the
// conv VJP (conv.py:172-196, _matmul_raw of resnet_tpu/kernels/matmul.py:26);
// for dx, the Pallas conv kernel on the dilated gradient (conv.py:42,
// :150-170); for K8, the fused conv kernel (fused_conv.py:45). There each
// tap's window GEMM runs on the MXU with an fp32 VMEM accumulator over a
// sequential K grid axis.
//
// Bound on the H100: operations. ResNet-50's conv GEMMs at batch 32 do 2.7
// to 59 GFLOP each over depths of 64 to 9,216 (dW: 1,568 to 401,408 pixels);
// the fp32 FMA units (67 TFLOP/s) took 14-23% of their peak through a 64x64
// shared-memory tile that spends 8 shared loads per 16 FMAs.
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
//   memory. B here is N-major for every user (dW's gradient, dx's and K8's
//   weights, (K, N) row-major), and dW's A is M-major too. The fragments
//   read the staged tiles directly. wg_gemm.cuh is the wgmma design, on
//   K-major, pre-split w_hi and w_lo in device memory (K10 only so far);
//   dW would need a staging transpose.
// * Two A layouts, chosen by the loader at compile time (kKMajor):
//   - M-fast (dW: neighbouring rows of one K column are neighbouring
//     channels): the slice is stored [BK][BM + 8];
//   - K-major (the forward, dx, K8: an im2col whose K is the gathered
//     channels): the slice is stored [BM][BK + 4].
//   Both strides (8 and 36 floats, 8 and 4 mod 32) put the 32 lanes of one
//   fragment load on 32 banks: lane (gid, tig) reads A(gid, tig) at bank
//   8 tig + gid, or 4 gid + tig. B's slice is [BK][BN + 8].
// * Staging: a ring of STAGES (3) slices of BK (32) columns of K in dynamic
//   shared memory, filled by cp.async (16-byte copies where the loader
//   and B allow it, 4-byte otherwise) while the tensor cores work on the
//   oldest slice. Out-of-range rows, columns and K, and whatever the
//   loader masks (a conv tap outside the image), are zero-filled by the
//   copy's src-size operand: nothing is padded in device memory.
// * Split-K as in tiled_gemm.cuh: gridDim.z splits K into chunks of
//   k_chunk (a multiple of BK); several splits write fp32 partials to a
//   workspace that splitk_sum adds in split order. No atomics: a run
//   repeats bit for bit.
//
// The M-fast loader contract (AVEC neighbouring rows of one column per
// copy). The column's description is computed once per block and K-step by
// one thread per column into a double-buffered table in shared memory,
// each of those threads walking its column forward by BK with carries
// instead of divisions; a copying thread keeps one row group for the whole
// K loop, decoded once:
//   Cursor cursor(k)           a walker at column k (only k < K is asked)
//   void advance(Cursor&)      the same walker BK columns further
//   Col col(const Cursor&, in) what a copy needs of that column; `in` is
//                              false past the block's K range
//   Row row(m)                 this thread's row group m .. m+AVEC-1
//   const float* src(row, col, ok&)  the address of A(m, k); ok false
//                              zero-fills the copy
//
// The K-major loader contract. A copying thread owns four neighbouring
// columns of every slice and four rows 32 apart: it decodes its rows (the
// pixel) once for the whole K loop, in registers, and walks one cursor (a
// 16-byte copy of four channels of one tap, VEC = 4) or four (4-byte
// copies, where the channel count or an address is not a multiple of 4)
// forward by BK with carries, no division in the loop. Where the channel
// count is a multiple of BK, which holds at every ResNet-50 conv but the
// stem, one K-step is one tap and a cursor moves by one tap per step:
//   Row row(m)                 a copying row, decoded once
//   Cursor cursor(k)           a walker at column k (k < K)
//   void advance(Cursor&)      the same walker BK columns further
//   bool in(row, cursor)       A(m, k) is read (not masked to 0)
//   const float* at(row, cursor)  its address, where in()
//   int64_t out_row(m)         the row of C that GEMM row m is stored in
//   kPrologue, prologue, apply(v, cursor, j): a transform of the element
//                              read at column cursor + j (K8's BN affine
//                              and ReLU); cp.async cannot apply it on the
//                              way, so each thread rewrites the elements
//                              it copied once the slice has landed, before
//                              the barrier that hands the slice to the
//                              fragment reads. Masked elements stay 0: a
//                              tap outside the image is exactly 0, never
//                              act(shift).
// With kStats the K-major GEMM also writes each tile's per-column [sum C,
// sum C^2] over its BM rows to tile_sums[(blockIdx.x * 2 + {0, 1}) * N +
// col] (nullptr: none, as when the tiles hold split-K partials): summed
// over the fragment's rows in registers, over gid by __shfl_xor, over the
// warps of a column through shared memory, always in one order.
//
// Measured (-Xptxas -v, nvcc 12.9, sm_90a; conv.cu's dW kernels): 3
// stages of 32 columns; 128 x 128 tiles 176-183 registers, no spills,
// 105,472 bytes of dynamic shared memory, one block per SM; 128 x 64
// tiles capped at 128 registers (24-48 bytes of spills), 80,896 bytes, two
// blocks per SM. The K-major kernels: see conv.cu and fused_conv.cuh.
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
constexpr int PAD = 8;         // M- and N-fast rows: a stride of 8 (mod 32) floats
constexpr int LDA = BM + PAD;  // the M-fast A slice, [BK][LDA]
constexpr int KPAD = 4;        // K-major rows: a stride of 4 (mod 32) floats
constexpr int LDK = BK + KPAD; // the K-major A slice, [BM][LDK]

template <int BN, bool KMAJOR>
struct Tile {
  static_assert(BN == 64 || BN == 128, "BN");
  static constexpr int LDB = BN + PAD;
  static constexpr int WARPS_N = BN / 32;
  static constexpr int WARPS_M = WARPS / WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int MT = WM / 16;  // m16 tiles per warp
  static constexpr int NT = 4;        // n8 tiles per warp: 32 columns
  static constexpr int A_FLOATS = KMAJOR ? BM * LDK : BK * LDA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * LDB;
};

// dynamic shared memory of one block: the ring, then (M-fast) the two
// column tables
template <int BN, class ALoader>
constexpr int smem_bytes() {
  if constexpr (ALoader::kKMajor) {
    return STAGES * Tile<BN, true>::STAGE_FLOATS * 4;
  } else {
    return STAGES * Tile<BN, false>::STAGE_FLOATS * 4 +
           2 * BK * (int)sizeof(typename ALoader::Col);
  }
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

// The warp's products over one landed slice: A fragment a0..a3 = A(gid,
// tig), A(gid + 8, tig), A(gid, tig + 4), A(gid + 8, tig + 4) of each m16
// tile, B fragment b0, b1 = B(tig, gid), B(tig + 4, gid) of each n8 tile.
template <int BN, bool KMAJOR>
__device__ __forceinline__ void mma_slice(const float* as, const float* bs,
                                          float (&acc)[Tile<BN, KMAJOR>::MT][4][4], int wm0,
                                          int wn0, int gid, int tig) {
  using T = Tile<BN, KMAJOR>;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t ah[T::MT][4], al[T::MT][4], bh[T::NT][2], bl[T::NT][2];
    if constexpr (KMAJOR) {
      const float* ar = as + (wm0 + gid) * LDK + ks + tig;
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        split_tf32(ar[i * 16 * LDK], ah[i][0], al[i][0]);
        split_tf32(ar[(i * 16 + 8) * LDK], ah[i][1], al[i][1]);
        split_tf32(ar[i * 16 * LDK + 4], ah[i][2], al[i][2]);
        split_tf32(ar[(i * 16 + 8) * LDK + 4], ah[i][3], al[i][3]);
      }
    } else {
      const float* ar = as + (ks + tig) * LDA + wm0 + gid;
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        split_tf32(ar[i * 16], ah[i][0], al[i][0]);
        split_tf32(ar[i * 16 + 8], ah[i][1], al[i][1]);
        split_tf32(ar[4 * LDA + i * 16], ah[i][2], al[i][2]);
        split_tf32(ar[4 * LDA + i * 16 + 8], ah[i][3], al[i][3]);
      }
    }
    const float* br = bs + (ks + tig) * T::LDB + wn0 + gid;
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

// c0, c1 at (gid, 2 tig + {0, 1}); c2, c3 eight rows below; row m of the
// GEMM is row a.out_row(m) of C
template <int BN, bool KMAJOR, class ALoader>
__device__ __forceinline__ void store_tile(const ALoader& a,
                                           float (&acc)[Tile<BN, KMAJOR>::MT][4][4],
                                           float* __restrict__ C, int64_t M, int N, int64_t row0,
                                           int col0, int wm0, int wn0, int gid, int tig) {
  using T = Tile<BN, KMAJOR>;
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = row0 + wm0 + i * 16 + gid + h * 8;
      if (gm >= M) continue;
      float* crow = C + a.out_row(gm) * N;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
        const int gc = col0 + wn0 + j * 8 + 2 * tig;
        if (gc < N) crow[gc] = acc[i][j][2 * h];
        if (gc + 1 < N) crow[gc + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// B is row-major (K, N) with leading dimension ldb, BVEC floats per copy
// (4 needs ldb % 4 == 0, N % 4 == 0 and a 16-byte aligned B). blockIdx.x
// walks M, blockIdx.y N, blockIdx.z the K splits. A is M-fast.
template <int BN, int AVEC, int BVEC, class ALoader>
__device__ __forceinline__ void gemm(const ALoader& a, const float* __restrict__ B,
                                     int64_t ldb, float* __restrict__ C, int64_t M, int N,
                                     int64_t K, int64_t k_chunk) {
  static_assert(!ALoader::kKMajor, "gemm takes an M-fast A; gemm_k a K-major one");
  using T = Tile<BN, false>;
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
    float* bs = as + T::A_FLOATS;
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
    mma_slice<BN, false>(as, as + T::A_FLOATS, acc, wm0, wn0, gid, tig);
  }
  cp_async_wait<0>();
  store_tile<BN, false>(a, acc, C, M, N, row0, col0, wm0, wn0, gid, tig);
}

// The same GEMM with a K-major A (see the contract above); VEC floats per
// copy of A and of B (4 needs the loader's channel count, ldb and N to be
// multiples of 4 and A's and B's bases 16-byte aligned). kStats adds the
// per-tile column sums to tile_sums unless it is nullptr.
template <int BN, int VEC, bool kStats, class ALoader>
__device__ __forceinline__ void gemm_k(const ALoader& a, const float* __restrict__ B,
                                       int64_t ldb, float* __restrict__ C, int64_t M, int N,
                                       int64_t K, int64_t k_chunk,
                                       float* __restrict__ tile_sums) {
  static_assert(ALoader::kKMajor, "gemm_k takes a K-major A");
  static_assert(VEC == 4 || VEC == 1, "VEC");
  using T = Tile<BN, true>;
  using Cursor = typename ALoader::Cursor;
  extern __shared__ __align__(16) float tc_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp / T::WARPS_N;
  const int wm0 = wm * T::WM;
  const int wn0 = (warp % T::WARPS_N) * 32;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int64_t k_lo = (int64_t)blockIdx.z * k_chunk;
  const int64_t k_hi = K < k_lo + k_chunk ? K : k_lo + k_chunk;
  const int nk = k_hi > k_lo ? (int)((k_hi - k_lo + BK - 1) / BK) : 0;
  C += (int64_t)blockIdx.z * M * N;

  // copy roles: A columns a_k .. a_k + 3 of rows a_m + r * A_RSTEP; B
  // column group and first K row
  constexpr int A_TPR = BK / 4;
  constexpr int A_RSTEP = THREADS / A_TPR;
  constexpr int A_ROWS = BM / A_RSTEP;
  constexpr int NCUR = VEC == 4 ? 1 : 4;  // one cursor per copy of a row
  constexpr int B_TPR = BN / VEC;
  constexpr int B_KSTEP = THREADS / B_TPR;
  constexpr int B_COPIES = BK / B_KSTEP;
  static_assert(A_ROWS * A_RSTEP == BM && B_COPIES * B_KSTEP == BK, "copy tiling");
  const int a_k = (tid % A_TPR) * 4, a_m = tid / A_TPR;
  const int b_n = (tid % B_TPR) * VEC, b_k = tid / B_TPR;
  typename ALoader::Row rows[A_ROWS];
#pragma unroll
  for (int r = 0; r < A_ROWS; ++r) rows[r] = a.row(row0 + a_m + r * A_RSTEP);
  const bool b_col_ok = col0 + b_n < N;
  // cur: the columns of the next slice to copy; pcur: of the next slice to
  // land (the prologue's)
  Cursor cur[NCUR], pcur[NCUR];
  if (nk > 0) {
#pragma unroll
    for (int j = 0; j < NCUR; ++j) {
      const int64_t k = k_lo + a_k + j;
      cur[j] = a.cursor(k < K ? k : K - 1);  // a column past K is masked
      pcur[j] = cur[j];
    }
  }

  auto load_stage = [&](int t) {
    float* as = tc_smem + (t % STAGES) * T::STAGE_FLOATS;
    float* bs = as + T::A_FLOATS;
    const int64_t kc = k_lo + (int64_t)t * BK + a_k;
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) {
      float* dst = as + (a_m + r * A_RSTEP) * LDK + a_k;
#pragma unroll
      for (int j = 0; j < NCUR; ++j) {
        const bool ok = kc + j < k_hi && a.in(rows[r], cur[j]);
        cp_async<VEC>(dst + j, ok ? a.at(rows[r], cur[j]) : B, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < NCUR; ++j) a.advance(cur[j]);
    const int64_t k0 = k_lo + (int64_t)t * BK;
#pragma unroll
    for (int r = 0; r < B_COPIES; ++r) {
      const int kk = b_k + r * B_KSTEP;
      const bool ok = b_col_ok && k0 + kk < k_hi;
      cp_async<VEC>(bs + kk * T::LDB + b_n, ok ? B + (k0 + kk) * ldb + col0 + b_n : B, ok);
    }
  };
  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt have landed
    if constexpr (ALoader::kPrologue) {
      // the thread's own elements of slice kt, in place
      if (a.prologue) {
        float* as = tc_smem + (kt % STAGES) * T::STAGE_FLOATS;
        const int64_t kc = k_lo + (int64_t)kt * BK + a_k;
#pragma unroll
        for (int r = 0; r < A_ROWS; ++r) {
          float* p = as + (a_m + r * A_RSTEP) * LDK + a_k;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const Cursor& c = pcur[VEC == 4 ? 0 : e];
            if (kc + e < k_hi && a.in(rows[r], c)) p[e] = a.apply(p[e], c, VEC == 4 ? e : 0);
          }
        }
#pragma unroll
        for (int j = 0; j < NCUR; ++j) a.advance(pcur[j]);
      }
    }
    __syncthreads();  // ... every thread's, transformed; slot kt - 1 is free
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const float* as = tc_smem + (kt % STAGES) * T::STAGE_FLOATS;
    mma_slice<BN, true>(as, as + T::A_FLOATS, acc, wm0, wn0, gid, tig);
  }
  cp_async_wait<0>();
  store_tile<BN, true>(a, acc, C, M, N, row0, col0, wm0, wn0, gid, tig);

  if constexpr (kStats) {
    if (tile_sums == nullptr) return;  // the same for the whole block
    // this thread's columns wn0 + j * 8 + 2 * tig + e over its rows
    float s[T::NT][2], q[T::NT][2];
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[j][e] = q[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row0 + wm0 + i * 16 + gid + h * 8 >= M) continue;
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc[i][j][2 * h + e];
            s[j][e] += v;
            q[j][e] += v * v;
          }
      }
    // over the 8 gid of a tig: lanes tig, tig + 4, ... (lane = 4 gid + tig)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
          q[j][e] += __shfl_xor_sync(0xffffffffu, q[j][e], off);
        }
    __syncthreads();  // every warp is done with the ring
    float* red = tc_smem;  // [2][WARPS_M][BN]
    if (gid == 0) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn0 + j * 8 + 2 * tig + e;
          red[wm * BN + col] = s[j][e];
          red[(T::WARPS_M + wm) * BN + col] = q[j][e];
        }
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int which = tid / BN, col = tid % BN;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < T::WARPS_M; ++w) t += red[(which * T::WARPS_M + w) * BN + col];
      if (col0 + col < N) tile_sums[((int64_t)blockIdx.x * 2 + which) * N + col0 + col] = t;
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
