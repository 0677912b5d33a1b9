// Split-TF32 ("3xTF32") GEMM core on Hopper's warpgroup MMA (wgmma), fp32
// accurate. Carries K10's three GEMMs (block_fused.cu); K8 and K1 stay on
// tc_gemm.cuh's mma.sync core.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major (M, N), A gathered K-major
// by an im2col loader (im2col.cuh's contract, with its prologue), B given as
// its pre-split transpose: bs[0][n][k] = tf32(B(k, n)) (cvt.rna) and
// bs[1][n][k] = tf32(B(k, n) - bs[0][n][k]), row stride kp >= K floats, a
// multiple of 4 (split_tf32_kmajor below writes it once per call). One
// 256-thread block computes a 128 x BN tile (BN = 64 where N <= 64, else
// 128): two warpgroups of 64 rows, each issuing
// wgmma.mma_async.m64nBNk8.f32.tf32.tf32 over the whole width.
//
// * Why pre-split and K-major: tf32 wgmma reads its shared-memory operands
//   K-major only, and K10's weights are (K, Cout) row-major. Splitting once
//   per call, in device memory, also takes the B split out of the main loop,
//   where tc_gemm.cuh pays it in every block for every K-step.
// * B: TMA loads each 32-deep slice of bs[0] and bs[1] (two boxes of BN
//   rows x 128 bytes, 128-byte swizzle) into a ring in dynamic shared
//   memory, one mbarrier per slot counting their bytes; rows past N and
//   columns past K arrive as zeros. wgmma reads them by descriptor (128-byte
//   swizzle, K-major: 8-row atoms 1024 bytes apart; a K-step of 8 floats
//   moves the start address by 32 bytes). The tensor map is built on the
//   host per call through libcuda's cuTensorMapEncodeTiled, reached through
//   the runtime's entry-point query: no -lcuda.
// * A: the loader's cp.async gather into [128][36] slices of the same ring
//   (a fragment read's 32 lanes on 32 banks, as in tc_gemm.cuh), the
//   prologue applied in place by the copying thread once the slice has
//   landed, to the elements its copies read (it records which, and with
//   16-byte copies their first channel, per slot in shared memory: one
//   (scale, shift) load per four channels and one 16-byte read and write
//   per row), halo taps left at 0. Each warp then reads its 16 x 32 slice
//   into registers and splits it there (a_hi = tf32(a), a_lo = tf32(a -
//   a_hi)): wgmma's register A operand has mma.sync's m16n8k8 fragment
//   layout, so the slice needs no swizzled copy of its own. (Both A forms
//   were measured: swizzled hi and lo tiles read by descriptor ran no
//   faster, and need 64 KB a slot against 50 KB.)
// * Products: per 32-deep slice, 12 wgmmas into a fresh accumulator d
//   (scale-d 0 on the first), small terms first: a_lo * b_hi over the four
//   8-deep steps, then a_hi * b_lo, then a_hi * b_hi. An fp32 add then folds
//   d into the running sum. The tensor core rounds its sums toward zero: an
//   accumulator chained over a whole K of thousands of steps drifts by
//   2-4e-5 of max|C| (tc_gemm.cuh); chained over one slice it is one of
//   ~K/32 round-to-nearest adds. The three products are a_lo*b_hi +
//   a_hi*b_lo + a_hi*b_hi of fp32 precision; a_lo*b_lo (2^-22 relative) is
//   dropped.
// * Ring: STAGES slots of (B hi, B lo, A); the block waits for every wgmma
//   of a slice before the barrier that frees its slot, so a TMA into a slot
//   never races the tensor core's reads of it. An mbarrier phase that never
//   completes traps instead of spinning forever.
// * Persistent blocks: at most as many as the card holds at once, each
//   taking work items (m tile, n tile, K split) in turn as one stream of
//   slices through the ring, so the next item's loads fly while an item's
//   last products and its epilogue run (the 64-wide stage-1 GEMMs, 784
//   items on 264 blocks, gained most; where items barely exceed the
//   blocks, little).
// * Split-K as in tc_gemm.cuh: K splits into chunks of k_chunk (a multiple
//   of 32); several splits write fp32 partials to a workspace that
//   splitk_sum adds in split order. No atomics: a run repeats bit for bit.
// * Statistics (kStats, one split): the tile's per-column [sum C, sum C^2]
//   over its 128 rows, summed over each thread's two rows, over gid by
//   __shfl_xor, over the eight warps through shared memory in warp order,
//   into tile_sums[(m tile * 2 + {0, 1}) * N + col].
//
// The accumulator of m64nNk8 holds, per thread, d[4j + e] at row
// 16 * (warp % 4) + gid + 8 * (e / 2), column 8j + 2 tig + e % 2.
//
// Measured (-Xptxas -v, nvcc 12.9, sm_90a; block_fused.cu's kernels): the
// 128-wide tiles 220-232 registers, no spills, 218,112 bytes of dynamic
// shared memory (4 stages), one block per SM; the 64-wide ones capped at
// 128 registers (two blocks per SM, 112-368 bytes of spill stores), 112,640
// bytes (3 stages). Where the time goes: PERF.md.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"  // cp_async, split_tf32, k_chunk_for, splitk_sum

namespace rt {
namespace wg {

constexpr int BM = 128;
constexpr int BK = tc::BK;  // 32 floats: one 128-byte swizzle row
constexpr int THREADS = 256;
constexpr int LDK = tc::LDK;  // A slice [BM][LDK]

template <int BN>
struct Tile {
  static_assert(BN == 64 || BN == 128, "BN");
  static constexpr int STAGES = BN == 64 ? 3 : 4;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;  // resident per SM
  static constexpr int NACC = BN / 2;                   // accumulator floats per thread
  static constexpr int B_BYTES = BN * BK * 4;           // one plane of one slice
  static constexpr int A_BYTES = BM * LDK * 4;
  static constexpr int STAGE_BYTES = 2 * B_BYTES + A_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled B tiles stay 1024-byte aligned");
  // the ring, the statistics' reduction [2][warps][BN] and the copies'
  // record [STAGES][THREADS], + alignment slack
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + 2 * (THREADS / 32) * BN * 4 + STAGES * THREADS * 4 + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits for phase `parity` of bar to complete; a phase that has not after
// 2^26 tries (seconds, where a slice takes microseconds) is a fault: trap
// rather than spin forever
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = tc::smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one box of the 3-D tensor map at (c0, c1, c2) into dst, reported to bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(tc::smem_u32(dst)),
      "l"((uint64_t)map), "r"(tc::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// descriptor of a K-major tile with 128-byte swizzle at shared address
// saddr (1024-byte aligned): 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// keeps the compiler from moving accesses to r across the wgmma fences
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

template <int BN>
struct Mma;

template <>
struct Mma<64> {
  __device__ static __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  __device__ static __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// The GEMM with the K-major loader a (im2col.cuh's contract) and the
// pre-split B behind bmap (a 3-D map of bs: dims {K, N, 2}, box {BK, BN,
// 1}); VEC floats per copy of A (4 needs the loader's channel count to be a
// multiple of 4 and its base, and with a prologue its scale and shift,
// 16-byte aligned). The block is persistent: it takes the work items
// (m tile, n tile, K split), m fastest, blockIdx.x, blockIdx.x + gridDim.x,
// ..., as one stream of 32-deep slices through the ring, so the next
// item's loads are in flight while an item's last products and its
// epilogue run. An item of one split writes C, with kStats its column sums
// to tile_sums unless that is nullptr; with several splits, split z writes
// its partials to ws + z * M * N.
template <int BN, int VEC, bool kStats, class ALoader>
__device__ __forceinline__ void gemm(const CUtensorMap* bmap, const ALoader& a,
                                     float* __restrict__ C, float* __restrict__ ws, int64_t M,
                                     int N, int64_t K, int64_t k_chunk, int splits,
                                     float* __restrict__ tile_sums) {
  static_assert(ALoader::kKMajor, "a K-major A");
  static_assert(VEC == 4 || VEC == 1, "VEC");
  using T = Tile<BN>;
  using Cursor = typename ALoader::Cursor;
  constexpr int S = T::STAGES;
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  uint8_t* smem = wg_smem_raw + ((1024 - (tc::smem_u32(wg_smem_raw) & 1023)) & 1023);
  float* red = reinterpret_cast<float*>(smem + S * T::STAGE_BYTES);  // [2][WARPS][BN]
  // per slot and copying thread: which of its copies read data (bit 4r + j)
  // and, with 16-byte copies, the channel of its first column (above bit 16)
  uint32_t* info = reinterpret_cast<uint32_t*>(red + 2 * WARPS * BN);  // [S][THREADS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;  // this warp's rows: warpgroup warp / 4, slice warp % 4
  const int m_tiles = (int)((M + BM - 1) / BM), n_tiles = (N + BN - 1) / BN;
  const int items = m_tiles * n_tiles * splits;

  // work item i of this block: its tile, K range and slices (nk 0 past the end)
  struct Item {
    int m, col0, z, nk;
    int64_t k_lo, k_hi;
  };
  auto item = [&](int i) {
    Item it{};
    const int w = blockIdx.x + i * gridDim.x;
    if (w >= items) return it;
    it.m = w % m_tiles;
    it.col0 = (w / m_tiles) % n_tiles * BN;
    it.z = w / (m_tiles * n_tiles);
    it.k_lo = it.z * k_chunk;
    it.k_hi = K < it.k_lo + k_chunk ? K : it.k_lo + k_chunk;
    it.nk = (int)((it.k_hi - it.k_lo + BK - 1) / BK);
    return it;
  };

  // copy roles of A, as tc::gemm_k: columns a_k .. a_k + 3 of rows a_m + r * 32
  constexpr int A_TPR = BK / 4;
  constexpr int A_RSTEP = THREADS / A_TPR;
  constexpr int A_ROWS = BM / A_RSTEP;
  constexpr int NCUR = VEC == 4 ? 1 : 4;
  const int a_k = (tid % A_TPR) * 4, a_m = tid / A_TPR;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)bmap) : "memory");
  }
  __syncthreads();

  auto a_slot = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * T::STAGE_BYTES + 2 * T::B_BYTES);
  };

  // the copying side: the next slice of this block's stream into the ring
  int p_i = 0, p_kt = 0, issued = 0;
  Item pit = item(0);
  typename ALoader::Row rows[A_ROWS];
  Cursor cur[NCUR];
  auto start_item = [&]() {
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) rows[r] = a.row((int64_t)pit.m * BM + a_m + r * A_RSTEP);
#pragma unroll
    for (int j = 0; j < NCUR; ++j) {
      const int64_t k = pit.k_lo + a_k + j;
      cur[j] = a.cursor(k < K ? k : K - 1);  // a column past K is masked
    }
  };
  if (pit.nk > 0) start_item();
  auto load_next = [&]() {
    if (p_kt == pit.nk) {
      pit = item(++p_i);
      p_kt = 0;
      if (pit.nk == 0) return;  // the stream is done
      start_item();
    }
    const int slot = issued % S;
    float* as = a_slot(slot);
    const int64_t kc = pit.k_lo + (int64_t)p_kt * BK + a_k;
    uint32_t mask = 0;
#pragma unroll
    for (int r = 0; r < A_ROWS; ++r) {
      float* dst = as + (a_m + r * A_RSTEP) * LDK + a_k;
#pragma unroll
      for (int j = 0; j < NCUR; ++j) {
        const bool ok = kc + j < pit.k_hi && a.in(rows[r], cur[j]);
        tc::cp_async<VEC>(dst + j, ok ? a.at(rows[r], cur[j]) : a.x, ok);
        mask |= (uint32_t)ok << (4 * r + j);
      }
    }
    if constexpr (VEC == 4) mask |= (uint32_t)cur[0].ci << 16;
    info[slot * THREADS + tid] = mask;
#pragma unroll
    for (int j = 0; j < NCUR; ++j) a.advance(cur[j]);
    if (tid == 0) {
      const int k0 = (int)(pit.k_lo + (int64_t)p_kt * BK);
      uint8_t* bs = smem + slot * T::STAGE_BYTES;
      mbar_expect_tx(&full[slot], 2 * T::B_BYTES);
      tma_load_3d(bs, bmap, &full[slot], k0, pit.col0, 0);
      tma_load_3d(bs + T::B_BYTES, bmap, &full[slot], k0, pit.col0, 1);
    }
    ++p_kt;
    ++issued;
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    load_next();
    tc::cp_async_commit();
  }
  float acc[T::NACC], d[T::NACC];
  int g = 0;  // slices consumed
  for (int c_i = 0;; ++c_i) {
    const Item it = item(c_i);
    if (it.nk == 0) break;
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = d[i] = 0.f;
    for (int kt = 0; kt < it.nk; ++kt, ++g) {
      const int slot = g % S;
      tc::cp_async_wait<S - 2>();  // this thread's copies of slice g have landed
      if constexpr (ALoader::kPrologue) {
        if (a.prologue) {  // the thread's own elements of slice g, in place
          float* as = a_slot(slot);
          const uint32_t mask = info[slot * THREADS + tid];
          if constexpr (VEC == 4) {
            // four channels of one tap, all four read or none: their
            // (scale, shift) loaded once, each row's four elements read
            // and written as one 16-byte vector
            if (mask & 0xFFFF) {
              Cursor c{};
              c.ci = (int)(mask >> 16);
              float4 sc, sh;
              a.affine4(c, sc, sh);
#pragma unroll
              for (int r = 0; r < A_ROWS; ++r) {
                if (!(mask >> (4 * r) & 1)) continue;
                float4* p = reinterpret_cast<float4*>(as + (a_m + r * A_RSTEP) * LDK + a_k);
                float4 v = *p;
                v.x = a.affine(v.x, sc.x, sh.x);
                v.y = a.affine(v.y, sc.y, sh.y);
                v.z = a.affine(v.z, sc.z, sh.z);
                v.w = a.affine(v.w, sc.w, sh.w);
                *p = v;
              }
            }
          } else {
            const int64_t kc = it.k_lo + (int64_t)kt * BK + a_k;
#pragma unroll
            for (int r = 0; r < A_ROWS; ++r) {
              float* p = as + (a_m + r * A_RSTEP) * LDK + a_k;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (mask >> (4 * r + j) & 1) p[j] = a.apply(p[j], a.cursor(kc + j), 0);
            }
          }
        }
      }
      __syncthreads();  // every thread's slice g, transformed; slot g - 1 is free
      load_next();
      tc::cp_async_commit();

      // the warp's A fragments of the four 8-deep steps, split in registers:
      // a0..a3 = A(gid, tig), A(gid + 8, tig), A(gid, tig + 4), A(gid + 8, tig + 4)
      uint32_t ah[4][4], al[4][4];
      const float* ar = a_slot(slot) + (wrow + gid) * LDK + tig;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        tc::split_tf32(ar[ks * 8], ah[ks][0], al[ks][0]);
        tc::split_tf32(ar[8 * LDK + ks * 8], ah[ks][1], al[ks][1]);
        tc::split_tf32(ar[ks * 8 + 4], ah[ks][2], al[ks][2]);
        tc::split_tf32(ar[8 * LDK + ks * 8 + 4], ah[ks][3], al[ks][3]);
      }
      mbar_wait(&full[slot], (uint32_t)(g / S) & 1);  // B's two boxes have landed
      const uint32_t bsa = tc::smem_u32(smem + slot * T::STAGE_BYTES);
      const uint64_t bh = desc_sw128(bsa), bl = desc_sw128(bsa + T::B_BYTES);
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) fence_operand(d[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Mma<BN>::run(d, al[ks], bh + 2 * ks, ks);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Mma<BN>::run(d, ah[ks], bl + 2 * ks, 1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) Mma<BN>::run(d, ah[ks], bh + 2 * ks, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) {
        fence_operand(d[i]);
        acc[i] += d[i];
      }
    }

    // the item's tile: float2 stores where N is even (every pair then
    // 8-byte aligned)
    const int64_t row0 = (int64_t)it.m * BM;
    float* out = splits == 1 ? C : ws + (int64_t)it.z * M * N;
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = row0 + wrow + gid + 8 * h;
      if (gm >= M) continue;
      float* crow = out + a.out_row(gm) * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int gc = it.col0 + 8 * j + 2 * tig;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs && gc + 1 < N) {
          *reinterpret_cast<float2*>(crow + gc) = make_float2(v0, v1);
        } else {
          if (gc < N) crow[gc] = v0;
          if (gc + 1 < N) crow[gc + 1] = v1;
        }
      }
    }
    if constexpr (kStats) {
      if (splits > 1 || tile_sums == nullptr) continue;  // the same for the whole block
      // this thread's columns 8j + 2 tig + e over its two rows
      float s[BN / 8][2], q[BN / 8][2];
      const bool ok0 = row0 + wrow + gid < M, ok1 = row0 + wrow + gid + 8 < M;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = ok0 ? acc[4 * j + e] : 0.f;
          const float v1 = ok1 ? acc[4 * j + 2 + e] : 0.f;
          s[j][e] = v0 + v1;
          q[j][e] = v0 * v0 + v1 * v1;
        }
      // over the 8 gid of a tig: lanes tig, tig + 4, ... (lane = 4 gid + tig)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], off);
            q[j][e] += __shfl_xor_sync(0xffffffffu, q[j][e], off);
          }
      if (gid == 0) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * tig + e;
            red[warp * BN + col] = s[j][e];
            red[(WARPS + warp) * BN + col] = q[j][e];
          }
      }
      __syncthreads();
      if (tid < 2 * BN) {
        const int which = tid / BN, col = tid % BN;
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) t += red[(which * WARPS + w) * BN + col];
        if (it.col0 + col < N) tile_sums[((int64_t)it.m * 2 + which) * N + it.col0 + col] = t;
      }
      __syncthreads();  // red is read before the next item writes it
    }
  }
  tc::cp_async_wait<0>();
}

// bs = the K-major split of B (K, N) row-major: bs[0][n][k] = tf32(B(k, n)),
// bs[1][n][k] = tf32(B(k, n) - bs[0][n][k]) (cvt.rna), k < kp, 0 for
// k >= K. One 32 x 32 tile per block, through shared memory; gridDim.z
// walks `jobs` (several weights in one launch), a block past its job's
// extent does nothing.
struct SplitJob {
  const float* b;
  float* bs;
  int K, N, kp;
};
struct SplitJobs {
  SplitJob job[3];
};

// internal to each source that includes this header (K8-bf16's and K1's
// bf16 dW core, wgb_gemm.cuh, includes it too)
namespace {

constexpr int SPLIT_TILE = 32;
constexpr int SPLIT_ROWS = 8;  // threadIdx.y extent

__global__ void __launch_bounds__(SPLIT_TILE * SPLIT_ROWS)
split_tf32_kmajor(const __grid_constant__ SplitJobs jobs) {
  const SplitJob& jb = jobs.job[blockIdx.z];  // read in place: no copy to the stack
  const int k0 = blockIdx.x * SPLIT_TILE, n0 = blockIdx.y * SPLIT_TILE;
  if (k0 >= jb.kp || n0 >= jb.N) return;
  __shared__ float t[SPLIT_TILE][SPLIT_TILE + 1];
  for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    t[i][threadIdx.x] = k < jb.K && n < jb.N ? jb.b[(int64_t)k * jb.N + n] : 0.f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)jb.N * jb.kp;
  for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < jb.N && k < jb.kp) {
      uint32_t hi, lo;
      tc::split_tf32(t[threadIdx.x][i], hi, lo);
      jb.bs[(int64_t)n * jb.kp + k] = __uint_as_float(hi);
      jb.bs[plane + (int64_t)n * jb.kp + k] = __uint_as_float(lo);
    }
  }
}

// enqueue the split of the given jobs (count <= 3) on s
inline int launch_split(const SplitJobs& jobs, int count, cudaStream_t s) {
  int kp = 0, n = 0;
  for (int i = 0; i < count; ++i) {
    kp = jobs.job[i].kp > kp ? jobs.job[i].kp : kp;
    n = jobs.job[i].N > n ? jobs.job[i].N : n;
  }
  const dim3 grid((unsigned)((kp + SPLIT_TILE - 1) / SPLIT_TILE),
                  (unsigned)((n + SPLIT_TILE - 1) / SPLIT_TILE), (unsigned)count);
  split_tf32_kmajor<<<grid, dim3(SPLIT_TILE, SPLIT_ROWS), 0, s>>>(jobs);
  return (int)cudaGetLastError();
}

}  // namespace

// libcuda's cuTensorMapEncodeTiled through the runtime (no -lcuda);
// nullptr if the installed libcuda has none
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// status of a tensor-map failure: libcuda's CUresult above this base
constexpr int MAP_ERROR = 10000;

// the tensor map of bs [2][N][kp] (K columns valid) for BN-row boxes
inline int weight_map(CUtensorMap* map, const float* bs, int64_t K, int N, int64_t kp, int BN) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return MAP_ERROR;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * 4, (cuuint64_t)N * kp * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)bs, dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + (int)r;
}

// Launch `kernel` of tile width BN over an (M, N) output with `splits` K
// splits as a persistent grid, at most the blocks the card holds at once:
// kern(grid, smem, k_chunk); with several splits the kernel writes ws
// (splits * M * N floats) and splitk_sum adds them into out
template <int BN, class Kernel, class Launch>
inline int launch(Kernel* kernel, Launch&& kern, float* out, float* ws, int64_t M, int N,
                  int64_t K, int splits, cudaStream_t stream) {
  constexpr int smem = Tile<BN>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)e;
  const int64_t items = (M + BM - 1) / BM * ((N + BN - 1) / BN) * splits;
  const int64_t resident = (int64_t)sms * Tile<BN>::MIN_BLOCKS;
  kern(dim3((unsigned)(items < resident ? items : resident)), smem, tc::k_chunk_for(K, splits));
  if (splits > 1) {
    const int64_t mn = M * N;
    int64_t blocks = (mn + 255) / 256;
    if (blocks > 132 * 8) blocks = 132 * 8;
    splitk_sum<<<(unsigned)blocks, 256, 0, stream>>>(ws, out, mn, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace rt
