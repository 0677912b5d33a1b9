// bf16 GEMM core on Hopper's warpgroup MMA (wgmma) with TMA: bf16 operands
// read by descriptor from 128-byte-swizzled shared memory, an fp32
// accumulator, one rounding to bf16 at the end. Its first main loop,
// `mainloop`, carries K1's bf16 dW (conv.cu) and the bf16 fused conv K8
// (fused_conv.cuh); its second, `persistent`, K1's bf16 forward and dx and
// K3's bf16 forward; its third, `specialized`, the three GEMMs of the bf16
// K10 (block_fused.cu) (both below).
//
// C[m, n] = sum_k A(m, k) * B(k, n). One 256-thread block computes a
// 128 x BN tile (BN = 64 where N <= 64, else 128): two warpgroups of 64
// rows, each issuing wgmma.mma_async.m64nBNk16.f32.bf16.bf16 over the whole
// width with both operands in shared memory.
//
// Replaces, in bf16, the Pallas matmul the conv VJP runs per tap for dW
// (resnet_tpu/kernels/conv.py:172-196 on matmul.py:26) and the fused conv
// (fused_conv.py:45). Both take bf16 blocks into an fp32 accumulator and
// cast once; dW's JAX inputs are the upcast bf16 values, whose products are
// exact in fp32 here too.
//
// * Operand layouts. A slice is BK = 64 deep: one 128-byte swizzle row of
//   bf16. An MN-major operand (dW's A = x and B = g; K8's B = the weight
//   (K, Cout) row-major) is stored as TMA writes a box whose inner extent is
//   64 elements of the MN dimension: BK rows of 128 bytes, 8-row atoms
//   1024 bytes apart (SBO), a second 64-wide half 8192 bytes on (LBO), and
//   wgmma reads it with its transpose bit set: no thread transposes
//   anything. A k16 step moves the start address by two atoms (2048
//   bytes). A K-major A (K8's im2col gather) is 128 rows of 128 bytes, the
//   16-byte chunk j of row r at chunk j ^ (r % 8) (the same swizzle), a k16
//   step 32 bytes along the row.
// * Copies: a ring of STAGES slots in dynamic shared memory, one mbarrier
//   per slot counting the TMA bytes of its slice (every TMA box lands
//   whole: parts outside the tensor arrive as zeros and count). Threads
//   that write a slot themselves (K8's A by cp.async, then the prologue in
//   place; dW's 8-channel A by cp.async; the ragged widths' scalar loads)
//   fence their writes into the async proxy before the block barrier that
//   precedes the products. The block waits for every wgmma of a slice
//   before the barrier that frees its slot. An mbarrier phase that never completes traps (wg_gemm.cuh).
// * Accumulation: the four k16 wgmmas of a slice chain into a fresh
//   accumulator d (scale-d 0 on the first), and an fp32 add folds d into
//   the running sum once per 64-deep slice: the tensor core rounds its sums
//   toward zero, so a chain over dW's hundreds of thousands of pixels is
//   out; over one slice it is 4 steps.
// * Split-K: K splits at slice boundaries, `chunk` slices per split (the
//   last may be short or, where the caller's plan rounds differently, empty:
//   an empty split writes zeros). Several splits write fp32 partials that
//   splitk_sum_bf16 (or K8's splitk_sum_stats_bf16) add in split order and
//   round once. No atomics: a run repeats bit for bit.
// * Statistics (K8): per 128-row tile, [sum C, sum C^2] of each column from
//   the fp32 accumulator before its rounding, over each thread's two rows,
//   over gid by __shfl_xor, over the eight warps in warp order, into
//   tile_sums[(m tile * 2 + {0, 1}) * N + col].
//
// Each thread's accumulator d[4j + e] sits at row 16 * warp + gid +
// 8 * (e / 2), column 8j + 2 tig + e % 2 of the tile.
//
// K1's bf16 forward and dx (conv.cu), and through the forward K3's bf16
// forward (matmul.cu), run a second main loop, `persistent`: a grid of one
// block per SM walks the work units (row phase, m tile, n tile, K split)
// in a fixed order, and the ring runs across unit boundaries, so the next
// unit's first slices load while the current unit's last products and its
// epilogue run, and a unit's tile leaves from shared memory while the next
// unit runs. B is MN-major (the forward's weight) or K-major (dx's w as it
// lies). Its folds are bf16_gemm.cuh's (one fp32 add per k16 step, in K
// order) and its K splits those of the kernels it replaced, so it computes
// those kernels' bits.
//
// K10-bf16's three GEMMs (block_fused.cu) walk the same units on a third
// loop, `specialized`: the block's threads split by role. Two warpgroups
// copy (K8's gather: cp.async, then, with a prologue, the prologue in place
// once the thread's copies land; B by TMA) and hand each slot over on its
// `full` mbarrier; two multiply (four chained k16 wgmmas a slice, one fold
// a slice as `mainloop` folds, an arrival on the slot's `empty` mbarrier)
// and run each unit's epilogue (the staged TMA store, tile_stats) among
// themselves. So the copies, the prologue and a unit's epilogue run while
// the tensor cores work on other slices; on `persistent`, whose one thread
// stream does them all in turn between its products, K10's units came out
// slower than K8's on `mainloop` (PERF.md). With K8's units and K splits it
// computes K8's bits.
//
// Q1, the int8 conv of the W8A8 serving path (qconv.cu), runs `specialized`
// under its s8 policy (OP_S8): a slice is 128 int8 deep, still one 128-byte
// swizzle row of A and of a K-major B, taken in four
// wgmma.mma_async.m64nBNk32.s32.s8.s8 steps chained straight into an int32
// accumulator (integer sums are exact in any order, so no fold). On
// `persistent`, whose one thread stream copies and multiplies in turn, Q1
// was slower in every case measured (PERF.md).
//
// Measured: PERF.md (registers and shared memory from -Xptxas -v,
// chip_smoke.py's build phase).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "bf16_gemm.cuh"  // to_bf16, splitk_sum_bf16
#include "wg_gemm.cuh"    // mbarriers, fence_operand, the tensor-map encoder

namespace {
namespace wgb {

constexpr int BM = 128;
constexpr int BK = 64;          // bf16 per slice row: one 128-byte swizzle row
constexpr int THREADS = 256;
constexpr int HALF = 8192;      // bytes of a 64-row K-major tile or a 64-wide MN-major half
constexpr int ATOM = 1024;      // bytes of an 8-row swizzle atom

template <int BN>
struct Tile {
  // 64 or 128 wide; 8, 16 or 32 (a K-major B of so many rows) on
  // `persistent`; 256 on `specialized` under its s8 policy
  static_assert(BN == 8 || BN == 16 || BN == 32 || BN == 64 || BN == 128 || BN == 256, "BN");
  static constexpr int STAGES = BN == 64 ? 4 : 6;
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;  // resident per SM
  static constexpr int NACC = BN / 2;                   // accumulator floats per thread
  static constexpr int A_BYTES = 2 * HALF;              // 128 rows (or two 64-wide halves)
  static constexpr int B_BYTES = BN * 128;               // BN / 64 halves, or BN K-major rows
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the ring, the statistics' reduction [2][warps][BN], the copies' record
  // [STAGES][THREADS], + alignment slack
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + 2 * (THREADS / 32) * BN * 4 + STAGES * THREADS * 4 + ATOM;
};

// A's shared layouts: K-major, 128-byte swizzle (K8's gather); MN-major,
// 128-byte swizzle (dW's x at 64 channels a tap); MN-major without swizzle
// in 8-element groups (dW's x at 8 channels a tap: 64 pixels x 8 channels
// are 64 rows of 16 bytes, eight 8 x 8 core matrices 128 bytes apart along
// K, the next tap's 1024 bytes on along M)
constexpr int A_K = 0, A_MN = 1, A_MN8 = 2;

// descriptor of a 128-byte-swizzled tile at shared address saddr: 8-row
// atoms 1024 bytes apart along K, 64-wide MN halves `lbo` bytes apart (an
// MN-major operand; a K-major one ignores lbo)
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | ((uint64_t)1 << 62);
}

// descriptor of an unswizzled MN-major tile of 8 x 8 core matrices (A_MN8):
// K neighbours 128 bytes apart (LBO), M neighbours 1024 bytes (SBO)
__device__ __forceinline__ uint64_t desc_mn8(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(ATOM >> 4) << 32);
}

// A's descriptor for k16 step ks of the tile at a: two swizzle atoms on
// MN-major, 32 bytes along the row K-major, two core matrices unswizzled
template <int AL>
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int ks) {
  if constexpr (AL == A_K) return desc(a + ks * 32, 16);
  if constexpr (AL == A_MN) return desc(a + ks * 2 * ATOM, HALF);
  return desc_mn8(a + ks * 256);
}

// d (+)= A * B over one k16 step; TA, TB: the operand is MN-major
template <int BN, int TA, int TB>
struct Mma;

template <int TA, int TB>
struct Mma<64, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<8, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[4], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
        "%7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<16, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[8], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<32, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<128, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// d += A * B over one k32 step of int8 operands, both K-major (wgmma takes
// 8-bit operands K-major only), into an int32 accumulator; scale_d 0
// overwrites d
template <int BN>
struct MmaS8;

template <>
struct MmaS8<64> {
  __device__ static __forceinline__ void run(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct MmaS8<128> {
  __device__ static __forceinline__ void run(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct MmaS8<256> {
  __device__ static __forceinline__ void run(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// one TMA box of a 2-D or 4-D tensor map at the given coordinates into the
// shared address dst, its bytes reported to the mbarrier at bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes from global src to shared dst; ok false writes zeros, reads nothing
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// the same for 4 bytes (both addresses 4-byte aligned)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// the shared byte offset of 16-byte chunk j of row r in a swizzled tile of
// 128-byte rows
__device__ __forceinline__ int swz(int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); }

// The block's shared memory: the 1024-aligned ring, then the statistics'
// reduction and the copies' record
template <int BN>
struct Smem {
  uint8_t* ring;
  float* red;      // [2][WARPS][BN]
  uint32_t* info;  // [STAGES][THREADS]
  __device__ uint8_t* slot(int s) const { return ring + s * Tile<BN>::STAGE_BYTES; }
};

template <int BN>
__device__ __forceinline__ Smem<BN> smem_layout(uint8_t* raw) {
  using T = Tile<BN>;
  Smem<BN> s;
  s.ring = raw + ((ATOM - (rt::tc::smem_u32(raw) & (ATOM - 1))) & (ATOM - 1));
  s.red = reinterpret_cast<float*>(s.ring + T::STAGES * T::STAGE_BYTES);
  s.info = reinterpret_cast<uint32_t*>(s.red + 2 * (THREADS / 32) * BN);
  return s;
}

// The main loop over nk slices of this block's K range. blk.load(slot, kt)
// (every thread) starts slice kt's copies into `slot`: thread 0 arms the
// slot's mbarrier with the TMA bytes it then requests; blk.fix(slot, kt)
// (every thread) runs once the thread's own copies of slice kt have
// landed; blk.on(wg) says whether warpgroup wg's 64 rows exist. AL: A's
// layout (A_K: 128 rows; A_MN, A_MN8: two 64-wide halves, one per
// warpgroup). acc ends as the sum over the slices.
template <int BN, int AL, class Block>
__device__ __forceinline__ void mainloop(Block& blk, const Smem<BN>& sm, uint64_t* full,
                                         int nk, float (&acc)[Tile<BN>::NACC]) {
  using T = Tile<BN>;
  constexpr int S = T::STAGES;
  const int wg = threadIdx.x / 128;
  const bool on = blk.on(wg);
  float d[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = d[i] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) blk.load(s, s);
    rt::tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % S;
    rt::tc::cp_async_wait<S - 2>();  // this thread's copies of slice kt have landed
    blk.fix(slot, kt);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every thread's part of slice kt is in; slot kt - 1 is free
    if (kt + S - 1 < nk) blk.load((kt + S - 1) % S, kt + S - 1);
    rt::tc::cp_async_commit();
    rt::wg::mbar_wait(&full[slot], (uint32_t)(kt / S) & 1);  // its TMA boxes have landed
    if (on) {
      const uint32_t base = rt::tc::smem_u32(sm.slot(slot));
      const uint32_t a = base + wg * HALF, b = base + T::A_BYTES;
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) rt::wg::fence_operand(d[i]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        Mma<BN, AL != A_K, 1>::run(d, desc_a<AL>(a, ks), desc(b + ks * 2 * ATOM, HALF), ks);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < T::NACC; ++i) {
        rt::wg::fence_operand(d[i]);
        acc[i] = __fadd_rn(acc[i], d[i]);
      }
    }
  }
  rt::tc::cp_async_wait<0>();
}

// ------------------------------------------------ the persistent main loop

// One persistent block per SM, so a deeper ring than Tile's (LOOK slices
// load ahead of the one in the tensor cores, a slot reloaded in the slice
// after its products were retired; a caller that needs shared memory of
// its own takes fewer slots, S), and a staged output tile that TMA stores
// while the next unit runs
template <int BN, int S = BN == 128 ? 5 : 8>
struct PTile {
  static constexpr int STAGES = S;
  static constexpr int LOOK = STAGES - 1;
  static constexpr int OUT_BYTES = BN / 64 * BM * 128;  // 128-byte rows of 64 bf16
  // the ring, the output tile, the copies' record [STAGES][THREADS], +
  // alignment slack
  static constexpr int SMEM =
      STAGES * Tile<BN>::STAGE_BYTES + OUT_BYTES + STAGES * THREADS * 4 + ATOM;
  // ... and after the record tile_stats' reduction [2][WARPS][BN] (K10):
  // 210,944 bytes at BN = 128, 226,304 at 64, both within the 232,448 a
  // block may take
  static constexpr int STATS_SMEM = SMEM + 2 * (THREADS / 32) * BN * 4;
};
static_assert(PTile<64>::STATS_SMEM <= 232448 - 128 && PTile<128>::STATS_SMEM <= 232448 - 128,
              "the ring, the output tile, the record, the statistics' reduction and two "
              "mbarriers a slot fit a block's shared memory");

// The persistent block's shared memory: the ring, the output tile, the
// copies' record of every slot (a copier that has run ahead leaves the fix
// of the slots before intact), then the statistics' reduction, which only
// a kernel given PTile::STATS_SMEM bytes may use
template <int BN, int S = PTile<BN>::STAGES>
__device__ __forceinline__ Smem<BN> psmem_layout(uint8_t* raw) {
  Smem<BN> s;
  s.ring = raw + ((ATOM - (rt::tc::smem_u32(raw) & (ATOM - 1))) & (ATOM - 1));
  s.info = reinterpret_cast<uint32_t*>(s.ring + S * Tile<BN>::STAGE_BYTES +
                                       PTile<BN, S>::OUT_BYTES);
  s.red = reinterpret_cast<float*>(s.info + S * THREADS);
  return s;
}

// the persistent block's output tile, 1024-byte aligned after the ring
template <int BN, int S = PTile<BN>::STAGES>
__device__ __forceinline__ uint8_t* p_out(const Smem<BN>& sm) {
  return sm.ring + S * Tile<BN>::STAGE_BYTES;
}

// The work units of an (M, N) output on BM x BN tiles with `splits` K
// splits of `chunk` K columns each (a multiple of 16, of K): unit u is n
// tile u % n_tiles, then m tile, then split, so the units in flight at once
// share their rows of A through the L2. A split's last slice may reach past
// its end (the copies read zeros there). An output in several row phases
// (a strided dx: `phases` row sets of m_tiles tiles each, one split each,
// of depths pK) takes them in the order `phase` lists, the deepest first,
// each phase's units after the previous one's; a unit's z is its phase *
// splits + its split.
constexpr int MAX_PHASES = 16;  // a dx at stride 4

struct Units {
  int64_t m_tiles;
  int n_tiles, splits;
  int64_t K, chunk;
  int phases = 1;
  int8_t phase[MAX_PHASES] = {};  // the phases in unit order
  int64_t pK[MAX_PHASES] = {};    // ... and their depths (phases > 1)
  __host__ __device__ int64_t count() const { return m_tiles * n_tiles * splits * phases; }
  // unit u's tile, split and K columns; 32-bit divisions (the launchers keep
  // count() below 2^31; a 64-bit division is a long software sequence, and
  // a block decodes each unit twice, as copier and as consumer)
  // (SK: K columns a slice: BK bf16, or the s8 policy's 128 int8)
  template <int BN, int SK = BK>
  __device__ void at(int u, int64_t& row0, int& col0, int& z, int64_t& k0, int64_t& k1,
                     int& nk) const {
    col0 = u % n_tiles * BN;
    const int r = u / n_tiles, mt = (int)m_tiles;
    row0 = (int64_t)(r % mt) * BM;
    const int q = r / mt, split = q % splits, rank = q / splits;
    const int64_t depth = phases > 1 ? pK[rank] : K;
    z = (phases > 1 ? phase[rank] : 0) * splits + split;
    k0 = split * chunk;
    k1 = depth < k0 + chunk ? depth : k0 + chunk;
    nk = k1 > k0 ? (int)((k1 - k0 + SK - 1) / SK) : 0;
  }
};

// The persistent main loop over the units of `un`, unit u on block
// u % gridDim.x: blk.start(row0, col0, k0, k1, z) (every thread) points the
// copies at a unit's K columns [k0, k1), blk.load(slot, kt) starts slice kt
// of that unit (thread 0 arms the slot's mbarrier with its TMA bytes),
// blk.fix(slot, kt) runs once the thread's own copies of the slot (slice kt
// of the unit being summed) have landed;
// A is K-major (AL = A_K: 128 rows of 128 bytes) or MN-major (A_MN: a
// 64-wide half a warpgroup, read with the transpose bit), B MN-major (TB =
// 1: read with the transpose bit, 64-wide halves HALF bytes apart) or
// K-major (TB = 0: BN rows of 128 bytes, as a K-major A).
// Each k16 wgmma goes into a fresh accumulator, two in turn
// so that one group is in flight while the other is folded into the sum by
// an fp32 add, in K order: bf16_gemm.cuh's folds over the same 16-deep
// steps, so where the K splits agree the two cores give the same bits
// (the tensor core rounds its own sums toward zero: it sums 16 products
// here as there). A group left in flight across the copies'
// thread-dependent branches made ptxas serialize every wgmma (C7518, "WG.DP
// in divergent path"): each slice retires its groups before the next
// slice's copies. epi(acc, row0, col0, z) (every thread) takes each unit's
// sum.
template <int BN, int S = PTile<BN>::STAGES, int TB = 1, int AL = A_K, class Block, class Epi>
__device__ __forceinline__ void persistent(Block& blk, const Smem<BN>& sm, uint64_t* full,
                                           const Units& un, Epi&& epi) {
  using T = Tile<BN>;
  constexpr int LOOK = PTile<BN, S>::LOOK;
  const int total = (int)un.count();
  // the copying side runs LOOK slices ahead: unit lu, its slice lk of lnk
  int lu = blockIdx.x;
  int64_t gl = 0;
  int lk = 0, lnk = 0;
  auto start = [&]() {
    int64_t row0, k0, k1;
    int col0, z;
    un.at<BN>(lu, row0, col0, z, k0, k1, lnk);
    blk.start(row0, col0, k0, k1, z);
  };
  if (lu < total) start();
  auto next_load = [&]() {
    while (lu < total && lk == lnk) {  // this unit is issued: the block's next
      lu += gridDim.x;
      lk = 0;
      if (lu < total) start();
    }
    if (lu < total) {
      blk.load((int)(gl % S), lk);
      ++lk;
      ++gl;
    }
  };
#pragma unroll 1
  for (int s = 0; s < LOOK; ++s) {
    next_load();
    rt::tc::cp_async_commit();
  }
  const uint32_t wg_a = (threadIdx.x / 128) * HALF;
  float acc[T::NACC], d[T::NACC], e[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) d[i] = e[i] = 0.f;
  int64_t g = 0;  // slices consumed
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int64_t row0, k0, k1;
    int col0, z, nk;
    un.at<BN>(u, row0, col0, z, k0, k1, nk);
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int slot = (int)(g % S);
      rt::tc::cp_async_wait<LOOK - 1>();  // this thread's copies of slice g landed
      blk.fix(slot, kt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // every thread's part of slice g is in; slot g - 1 is free
      next_load();
      rt::tc::cp_async_commit();
      rt::wg::mbar_wait(&full[slot], (uint32_t)(g / S) & 1);  // its TMA boxes have landed
      const uint32_t base = rt::tc::smem_u32(sm.slot(slot));
      // two fresh accumulators in turn, one group in flight while the other folds
      auto issue = [&](float (&dd)[T::NACC], int ks) {
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) rt::wg::fence_operand(dd[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t b = base + T::A_BYTES;
        Mma<BN, AL != A_K, TB>::run(dd, desc_a<AL>(base + wg_a, ks),
                            TB ? desc(b + ks * 2 * ATOM, HALF) : desc(b + ks * 32, 16), 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      };
      auto fold = [&](float (&dd)[T::NACC]) {
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) {
          rt::wg::fence_operand(dd[i]);
          acc[i] = __fadd_rn(acc[i], dd[i]);
        }
      };
      issue(d, 0);
      issue(e, 1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fold(d);
      issue(d, 2);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fold(e);
      issue(e, 3);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fold(d);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fold(e);
    }
    epi(acc, row0, col0, z);
  }
  rt::tc::cp_async_wait<0>();
}

// The threads that hold a tile's accumulators, THREADS of them: every
// thread of the block (FIRST = 0: threadIdx.x, __syncthreads) or, in
// `specialized`, the two multiplying warpgroups from thread FIRST = 256 on
// (their own named barrier, so the copying warpgroup runs on)
template <int FIRST>
struct Crew {
  __device__ static int tid() { return (int)threadIdx.x - FIRST; }
  __device__ static void sync() {
    if constexpr (FIRST == 0)
      __syncthreads();
    else
      asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
  }
};

// The tile of rows row0 + [0, 128), columns col0 + [0, BN) of the (M, N)
// bf16 output under ymap (boxes of 64 columns x BM rows, 128-byte swizzle)
// by TMA from the staged tile `out`: the thread's pairs rounded into the
// swizzled 128-byte rows (a warp's 32 stores on 32 banks), then thread 0
// stores it; the previous unit's store has read the stage before it is
// written again. TMA clips rows past M. Called by every thread of the crew.
template <int BN, class C = Crew<0>>
__device__ __forceinline__ void store_tile_tma(const float (&acc)[Tile<BN>::NACC], uint8_t* out,
                                               const CUtensorMap* ymap, int64_t row0, int col0) {
  const int tid = C::tid(), warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  C::sync();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (j / 8) * BM * 128 + swz(r, j % 8) + 4 * tig) =
          (uint32_t)bfg::to_bf16(acc[4 * j + 2 * h]) |
          ((uint32_t)bfg::to_bf16(acc[4 * j + 2 * h + 1]) << 16);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  C::sync();
  if (tid == 0) {
#pragma unroll
    for (int hb = 0; hb < BN / 64; ++hb)
      asm volatile(
          "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
              (uint64_t)ymap),
          "r"(rt::tc::smem_u32(out + hb * BM * 128)), "r"(col0 + 64 * hb), "r"((int)row0)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// the output tiles' TMA stores complete (the crew's thread 0 issued them)
template <class C = Crew<0>>
__device__ __forceinline__ void store_tma_wait() {
  if (C::tid() == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The tile of rows row0 + [0, 128), columns col0 + [0, BN) of an (M, N)
// bf16 output whose tile row m lies at y's row row_of(m) (stride N, N % 8
// == 0, y 16-byte aligned): rounded into the staged tile `out` as
// store_tile_tma stages it, then each row leaves in 16-byte stores, a
// thread's rows decoded once. Rows past M, and rows row_of maps to -1, are
// not written. Called by every
// thread; the previous unit's tile has been read out of the stage before it
// is written again.
template <int BN, class RowOf>
__device__ __forceinline__ void store_rows(const float (&acc)[Tile<BN>::NACC], uint8_t* out,
                                           int64_t row0, int col0, int64_t M, int N, uint16_t* y,
                                           RowOf row_of) {
  constexpr int CH = BN / 8;  // 16-byte chunks a row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      *reinterpret_cast<uint32_t*>(out + (j / 8) * BM * 128 + swz(r, j % 8) + 4 * tig) =
          (uint32_t)bfg::to_bf16(acc[4 * j + 2 * h]) |
          ((uint32_t)bfg::to_bf16(acc[4 * j + 2 * h + 1]) << 16);
  }
  __syncthreads();
  const int j = tid % CH, c = col0 + 8 * j;
#pragma unroll
  for (int i = 0; i < BM * CH / THREADS; ++i) {
    const int r = tid / CH + THREADS / CH * i;
    const int64_t gm = row0 + r;
    const int64_t yr = gm < M ? row_of(gm) : -1;
    if (yr >= 0 && c < N)
      *reinterpret_cast<uint4*>(y + yr * N + c) =
          *reinterpret_cast<const uint4*>(out + (j / 8) * BM * 128 + swz(r, j % 8));
  }
}

// the identity row map: tile row m is row m of the output
struct SameRow {
  __device__ int64_t operator()(int64_t m) const { return m; }
};

// The tile of rows row0 + [0, 128), columns col0 + [0, BN) of an (M, N)
// output, each thread its own pairs straight from its registers: rounded to
// bf16 into y (row-major, stride N; tile row m at y's row row_of(m)), or,
// with part, fp32 into part. Rows past M, and rows row_of maps to -1, are
// not written.
template <int BN, class RowOf = SameRow, class C = Crew<0>>
__device__ __forceinline__ void store_pairs(const float (&acc)[Tile<BN>::NACC], int64_t row0,
                                            int col0, int64_t M, int N, uint16_t* y, float* part,
                                            RowOf row_of = {}) {
  const int warp = C::tid() >> 5, lane = C::tid() & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t gm = row0 + warp * 16 + gid + 8 * h;
    if (gm >= M || (!part && row_of(gm) < 0)) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int gc = col0 + 8 * j + 2 * tig;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (part) {
        float* p = part + gm * N + gc;
        if (pairs && gc + 1 < N) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (gc < N) p[0] = v0;
          if (gc + 1 < N) p[1] = v1;
        }
      } else {
        uint16_t* p = y + row_of(gm) * N + gc;
        if (pairs && gc + 1 < N) {
          *reinterpret_cast<uint32_t*>(p) =
              (uint32_t)bfg::to_bf16(v0) | ((uint32_t)bfg::to_bf16(v1) << 16);
        } else {
          if (gc < N) p[0] = bfg::to_bf16(v0);
          if (gc + 1 < N) p[1] = bfg::to_bf16(v1);
        }
      }
    }
  }
}

// The block's tile of rows row0 + [0, 128), columns col0 + [0, BN) of an
// (M, N) output: rounded to bf16 into y (row-major, stride N), or, with
// part, fp32 into part (the block's split's (M, N) partials). Where N % 8
// == 0 and the output is 16-byte aligned the tile goes through the ring
// (free once every warpgroup is past its last slice) and leaves in 16-byte
// stores along whole rows; otherwise each thread writes its own pairs.
// Rows past M, which a warpgroup that is off holds, are not written.
// Called by every thread of the block.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[Tile<BN>::NACC], const Smem<BN>& sm,
                                           int64_t row0, int col0, int64_t M, int N,
                                           uint16_t* y, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uintptr_t out = part ? (uintptr_t)part : (uintptr_t)y;
  if (N % 8 == 0 && out % 16 == 0) {
    __syncthreads();  // every warpgroup is done with the ring
    if (part) {
      constexpr int LD = BN + 4;  // floats a staged row
      float* t = reinterpret_cast<float*>(sm.ring);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(t + (warp * 16 + gid + 8 * h) * LD + 8 * j + 2 * tig) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      __syncthreads();
      for (int q = tid; q < BM * BN / 4; q += THREADS) {
        const int r = q / (BN / 4), c = q % (BN / 4) * 4;
        const int64_t gm = row0 + r;
        if (gm < M && col0 + c < N)
          *reinterpret_cast<float4*>(part + gm * N + col0 + c) =
              *reinterpret_cast<const float4*>(t + r * LD + c);
      }
    } else {
      constexpr int LD = BN + 8;  // bf16 a staged row
      uint16_t* t = reinterpret_cast<uint16_t*>(sm.ring);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<uint32_t*>(t + (warp * 16 + gid + 8 * h) * LD + 8 * j + 2 * tig) =
              (uint32_t)bfg::to_bf16(acc[4 * j + 2 * h]) |
              ((uint32_t)bfg::to_bf16(acc[4 * j + 2 * h + 1]) << 16);
      __syncthreads();
      for (int q = tid; q < BM * BN / 8; q += THREADS) {
        const int r = q / (BN / 8), c = q % (BN / 8) * 8;
        const int64_t gm = row0 + r;
        if (gm < M && col0 + c < N)
          *reinterpret_cast<uint4*>(y + gm * N + col0 + c) =
              *reinterpret_cast<const uint4*>(t + r * LD + c);
      }
    }
    return;
  }
  store_pairs<BN>(acc, row0, col0, M, N, y, part);
}

// The tile's per-column [sum C, sum C^2] over its valid rows into
// tile_sums[(m_tile * 2 + {0, 1}) * N + col], in one fixed order. Called by
// every thread of the crew.
template <int BN, class C = Crew<0>>
__device__ __forceinline__ void tile_stats(const float (&acc)[Tile<BN>::NACC], const Smem<BN>& sm,
                                           int64_t m_tile, int col0, int64_t M, int N,
                                           float* __restrict__ tile_sums) {
  constexpr int WARPS = THREADS / 32;
  const int tid = C::tid(), warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t r0 = m_tile * BM + warp * 16 + gid;
  const bool ok0 = r0 < M, ok1 = r0 + 8 < M;
  float s[BN / 8][2], q[BN / 8][2];
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
        sm.red[warp * BN + col] = s[j][e];
        sm.red[(WARPS + warp) * BN + col] = q[j][e];
      }
  }
  C::sync();
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += sm.red[(which * WARPS + w) * BN + col];
    if (col0 + col < N) tile_sums[(m_tile * 2 + which) * N + col0 + col] = t;
  }
}

// the slot's mbarriers initialised by thread 0 before any copy
template <int S>
__device__ __forceinline__ void init_barriers(uint64_t* full) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) rt::wg::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------ the specialized main loop

constexpr int COPIERS = 256;                   // two copying warpgroups, threads 0-255
constexpr int WS_THREADS = COPIERS + THREADS;  // ... and two multiplying ones
// registers a thread after the split (setmaxnreg): the copiers give up what
// the multipliers' accumulators take, 65,536 in all
constexpr int COPY_REGS = 88;
constexpr int MUL_REGS = (65536 / 32 - COPIERS / 32 * COPY_REGS) / (THREADS / 32) / 8 * 8;
static_assert(MUL_REGS == 168 && COPIERS * COPY_REGS + THREADS * MUL_REGS <= 65536, "registers");

// The same split with NC copying threads (COPIERS, or one warpgroup of
// 128 for Q1's 256-wide tiles, whose 384 threads launch with 168 registers
// each, so the multipliers may take 216): NC + THREADS threads in all
template <int NC>
struct WsRegs {
  static_assert(NC == COPIERS || NC == 128, "one or two copying warpgroups");
  static constexpr int COPY = NC == COPIERS ? COPY_REGS : 72;
  static constexpr int MUL = NC == COPIERS ? MUL_REGS : 216;
  static_assert(NC * COPY + THREADS * MUL <= (NC + THREADS) * (65536 / (NC + THREADS) / 8 * 8),
                "the split fits the registers the block launches with");
};

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(rt::tc::smem_u32(bar))
               : "memory");
}

// full[s] completes when the slot's TMA bytes have landed, every copier has
// handed its part over and thread 0 has armed it; empty[s] when every
// multiplying thread is done reading the slot
template <int S, int NC = COPIERS>
__device__ __forceinline__ void init_ws_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      rt::wg::mbar_init(&full[s], NC + 1);
      rt::wg::mbar_init(&empty[s], THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The specialized main loop over the units of `un` (unit u on block u %
// gridDim.x, WS_THREADS threads), a ring of S slots. The copiers (threads
// 0-255, COPY_REGS registers each): blk.start(row0, col0, k0, k1, z) points
// them at a unit, blk.load(slot, kt) starts slice kt of it once the
// multipliers have released the slot (empty), and the thread hands its part
// of the slot over to full: with kFix, D = S - 2 slices later, once its own
// copies have landed, after blk.fix(slot) (K10's prologue, in place) and a
// proxy fence; without, at once by blk.publish(&full[slot]), an arrival
// once its copies land. full counts COPIERS + 1 arrivals (thread 0 adds one
// as it arms the slot's TMA bytes). The multipliers (threads 256-511,
// MUL_REGS registers, warpgroup w - 2 taking A's rows 64 (w - 2) on,
// K-major; B MN-major), per slice: the four k16 wgmmas chained into a fresh
// accumulator (scale-d 0 on the first), retired and folded into the unit's
// sum by one fp32 add, as `mainloop` folds, and an arrival on empty; then
// epi(acc, row0, col0, z) among themselves (Crew<COPIERS>'s index and
// barrier). So the copies, the prologue and a unit's epilogue run beside
// the products. No wgmma group is in flight across a branch (ptxas C7518).
// D < S, so the copiers never wait for a slot whose last slice they have
// not handed over; D = S - 2 leaves a slice between a hand-over and the
// slot's next filling (at S - 1 the two sides ran in lock step, slower).
// Under OP_S8 (Q1) both operands are int8 and K-major, a slice 128 deep (K
// counted in bytes), and the multipliers chain its four k32 wgmmas into the
// unit's int32 accumulator (no fold); acc is int; B is read from the slot
// blk.b_slot(slot, kt) names (a Block that keeps a weight resident in the
// ring's B regions), else from the slot itself. NC: the copying threads
// (WsRegs), the multipliers' from NC on.
constexpr int OP_BF16 = 0, OP_S8 = 1;

template <class Block>
__device__ __forceinline__ auto b_slot_of(const Block& blk, int slot, int kt, int)
    -> decltype(blk.b_slot(slot, kt)) {
  return blk.b_slot(slot, kt);
}
template <class Block>
__device__ __forceinline__ int b_slot_of(const Block&, int slot, int, long) {
  return slot;
}

template <int BN, int S, bool kFix, int OP = OP_BF16, int NC = COPIERS, class Block, class Epi>
__device__ __forceinline__ void specialized(Block& blk, const Smem<BN>& sm, uint64_t* full,
                                            uint64_t* empty, const Units& un, Epi&& epi) {
  using T = Tile<BN>;
  using Acc = std::conditional_t<OP == OP_S8, int, float>;
  constexpr int SK = OP == OP_S8 ? 2 * BK : BK;  // K columns a slice
  constexpr int D = S - 2;
  const int total = (int)un.count();
  if (threadIdx.x < NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WsRegs<NC>::COPY));
    int64_t g = 0, f = 0;  // slices issued, slices handed over (kFix)
    auto hand_over = [&]() {
      const int slot = (int)(f % S);
      blk.fix(slot);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[slot]);
      ++f;
    };
    for (int u = blockIdx.x; u < total; u += gridDim.x) {
      int64_t row0, k0, k1;
      int col0, z, nk;
      un.at<BN, SK>(u, row0, col0, z, k0, k1, nk);
      blk.start(row0, col0, k0, k1, z);
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const int slot = (int)(g % S);
        if (g >= S) rt::wg::mbar_wait(&empty[slot], (uint32_t)(g / S + 1) & 1);
        blk.load(slot, kt);
        if constexpr (kFix) {
          rt::tc::cp_async_commit();
          if (g - f >= D) {
            rt::tc::cp_async_wait<D>();  // slice f's copies (D groups newer) have landed
            hand_over();
          }
        } else {
          blk.publish(&full[slot]);
        }
      }
    }
    if constexpr (kFix) {
      rt::tc::cp_async_wait<0>();
      while (f < g) hand_over();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WsRegs<NC>::MUL));
  const uint32_t wg_a = ((int)threadIdx.x / 128 - NC / 128) * HALF;
  Acc acc[T::NACC];
  float d[T::NACC];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) d[i] = 0.f;
  int64_t g = 0;  // slices consumed
  for (int u = blockIdx.x; u < total; u += gridDim.x) {
    int64_t row0, k0, k1;
    int col0, z, nk;
    un.at<BN, SK>(u, row0, col0, z, k0, k1, nk);
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] = 0;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int slot = (int)(g % S);
      rt::wg::mbar_wait(&full[slot], (uint32_t)(g / S) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t base = rt::tc::smem_u32(sm.slot(slot)), b = base + T::A_BYTES;
      if constexpr (OP == OP_S8) {
        const uint32_t bb = rt::tc::smem_u32(sm.slot(b_slot_of(blk, slot, kt, 0))) + T::A_BYTES;
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) rt::wg::fence_operand(acc[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < SK / 32; ++ks)
          MmaS8<BN>::run(acc, desc(base + wg_a + ks * 32, 16), desc(bb + ks * 32, 16), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) rt::wg::fence_operand(acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) rt::wg::fence_operand(d[i]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          Mma<BN, 0, 1>::run(d, desc_a<A_K>(base + wg_a, ks), desc(b + ks * 2 * ATOM, HALF), ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < T::NACC; ++i) {
          rt::wg::fence_operand(d[i]);
          acc[i] = __fadd_rn(acc[i], d[i]);
        }
      }
      mbar_arrive(&empty[slot]);
    }
    epi(acc, row0, col0, z);
  }
}

// ------------------------------------------------------------ host side

// A tensor map of `rank` dims of bf16 (bytes = 2) or int8 (bytes = 1)
// elements (dims[0] contiguous; strides in bytes of dims 1..rank-1) for
// boxes `box`, 128-byte swizzle, zeros outside the tensor. 0, or
// rt::wg::MAP_ERROR + libcuda's status.
inline int map_tiled(CUtensorMap* map, int bytes, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const rt::wg::EncodeTiled encode = rt::wg::encode_tiled();
  if (encode == nullptr) return rt::wg::MAP_ERROR;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : rt::wg::MAP_ERROR + (int)r;
}

inline int map_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint64_t* strides, const cuuint32_t* box) {
  return map_tiled(map, 2, base, rank, dims, strides, box);
}

// the map of a (rows, cols) row-major matrix of bf16 (bytes = 2; cols % 8
// == 0) or int8 (bytes = 1; cols % 16 == 0), base 16-byte aligned, for
// boxes of one 128-byte swizzle row (64 bf16 or 128 int8 columns) x
// box_rows rows: an MN-major B (box_rows = BK), a K-major A of 128-row
// tiles (box_rows = BM), or Q1's K-major int8 weight (Cout, Kp) (box_rows
// = the tile width)
inline int matrix_map(CUtensorMap* map, const void* base, int64_t rows, int cols,
                      int box_rows = BK, int bytes = 2) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / bytes), (cuuint32_t)box_rows};
  return map_tiled(map, bytes, base, 2, dims, strides, box);
}

// matrix_map through a cache of recent maps keyed by everything a map
// encodes (address, shape, box, element size; not the contents), so a
// weight or an activation seen again is not encoded again: 512 entries,
// 4-way sets, round-robin replacement (a ResNet-50 step holds ~130 maps)
inline int cached_matrix_map(CUtensorMap* map, const void* base, int64_t rows, int cols,
                             int box_rows, int bytes = 2) {
  struct Entry {
    const void* base;
    int64_t rows;
    int cols, box_rows, bytes;
    CUtensorMap map;
  };
  constexpr int SETS = 128, WAYS = 4;
  static Entry cache[SETS][WAYS];
  static uint8_t next[SETS];
  static std::mutex mu;
  uint64_t h = (uint64_t)(uintptr_t)base ^ (uint64_t)rows << 20 ^ (uint64_t)cols << 40 ^
               (uint64_t)box_rows << 58 ^ (uint64_t)bytes << 62;
  h *= 0x9E3779B97F4A7C15ull;
  const int set = (int)(h >> 57);  // the top 7 bits
  std::lock_guard<std::mutex> lock(mu);
  for (Entry& e : cache[set])
    if (e.base == base && e.rows == rows && e.cols == cols && e.box_rows == box_rows &&
        e.bytes == bytes) {
      *map = e.map;
      return 0;
    }
  const int status = matrix_map(map, base, rows, cols, box_rows, bytes);
  if (status == 0) {
    cache[set][next[set]] = Entry{base, rows, cols, box_rows, bytes, *map};
    next[set] = (uint8_t)((next[set] + 1) % WAYS);
  }
  return status;
}

// Raise a kernel's dynamic shared memory limit to `bytes` once per kernel
// and device (a host-side attribute, no device work)
inline int max_smem_once(const void* kernel, int bytes) {
  static const void* kernels[64];
  static uint32_t devices[64];  // bit d: set on device d
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < 64 && kernels[i] != nullptr && kernels[i] != kernel) ++i;
  if (i < 64 && kernels[i] == kernel && bit && (devices[i] & bit)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  if (i < 64) {
    kernels[i] = kernel;
    devices[i] |= bit;
  }
  return 0;
}

// the current device's SM count, asked once per device
inline int sm_count(int* sms) {
  static int counts[32];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32 && counts[dev] > 0) {
    *sms = counts[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 32) counts[dev] = *sms;
  return 0;
}

// slices of BK in K
__host__ __device__ inline int64_t slices_of(int64_t K) { return (K + BK - 1) / BK; }

// Launch a kernel on wgb::persistent over `units` work units:
// kern(blocks, smem), one block per SM (fewer where there are fewer
// units), after raising its dynamic shared memory limit to `smem`
// (max_smem_once); then, for splits > 1, splitk_sum_bf16 of the partials ws
// (splits * mn floats) into y. Returns the launch status.
template <class Kernel, class Launch>
inline int launch_persistent(Kernel* kernel, int smem, int64_t units, Launch&& kern,
                             int splits, const float* ws, uint16_t* y, int64_t mn,
                             cudaStream_t s) {
  int status = max_smem_once((const void*)kernel, smem);
  int sms = 0;
  if (status == 0) status = sm_count(&sms);
  if (status != 0) return status;
  kern((unsigned)(units < sms ? units : sms), smem);
  if (splits > 1) {
    int64_t blocks = (mn + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    bfg::splitk_sum_bf16<<<(unsigned)blocks, 256, 0, s>>>(ws, y, mn, splits);
  }
  return (int)cudaGetLastError();
}

// Launch `kern(grid, smem)` for an (M, N) output of tile width BN with
// `splits` K splits, one block per (m tile, n tile, split), m fastest,
// after raising the kernel's dynamic shared memory limit (max_smem_once).
// Returns the launch status.
template <int BN, class Kernel, class Launch>
inline int launch(Kernel* kernel, Launch&& kern, int64_t M, int N, int splits) {
  constexpr int smem = Tile<BN>::SMEM;
  const int e = max_smem_once((const void*)kernel, smem);
  if (e != 0) return e;
  if (splits < 1 || splits > 65535 || (N + BN - 1) / BN > 65535 || (M + BM - 1) / BM > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  kern(dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN), (unsigned)splits),
       smem);
  return (int)cudaGetLastError();
}

}  // namespace wgb
}  // namespace
