// bf16 tensor-core GEMM core: bf16 operands, fp32 accumulator, one
// rounding to bf16 at the end. Carries K1's bf16 dW for ragged or
// misaligned operands (rt_conv2d_dw_nhwc_bf16_mma), the last entry point
// on its kernel. K1's bf16 forward, dx and dW, K3's bf16 forward and
// K8-bf16 (with K10-bf16's GEMMs) run on wgb_gemm.cuh's wgmma + TMA core
// instead (the forward's and dx's persistent kernels with this core's K
// chunks and 16-deep folds, so with the bits this core gave them: its
// k_chunk_for, splitk_sum_bf16 and loaders' helpers stay in use there);
// the FC backward is its own kernel in matmul.cu.
//
// C[m, n] = sum_k A(m, k) * B(k, n), C row-major. One 256-thread block
// computes a BM x BN tile (BM 128, BN 64) with
// eight warps, each a (BM / WM) x (BN / WN) sub-tile of
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 products.
//
// Replaces, in bf16, the Pallas matmul kernel (resnet_tpu/kernels/
// matmul.py:26) as the conv's VJP runs it for dW per tap (conv.py:172-196).
// On the TPU it takes bf16 blocks
// into `jnp.dot(..., preferred_element_type=float32)`, adds into an fp32
// VMEM accumulator and casts once to the output dtype (matmul.py:39).
// Here the same: a bf16 x bf16 product is exact in fp32,
// the tensor core adds 16 of them, and each 16-deep step goes into a fresh
// fragment that an fp32 add folds into the accumulator (the tensor core
// rounds its fp32 sums toward zero; tc_gemm.cuh measured what a chained
// accumulator costs). dW's inputs, which JAX upcasts to fp32 before its
// fp32 matmul (conv.py:180, :191), are bf16 values, so their products are
// exact here too and the result differs from JAX's only by summation order.
//
// Bound on the H100: operations, at 989 TFLOP/s dense bf16. This first
// bf16 core is simple and not near that bound:
// each thread copies 16 bytes of a tile at a time through registers into
// one shared slice (the next slice's loads are in flight while the tensor
// cores work on the current one), operands are gathered by loaders that
// compute their own indices (zero outside the image, beyond K and beyond
// the matrix), and its MN-contiguous operands are transposed as they are
// stored. wgb_gemm.cuh's wgmma (which takes bf16 operands MN-major as well
// as K-major) and TMA take these transposes out.
//
// Shared slices are [rows][BK + 8] bf16 with K contiguous: a row is 80
// bytes (20 words), so the 32 lanes of a fragment load, rows gid and words
// tig, fall on 32 banks.
//
// Split-K: gridDim.z splits K into chunks of k_chunk (a multiple of 16).
// With one split the tile is rounded to bf16 and written; with several,
// each split writes fp32 partials to a workspace that splitk_sum_bf16 adds
// in split order and rounds once. No atomics: a run repeats bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace bfg {

constexpr int BK = 32;
constexpr int BN = 64;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // bf16 per shared row
constexpr int KSTEP = 16;    // k_chunk granularity: one mma depth

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// 8 bf16 (as their bits) packed in a uint4, v[0] in the lowest half
__device__ __forceinline__ uint4 pack8(const uint16_t (&v)[8]) {
  return make_uint4((uint32_t)v[0] | ((uint32_t)v[1] << 16), (uint32_t)v[2] | ((uint32_t)v[3] << 16),
                    (uint32_t)v[4] | ((uint32_t)v[5] << 16), (uint32_t)v[6] | ((uint32_t)v[7] << 16));
}

__device__ __forceinline__ uint16_t half_of(const uint4& u, int j) {
  const uint32_t w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
  return (uint16_t)(w >> (16 * (j & 1)));
}

__device__ __forceinline__ uint16_t ld16(const uint16_t* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ uint4 ld128(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A matrix whose element (mn, k) is p[k * ld + mn]: MN contiguous (a
// row-major (K, N) B, or a^T). vec: p 16-byte aligned and ld % 8 == 0.
struct RowMN {
  const uint16_t* __restrict__ p;
  int64_t cols, ld;
  bool vec;
  __device__ uint4 load8(int64_t mn, int64_t k, int64_t kend) const {
    if (k >= kend) return zero4();
    const uint16_t* q = p + k * ld + mn;
    if (vec && mn + 8 <= cols) return ld128(q);
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = mn + j < cols ? ld16(q + j) : 0;
    return pack8(v);
  }
};

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// (K, cols) row-major, element (mn, k) = p[k * cols + mn]
inline RowMN row_mn(const uint16_t* p, int64_t cols) {
  return RowMN{p, cols, cols, cols % 8 == 0 && aligned16(p)};
}

template <int BM, class AL, class BL>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const AL a, const BL b, uint16_t* __restrict__ y, float* __restrict__ ws,
            int64_t M, int N, int64_t K, int64_t k_chunk) {
  constexpr int WM = BM >= 128 ? 4 : 2;  // warps along M
  constexpr int WN = 8 / WM;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(MI >= 1 && NI >= 1, "warp tile");
  constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BN * BK / 8;
  constexpr int A_PER = (A_CHUNKS + THREADS - 1) / THREADS;
  constexpr int B_PER = (B_CHUNKS + THREADS - 1) / THREADS;
  __shared__ __align__(16) uint16_t as[BM * LDS];
  __shared__ __align__(16) uint16_t bs[BN * LDS];

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp % WM, wn = warp / WM;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t k0 = (int64_t)blockIdx.z * k_chunk;
  const int64_t kend = K < k0 + k_chunk ? K : k0 + k_chunk;
  const int64_t tiles = kend > k0 ? (kend - k0 + BK - 1) / BK : 0;

  uint4 ra[A_PER], rb[B_PER];
  auto load = [&](int64_t kt) {
    const int64_t kb = k0 + kt * BK;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = t + i * THREADS;
      ra[i] = zero4();
      if (c < A_CHUNKS) ra[i] = a.load8(m0 + (c % (BM / 8)) * 8, kb + c / (BM / 8), kend);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = t + i * THREADS;
      rb[i] = zero4();
      if (c < B_CHUNKS) rb[i] = b.load8(n0 + (c % (BN / 8)) * 8, kb + c / (BN / 8), kend);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = t + i * THREADS;
      if (c >= A_CHUNKS) continue;
      const int r = (c % (BM / 8)) * 8, kk = c / (BM / 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) as[(r + j) * LDS + kk] = half_of(ra[i], j);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = t + i * THREADS;
      if (c >= B_CHUNKS) continue;
      const int r = (c % (BN / 8)) * 8, kk = c / (BN / 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) bs[(r + j) * LDS + kk] = half_of(rb[i], j);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (tiles > 0) {
    load(0);
    store();
  }
  __syncthreads();
  for (int64_t kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) load(kt + 1);  // in flight while the tensor cores work
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const uint16_t* p = &as[(wm * WTM + i * 16 + gid) * LDS + ks + tig * 2];
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const uint16_t* p = &bs[(wn * WTN + j * 8 + gid) * LDS + ks + tig * 2];
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          float d[4];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
              "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
              : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(bfr[j][0]), "r"(bfr[j][1]), "f"(0.f));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], d[e]);
        }
    }
    __syncthreads();
    if (kt + 1 < tiles) {
      store();
      __syncthreads();
    }
  }

  // c0, c1 at (gid, 2 tig .. 2 tig + 1), c2, c3 eight rows down
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * WTM + i * 16 + gid + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WTN + j * 8 + tig * 2 + e;
          if (n >= N) continue;
          const float v = acc[i][j][2 * h + e];
          if (ws)
            ws[(int64_t)blockIdx.z * M * N + m * N + n] = v;
          else
            y[m * N + n] = to_bf16(v);
        }
    }
}

// out[i] = bf16(sum over z of part[z * mn + i]), in split order
__global__ void splitk_sum_bf16(const float* __restrict__ part, uint16_t* __restrict__ out,
                                int64_t mn, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s = __fadd_rn(s, part[(int64_t)z * mn + i]);
    out[i] = to_bf16(s);
  }
}

// ceil(ceil(K / splits) / KSTEP) * KSTEP
inline int64_t k_chunk_for(int64_t K, int splits) {
  const int64_t c = (K + splits - 1) / splits;
  return (c + KSTEP - 1) / KSTEP * KSTEP;
}

// An (M, N) GEMM on BM x BN tiles into y (row-major), or, with splits >
// 1, into ws (splits * M * N floats) followed by splitk_sum_bf16 into y.
// Returns cudaGetLastError().
template <int BM, class AL, class BL>
int launch(const AL& a, const BL& b, uint16_t* y, float* ws, int64_t M, int N, int64_t K,
           int splits, cudaStream_t s) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || splits > 65535 || (splits > 1 && !ws) || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  gemm_kernel<BM, AL, BL><<<grid, THREADS, 0, s>>>(a, b, y, splits > 1 ? ws : nullptr, M, N, K,
                                                   k_chunk_for(K, splits));
  if (splits > 1) {
    const int64_t mn = M * N;
    int64_t blocks = (mn + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    splitk_sum_bf16<<<(unsigned)blocks, 256, 0, s>>>(ws, y, mn, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace bfg
}  // namespace
