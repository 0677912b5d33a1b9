// The int8 (W8A8) serving kernels of quantize.py, neither of which has a
// Pallas counterpart: JAX leaves both to XLA.
//
// Q1, rt_qconv_s8: an int8 NHWC conv (or the FC, as a 1x1 conv over a
// (N, 1, 1, K) view) with int32 accumulation and its dequantizing epilogue.
// Replaces resnet_tpu/quantize.py::_qconv (:218, XLA's conv_general_dilated
// or dot_general with preferred_element_type int32), the dequantization of
// _qsite (:243-247) and the FC's dot_general and dequantization
// (:279-287). PyTorch has no int8 convolution on CUDA, so the port needs
// this kernel whatever it costs.
//
//   acc[m, co] = sum_k A[m, k] * w[co, k]            (int32, exact)
//   v = __fadd_rn(__fmul_rn(__int2float_rn(acc), dq[co]), bias[co])
//   mode 0: bf16(v); mode 1: clip(relu(bf16(v)), cap); mode 2: v (fp32)
//
// dq = ws * scale is the wrapper's fp32 row, as JAX orders it; the
// multiply and add are written as intrinsics so nvcc cannot contract them
// into an FMA, which would change the bits against the plain version. ReLU
// and the cap act on the bf16 value (quantize.py's _relu after _qsite).
//
// The GEMM is an implicit im2col in the manner of im2col.cuh's Im2colTcA:
// row m is output pixel (n, oy, ox), column k = (di, dj, ci) one tap and
// input channel, A(m, k) = x[n, s*oy - pad_top + di, s*ox - pad_left + dj,
// ci], 0 outside the image, so the reference's centred windows (the
// stem's (3, 2)) and a 1x1/s2 conv (JAX's subsample-then-dot) take one
// path. The weight is (Cout, Kp) K-major, each output channel's K values
// contiguous and zero beyond K up to Kp, a multiple of BK (the `col`
// operand of mma.sync; the wrapper packs it once, quant.pack_weight).
// Integer sums are exact in any order, so the tiling never changes a bit.
//
// Tiles: 128 output pixels x 64 output channels a block, K in 64-byte
// steps through a 3-stage ring in shared memory (rows padded to 80 bytes,
// so each ldmatrix phase reads 8 distinct 16-byte bank groups); 8 warps of
// 32 x 32, each K step two mma.sync.m16n8k32.s8 per (16 x 8) fragment pair.
// Where Cin % 16 == 0 and x is 16-byte aligned a 16-byte chunk of A lies in
// one tap and comes by cp.async (zero-filled outside the image); else (the
// stem, Cin = 3, K = 147 padded to 192) each byte is gathered and stored.
// Bound: at ResNet-50's shapes mostly the int8 tensor-core rate (1,979
// TOP/s dense), which mma.sync from a simple ring reaches only in part;
// wgmma with TMA is later work.
//
// Q2, rt_quant_act_{f32,bf16}: q = clip(rint(__fmul_rn(x, inv)), -127, 127)
// as int8, inv = 1 / scale in fp32 (the wrapper's). Replaces
// resnet_tpu/quantize.py::_quant_act (:213); rintf rounds half to even, as
// jnp.round does. Bound by device memory (4 or 2 bytes read and 1 written
// a value): 16 values a thread through 16-byte loads and one 16-byte
// store where the pointers allow, one value at a time for the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowwise.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;

enum Mode { OUT_BF16 = 0, OUT_BF16_RELU = 1, OUT_F32 = 2 };

struct QConv {
  const int8_t* x;
  const int8_t* w;
  const float* dq;
  const float* bias;  // null: no bias (the FC without one)
  void* out;
  int64_t M;
  int H, W, Cin, Cout, KW, stride, pad_top, pad_left, HoWo, Wo, K, Kp;
  int mode, has_cap;
  float cap;
};

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(const QConv& p, int acc, int co) {
  const float v = __fmul_rn(__int2float_rn(acc), p.dq[co]);
  return p.bias ? __fadd_rn(v, p.bias[co]) : v;
}

// the bf16 bits of v, then ReLU and the cap on the bf16 value (mode 1)
__device__ __forceinline__ uint16_t to_act(const QConv& p, float v, float capf) {
  float f = __bfloat162float(__float2bfloat16_rn(v));
  if (p.mode == OUT_BF16_RELU) {
    if (f < 0.f) f = 0.f;
    if (p.has_cap && f > capf) f = capf;
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));  // exact: f is a bf16 value
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS) qconv_kernel(const QConv p) {
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // each thread copies 16-byte chunk `chunk` of A's rows arow and arow + 64
  // and of B's row arow in every K step
  const int chunk = tid & 3, arow = tid >> 2;

  int64_t aoff[2];
  int aiy[2], aix[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + arow + 64 * i;
    aok[i] = m < p.M;
    const int64_t mm = aok[i] ? m : 0;
    const int64_t n = mm / p.HoWo;
    const int rem = (int)(mm - n * p.HoWo);
    const int oy = rem / p.Wo;
    aiy[i] = p.stride * oy - p.pad_top;
    aix[i] = p.stride * (rem - oy * p.Wo) - p.pad_left;
    aoff[i] = n * p.H * p.W * (int64_t)p.Cin;
  }
  const bool bok = n0 + arow < p.Cout;
  const int8_t* brow = p.w + (int64_t)(bok ? n0 + arow : 0) * p.Kp + chunk * 16;

  auto load = [&](int slot, int kt) {
    int8_t* a = As[slot];
    const int k = kt * BK + chunk * 16;
    const int tap = k / p.Cin;
    const int ci0 = k - tap * p.Cin;
    const int di0 = tap / p.KW, dj0 = tap - di0 * p.KW;
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int iy = aiy[i] + di0, ix = aix[i] + dj0;
        const bool ok = aok[i] && k < p.K && (unsigned)iy < (unsigned)p.H &&
                        (unsigned)ix < (unsigned)p.W;
        const int8_t* src = ok ? p.x + aoff[i] + ((int64_t)iy * p.W + ix) * p.Cin + ci0 : p.x;
        cp16(a + (arow + 64 * i) * LDS + chunk * 16, src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        int ci = ci0, di = di0, dj = dj0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (aok[i] && k + j < p.K) {
            const int iy = aiy[i] + di, ix = aix[i] + dj;
            if ((unsigned)iy < (unsigned)p.H && (unsigned)ix < (unsigned)p.W) {
              const uint32_t v =
                  (uint8_t)p.x[aoff[i] + ((int64_t)iy * p.W + ix) * p.Cin + ci];
              word[j >> 2] |= v << (8 * (j & 3));
            }
            if (++ci == p.Cin) {
              ci = 0;
              if (++dj == p.KW) {
                dj = 0;
                ++di;
              }
            }
          }
        }
        *reinterpret_cast<uint4*>(a + (arow + 64 * i) * LDS + chunk * 16) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    cp16(Bs[slot] + arow * LDS + chunk * 16, bok ? brow + kt * BK : p.w, bok);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = p.Kp / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    // the slot refilled below was read in the previous step by every warp
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next);
    cp_commit();
    const int8_t* a = As[kt % STAGES];
    const int8_t* b = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bq[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], a + (wm * 32 + i * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
      // bq[jj]: b0, b1 of n tile 2 jj, then of n tile 2 jj + 1
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4(bq[jj], b + (wn * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk +
                            ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bq[j >> 1][(j & 1) * 2], bq[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
  const bool pairs = (p.Cout & 1) == 0;  // then a column pair is one aligned store
  const float capf = __bfloat162float(__float2bfloat16_rn(p.cap));
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm * 32 + i * 16 + gid + h * 8;
        const int co = n0 + wn * 32 + j * 8 + tig * 2;
        if (m >= p.M || co >= p.Cout) continue;
        const bool two = co + 1 < p.Cout;
        const float v0 = dequant(p, acc[i][j][2 * h], co);
        const float v1 = two ? dequant(p, acc[i][j][2 * h + 1], co + 1) : 0.f;
        const int64_t at = m * p.Cout + co;
        if (p.mode == OUT_F32) {
          float* o = static_cast<float*>(p.out) + at;
          if (pairs) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            if (two) o[1] = v1;
          }
        } else {
          uint16_t* o = static_cast<uint16_t*>(p.out) + at;
          const uint16_t b0 = to_act(p, v0, capf);
          if (pairs) {
            *reinterpret_cast<uint32_t*>(o) = b0 | ((uint32_t)to_act(p, v1, capf) << 16);
          } else {
            o[0] = b0;
            if (two) o[1] = to_act(p, v1, capf);
          }
        }
      }
}

// ------------------------------------------------------------------ Q2

__device__ __forceinline__ uint32_t quant1(float v, float inv) {
  const float r = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(r);
}

// 16 values a step: 16 / Vec16<T>::N loads of 16 bytes in (four fp32 or
// two bf16), one 16-byte store of int8 out
template <class T>
__global__ void quant_act_vec(const T* __restrict__ x, uint4* __restrict__ q, float inv,
                              int64_t n16) {
  using V = rt::Vec16<T>;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t out[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16 / V::N; ++j) {
      float v[V::N];
      V::load(x + 16 * i + V::N * j, v);
#pragma unroll
      for (int t = 0; t < V::N; ++t) out[(V::N * j + t) / 4] |= quant1(v[t], inv) << 8 * (t % 4);
    }
    q[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

template <class T>
__global__ void quant_act_scalar(const T* __restrict__ x, int8_t* __restrict__ q, float inv,
                                 int64_t begin, int64_t end) {
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
       i += (int64_t)gridDim.x * blockDim.x)
    q[i] = (int8_t)quant1(rt::ld(x + i), inv);
}

// the 16-byte path where x and q are 16-byte aligned, then the tail
template <class T>
int quant_act(const T* x, int8_t* q, float inv, int64_t n, cudaStream_t s) {
  const int64_t n16 = rt::aligned16(x) && rt::aligned16(q) ? n / 16 : 0;
  if (n16 > 0)
    quant_act_vec<T><<<rt::ew_blocks(n16), rt::EW_THREADS, 0, s>>>(x, (uint4*)q, inv, n16);
  if (16 * n16 < n)
    quant_act_scalar<T><<<rt::ew_blocks(n - 16 * n16), rt::EW_THREADS, 0, s>>>(x, q, inv,
                                                                               16 * n16, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Q1. x (N, H, W, Cin) int8; w (Cout, Kp) int8 K-major, Kp a multiple of 64
// and at least K = KH * KW * Cin, zero beyond K; dq and bias (Cout,) fp32,
// bias may be null; out (N, Ho, Wo, Cout) bf16 (mode 0, 1) or fp32 (mode 2).
extern "C" int rt_qconv_s8(const int8_t* x, const int8_t* w, const float* dq,
                           const float* bias, void* out, int N, int H, int W, int Cin,
                           int Cout, int KH, int KW, int stride, int pad_top, int pad_left,
                           int Ho, int Wo, int Kp, int mode, int has_cap, float cap,
                           void* stream) {
  const int K = KH * KW * Cin;
  if (N <= 0 || Ho <= 0 || Wo <= 0 || Cout <= 0 || K <= 0 || Kp < K || Kp % BK != 0 ||
      mode < OUT_BF16 || mode > OUT_F32 || ((uintptr_t)w % 16) != 0 ||
      (Cout + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  QConv p;
  p.x = x;
  p.w = w;
  p.dq = dq;
  p.bias = bias;
  p.out = out;
  p.M = (int64_t)N * Ho * Wo;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.KW = KW;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  p.HoWo = Ho * Wo;
  p.Wo = Wo;
  p.K = K;
  p.Kp = Kp;
  p.mode = mode;
  p.has_cap = has_cap;
  p.cap = cap;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t s = (cudaStream_t)stream;
  if (Cin % 16 == 0 && ((uintptr_t)x % 16) == 0)
    qconv_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    qconv_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Q2 on fp32 (the images) and bf16 (every other site) inputs; q int8, n
// values
extern "C" int rt_quant_act_f32(const float* x, int8_t* q, float inv, int64_t n,
                                void* stream) {
  return quant_act(x, q, inv, n, (cudaStream_t)stream);
}

extern "C" int rt_quant_act_bf16(const uint16_t* x, int8_t* q, float inv, int64_t n,
                                 void* stream) {
  return quant_act(reinterpret_cast<const __nv_bfloat16*>(x), q, inv, n, (cudaStream_t)stream);
}
