// The fused engine's conv and residual join: fp32 in, out and accumulator,
// or bf16 in and out with an fp32 accumulator (the bf16 section below).
//
// K8 replaces resnet_tpu/kernels/fused_conv.py::_fused_conv_kernel (public
// function fused_conv):
//
//   y    = conv(u, w),  u = clip(relu(x * scale[ci] + shift[ci]))  (prologue)
//   sums = [sum y, sum y^2] per output channel                     (epilogue)
//
// The previous layer's BN affine and ReLU ride the conv's input read and
// this layer's BN statistics its output write, so neither makes a pass of
// its own over device memory. Here the conv is the implicit GEMM of the
// conv on the split-TF32 tensor-core core (tc_gemm.cuh, K-major A) with the
// loader FusedConvTcA, whose prologue each thread applies in shared memory
// to the elements it copied once they land (cp.async cannot transform them
// on the way). Taps outside the image stay exactly 0 -- the halo mask of
// fused_conv.py:68-75: relu(shift) must never enter the padding. The window
// origin is the explicit padding (pad_top, pad_left), so the reference's
// centred windows (ops/padding.py) and any explicit padding take one path,
// and stride 2 gathers directly: the TPU kernel's phase-plane rewrite
// (fused_conv.py:248-315) exists only because Mosaic cannot slice a strided
// window, and is not carried over.
//
// Statistics without a sequential grid: the TPU kernel carries [sum y,
// sum y^2] in VMEM across its image-batch grid axis. Here each 128-row M
// tile writes its per-channel partials to a workspace (m_tiles, 2, Cout) in
// the GEMM epilogue (tc_gemm.cuh kStats), and a second kernel adds them
// per channel in double, in a fixed order. When the GEMM splits K (small M,
// build.tc_split), its tiles hold partials, so the statistics are taken
// from the summed y instead: a column pass over y writes the same
// workspace. No atomics, so a run repeats exactly.
//
// K9 replaces ::_join_kernel (public function fused_join):
//   out = clip(relu(e * se[c] + te[c] + r * sr[c] + tr[c])),
// one elementwise pass, rounded step by step as the plain PyTorch version
// is: where C is a multiple of a 16-byte vector's elements and every
// pointer is 16-byte aligned, each thread keeps one channel group's four
// rows in registers and streams 16-byte vectors of e and r, four of each in
// flight (fused_conv.cuh join_group); element by element otherwise.
//
// Bound on the H100: K8 is compute-bound like the plain conv (2 * k*k*Cin
// FLOPs per output element, 576 to 9,216 deep in ResNet-50's fused convs),
// done as three TF32 products per fp32 product on the tensor cores
// (tc_gemm.cuh); the prologue adds 2 FLOPs per gathered element and the
// statistics 2 per output, both under 2% of the GEMM. K9 is bound by device
// memory (8 bytes read, 4 written per element). wgmma/TMA tiling and
// folding K9 into the expand conv's epilogue are later work.
//
// bf16 (rt_fused_conv_bf16, rt_fused_join_bf16): what the Pallas kernels
// compute for bf16 inputs. K8: the prologue on the upcast input in fp32,
// rounded to bf16 before the dot (fused_conv.py:61-76), the weight cast to
// x's dtype by the wrapper (:215), bf16 products into an fp32 accumulator,
// y rounded once (:108), [sum y, sum y^2] from the fp32 accumulator, not
// from the rounded y (:109-110); on wgb_gemm.cuh's wgmma + TMA core
// (fused_conv.cuh fused_conv_wg_kernel: the weight by TMA as it lies, the
// gather by cp.async with the prologue applied in place, the statistics
// epilogue from the fp32 accumulators). When K splits, the statistics come from the fp32 split sum before its rounding
// (splitk_sum_stats_bf16): a column pass over the rounded y would give the
// statistics of the torch-ops chain, not K8's. K9: e and r upcast, fp32
// arithmetic, one rounding (:506-513). Bound: K8 by operations at 989
// TFLOP/s dense bf16, K9 by bytes (4 read, 2 written per element).
//
// K8's GEMM kernels are here; the gather, the statistics passes and the
// join live in fused_conv.cuh, shared with K10 (csrc/block_fused.cu).
// Measured (-Xptxas -v, nvcc 12.9, sm_90a): fused_conv_tc128_kernel and
// fused_conv_tc64_kernel in PERF.md.

#include "fused_conv.cuh"

namespace {

// as conv.cu's tc kernels: the 128 x 64 tile capped at 128 registers, two
// blocks per SM; the 128 x 128 tile one block
template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS, 2)
fused_conv_tc64_kernel(const FusedConvTcA a, const float* __restrict__ w,
                       float* __restrict__ y, int Cout, int64_t k_chunk,
                       float* __restrict__ tile_sums) {
  rt::tc::gemm_k<64, VEC, true>(a, w, Cout, y, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin,
                                k_chunk, tile_sums);
}

template <int VEC>
__global__ void __launch_bounds__(rt::tc::THREADS)
fused_conv_tc128_kernel(const FusedConvTcA a, const float* __restrict__ w,
                        float* __restrict__ y, int Cout, int64_t k_chunk,
                        float* __restrict__ tile_sums) {
  rt::tc::gemm_k<128, VEC, true>(a, w, Cout, y, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin,
                                 k_chunk, tile_sums);
}

template <int BN, int VEC>
inline int launch_fused_gemm(const FusedConvTcA& a, const float* w, float* y, float* part,
                             int Cout, float* ws, int splits, cudaStream_t s) {
  auto* kernel = fused_conv_tc128_kernel<VEC>;
  if constexpr (BN == 64) kernel = fused_conv_tc64_kernel<VEC>;
  return rt::tc::launch<BN, FusedConvTcA>(
      kernel,
      [&](dim3 grid, int smem, float* out, int64_t kc) {
        kernel<<<grid, rt::tc::THREADS, smem, s>>>(a, w, out, Cout, kc,
                                                   splits == 1 ? part : nullptr);
      },
      y, ws, a.M, Cout, (int64_t)a.ksize * a.ksize * a.Cin, splits, s);
}

// y (M, Cout) and its sums (2, Cout) of the conv gathered by `a` with w
// (k * k * Cin, Cout): the GEMM, then the statistics. part holds m_tiles * 2
// * Cout floats (m_tiles = ceil(M / TILE_M)); ws holds splits * M * Cout
// floats when splits > 1. Tiles 128 x 64 where Cout <= 64, else 128 x 128
// (build.py tc_tile_n). Enqueued on s; returns the launch status.
inline int fused_conv_stats(const FusedConvTcA& a, const float* w, float* y, float* part,
                            float* sums, int Cout, float* ws, int splits, cudaStream_t s) {
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  const bool vec = a.Cin % 4 == 0 && Cout % 4 == 0 && (uintptr_t)a.x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  auto* gemm = Cout <= 64 ? (vec ? launch_fused_gemm<64, 4> : launch_fused_gemm<64, 1>)
                          : (vec ? launch_fused_gemm<128, 4> : launch_fused_gemm<128, 1>);
  const int status = gemm(a, w, y, part, Cout, ws, splits, s);
  if (status != 0) return status;
  const unsigned ct = (unsigned)((Cout + CT - 1) / CT);
  if (splits > 1)
    column_partials<<<dim3(ct, (unsigned)m_tiles), dim3(CT, RT), 0, s>>>(y, part, a.M, Cout);
  tile_sums_final<<<ct, dim3(CT, FL), 0, s>>>(part, sums, Cout, m_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// y (N, Ho, Wo, Cout) and sums (2, Cout) of the fused conv of x (N, H, W,
// Cin) with w (k, k, Cin, Cout): window (oy, ox) starts at input row
// stride * oy - pad_top, column stride * ox - pad_left. With prologue, scale
// and shift hold Cin floats; without, they are not read. part holds
// m_tiles * 2 * Cout floats (m_tiles = ceil(N * Ho * Wo / 128)); ws holds
// splits * N * Ho * Wo * Cout floats when splits > 1. The caller checks
// shapes, dtype and contiguity.
extern "C" int rt_fused_conv_f32(const float* x, const float* w, const float* scale,
                                 const float* shift, float* y, float* part, float* sums,
                                 int N, int H, int W, int Cin, int Cout, int k, int stride,
                                 int pad_top, int pad_left, int Ho, int Wo, int prologue,
                                 int relu, int has_cap, float cap, float* ws, int splits,
                                 void* stream) {
  const FusedConvTcA a = conv_loader(x, scale, shift, N, H, W, Cin, k, stride, pad_top, pad_left,
                                   Ho, Wo, prologue != 0, Act{relu != 0, has_cap != 0, cap});
  return fused_conv_stats(a, w, y, part, sums, Cout, ws, splits, (cudaStream_t)stream);
}

// out = clip(relu(e * se + te + r * sr + tr)) over n elements of (n / C, C)
// views; se, te, sr and tr hold C floats.
extern "C" int rt_fused_join_f32(const float* e, const float* r, const float* se,
                                 const float* te, const float* sr, const float* tr, float* o,
                                 int64_t n, int C, int has_cap, float cap, void* stream) {
  return launch_join(e, r, o, n, C, JoinRows{{se, te, sr, tr}, Act{true, has_cap != 0, cap}},
                     (cudaStream_t)stream);
}

// ---------------------------------------------------------------- bf16

// The bf16 fused conv: x (N, H, W, Cin) and w (k, k, Cin, Cout) bf16, scale
// and shift Cin floats, y (N, Ho, Wo, Cout) bf16, sums (2, Cout) fp32; part,
// ws and the window as rt_fused_conv_f32's.
extern "C" int rt_fused_conv_bf16(const uint16_t* x, const uint16_t* w, const float* scale,
                                  const float* shift, uint16_t* y, float* part, float* sums,
                                  int N, int H, int W, int Cin, int Cout, int k, int stride,
                                  int pad_top, int pad_left, int Ho, int Wo, int prologue,
                                  int relu, int has_cap, float cap, float* ws, int splits,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const FusedConvBfA a =
      conv_loader_bf16(x, scale, shift, N, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo,
                       prologue != 0, Act{relu != 0, has_cap != 0, cap});
  const int status = fused_gemm_bf16(a, w, y, part, Cout, ws, splits, s);
  if (status != 0) return status;
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  tile_sums_final<<<(unsigned)((Cout + CT - 1) / CT), dim3(CT, FL), 0, s>>>(part, sums, Cout,
                                                                           m_tiles);
  return (int)cudaGetLastError();
}

// out = bf16(clip(relu(e * se + te + r * sr + tr))) over n bf16 elements of
// (n / C, C) views, in fp32; se, te, sr and tr hold C floats.
extern "C" int rt_fused_join_bf16(const __nv_bfloat16* e, const __nv_bfloat16* r,
                                  const float* se, const float* te, const float* sr,
                                  const float* tr, __nv_bfloat16* o, int64_t n, int C,
                                  int has_cap, float cap, void* stream) {
  return launch_join(e, r, o, n, C, JoinRows{{se, te, sr, tr}, Act{true, has_cap != 0, cap}},
                     (cudaStream_t)stream);
}
