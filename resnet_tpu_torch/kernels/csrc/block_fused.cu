// K10, the whole-block kernel, fp32 in, out and accumulator.
//
// Replaces resnet_tpu/kernels/block_fused.py::_block_kernel (public function
// block_fused): one stride-1 bottleneck with an identity shortcut, x (N, H,
// W, 4C), in four stage-major passes, because BN statistics are a reduction
// over the whole batch:
//
//   stage 0: r = x @ W1                                      + [sum r, sum r^2]
//   stage 1: u = clip(relu(r * sc_r + sh_r)); s = conv3x3(u, W2), pad 1
//                                                            + [sum s, sum s^2]
//   stage 2: v = clip(relu(s * sc_s + sh_s)); e = v @ W3     + [sum e, sum e^2]
//   stage 3: out = clip(relu(e * sc_e + sh_e + x))
//
// with each (sc, sh) from the completed sums over m = N * H * W rows:
// mean = sum / m, var = max(sum sq / m - mean^2, 0), sc = gamma * rsqrt(var
// + eps), sh = beta - sc * mean.
//
// The TPU kernel runs the four stages as emit_pipeline loops inside one
// pallas_call, carrying the sums in VMEM from one stage to the next. Blocks
// of a CUDA grid cannot wait for each other, so here each stage is its own
// launch, all enqueued by ONE host call (rt_block_fused_f32) on the caller's
// stream, with no host synchronisation and no PyTorch op between them:
// stages 0-2 are the fused conv of K8 (fused_conv.cuh: the implicit GEMM with
// the prologue applied to the gathered slice and the per-tile statistics),
// stage 3 the join of K9 with an identity residual, and between the stages a
// small kernel, one thread per channel, turns the sums, gamma and beta into
// the next prologue's (sc, sh) rows on the device. Those six rows are an
// output: the backward recomputes each ReLU gate from r * sc_r + sh_r and s * sc_s + sh_s, and a
// gate rebuilt from other rows would flip for an element within rounding of
// 0. Every product and sum of the prologues, the rows and the join is rounded
// on its own, as the plain PyTorch version rounds it.
//
// Not carried over, all of them Mosaic's answers to VMEM and lane tiling: the
// batch tiling (_pick_nb), r's sublane padding of W, the VMEM conv scratch,
// and the zero padding of C to 128 lanes (_pad_interior): the GEMM core masks
// any ragged width, so C = 64 runs as it is.
//
// Bound on the H100: 2 * M * (2 * 4C * C + 9 * C^2) FLOPs, done as three
// TF32 products each on the tensor cores, against 96 * C * M bytes (x read
// twice, r, s, e written and read once, out written once); at batch 32 each
// ResNet-50 block is 14 GFLOP, 0.085 ms at 495 TFLOP/s for the three
// products, and 0.11 ms for the bytes. The GEMMs are K8's (fused_conv.cuh:
// the split-TF32 core of tc_gemm.cuh with the prologue in shared memory and
// the statistics in the epilogue). One persistent cooperative launch with a
// grid-wide barrier between the stages and the join folded into stage 2's
// epilogue are later work.

#include "fused_conv.cuh"

namespace {

// (scale, shift) of BN from sums (2, C) over m rows, per channel
__global__ void bn_affine_rows(const float* __restrict__ sums, const float* __restrict__ gamma,
                               const float* __restrict__ beta, float* __restrict__ scale,
                               float* __restrict__ shift, int C, float m, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float mean = __fdiv_rn(sums[c], m);
  float var = __fsub_rn(__fdiv_rn(sums[C + c], m), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // a NaN propagates, as clamp_min does
  const float sc = __fmul_rn(gamma[c], rsqrtf(__fadd_rn(var, eps)));
  scale[c] = sc;
  shift[c] = __fsub_rn(beta[c], __fmul_rn(sc, mean));
}

inline void affine_rows(const float* sums, const float* gamma, const float* beta, float* scale,
                        float* shift, int C, float m, float eps, cudaStream_t s) {
  bn_affine_rows<<<(unsigned)((C + 127) / 128), 128, 0, s>>>(sums, gamma, beta, scale, shift,
                                                             C, m, eps);
}

}  // namespace

// One bottleneck block: x (N, H, W, C4) NHWC, w1 (C4, C), w2 (3, 3, C, C)
// HWIO, w3 (C, C4); g1, b1, g2, b2 hold C floats, g3, b3 C4. Writes out and e
// (N, H, W, C4), r and s (N, H, W, C), sums_r and sums_s (2, C), sums_e (2,
// C4), and rows = [sc_r, sh_r, sc_s, sh_s] (C each) then [sc_e, sh_e] (C4
// each). part holds ceil(M / 128) * 2 * max(C, C4) floats (M = N * H * W); ws
// holds the largest splits_i * M * Cout_i floats over the stages whose
// splits_i > 1 (stage Cout: C, C, C4), else it is not read. The caller
// checks shapes, dtype and contiguity.
extern "C" int rt_block_fused_f32(const float* x, const float* w1, const float* w2,
                                  const float* w3, const float* g1, const float* b1,
                                  const float* g2, const float* b2, const float* g3,
                                  const float* b3, float* out, float* r, float* s, float* e,
                                  float* sums_r, float* sums_s, float* sums_e, float* rows,
                                  float* part, float* ws, int N, int H, int W, int C4, int C,
                                  float eps, int has_cap, float cap, int splits0, int splits1,
                                  int splits2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Act act{true, has_cap != 0, cap};
  const float m = (float)((int64_t)N * H * W);
  float* sc_r = rows;
  float* sh_r = rows + C;
  float* sc_s = rows + 2 * C;
  float* sh_s = rows + 3 * C;
  float* sc_e = rows + 4 * C;
  float* sh_e = rows + 4 * C + C4;
  int status;

  // stage 0: the 1x1 reduce, no prologue
  status = fused_conv_stats(
      conv_loader(x, nullptr, nullptr, N, H, W, C4, 1, 1, 0, 0, H, W, false, act), w1, r, part,
      sums_r, C, ws, splits0, st);
  if (status != 0) return status;
  affine_rows(sums_r, g1, b1, sc_r, sh_r, C, m, eps, st);

  // stage 1: bn_r's affine and ReLU in the gather, the 3x3 with padding 1
  status = fused_conv_stats(
      conv_loader(r, sc_r, sh_r, N, H, W, C, 3, 1, 1, 1, H, W, true, act), w2, s, part,
      sums_s, C, ws, splits1, st);
  if (status != 0) return status;
  affine_rows(sums_s, g2, b2, sc_s, sh_s, C, m, eps, st);

  // stage 2: bn_s's affine and ReLU in the gather, the 1x1 expand
  status = fused_conv_stats(
      conv_loader(s, sc_s, sh_s, N, H, W, C, 1, 1, 0, 0, H, W, true, act), w3, e, part, sums_e,
      C4, ws, splits2, st);
  if (status != 0) return status;
  affine_rows(sums_e, g3, b3, sc_e, sh_e, C4, m, eps, st);

  // stage 3: bn_e's affine, the identity residual, ReLU and the cap
  return launch_join(e, x, out, (int64_t)N * H * W * C4, C4, JoinIdentity{sc_e, sh_e, act}, st);
}
