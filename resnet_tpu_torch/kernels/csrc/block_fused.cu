// K10, the whole-block kernel, fp32 in, out and accumulator.
//
// Replaces resnet_tpu/kernels/block_fused.py:60 _block_kernel (its
// pallas_call at :289, public function block_fused at :393): one stride-1
// bottleneck with an identity shortcut, x (N, H, W, 4C), in four
// stage-major passes, because BN statistics are a reduction over the whole
// batch:
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
//
//   1. split_tf32_kmajor (wg_gemm.cuh), one launch for the three weights:
//      each (K, Cout) row-major weight becomes its K-major split
//      [2][Cout][kp], tf32 hi and lo (cvt.rna), the B operand of wgmma;
//   2. per stage 0-2, the GEMM on wg_gemm.cuh's wgmma core: A gathered by
//      im2col.cuh's loader with the prologue (the previous BN's affine and
//      ReLU, applied by each copying thread to the elements it copied, a
//      halo tap left at exactly 0), B by TMA, the per-128-row-tile
//      statistics from the accumulators in its epilogue (or, when K splits,
//      splitk_sum and a column pass over the summed y); then one small
//      kernel adds the tile partials per channel in double, in a fixed
//      order, and turns the sums, gamma and beta into the next prologue's
//      (sc, sh) rows on the device;
//   3. stage 3, the join of K9 with an identity residual.
//
// Those six rows are an output: the backward recomputes each ReLU gate from
// r * sc_r + sh_r and s * sc_s + sh_s, and a gate rebuilt from other rows
// would flip for an element within rounding of 0. Every product and sum of
// the prologues, the rows and the join is rounded on its own, as the plain
// PyTorch version rounds it. No atomics: a run repeats bit for bit.
//
// The join cannot ride stage 2's epilogue: it needs (sc_e, sh_e), which
// come from sum e and sum e^2 over all M rows, so no tile of e can be joined
// before every tile of stage 2 is done (and at stage 1 e is 103 MB at batch
// 32, more than the 50 MB L2). It stays a pass after the stage.
//
// Not carried over, all of them Mosaic's answers to VMEM and lane tiling: the
// batch tiling (_pick_nb), r's sublane padding of W, the VMEM conv scratch,
// and the zero padding of C to 128 lanes (_pad_interior): the GEMM core masks
// any ragged width (TMA zero-fills B past Cout and K), so C = 64 runs as it
// is.
//
// Bound on the H100 (at batch 32, the same FLOPs at every ResNet-50 stage):
// 2 * M * (2 * 4C * C + 9 * C^2) = 14 GFLOP per block, done as three TF32
// products on the tensor cores: 0.085 ms at 495 TFLOP/s. The stages read
// and write 96 * C * M bytes (x read twice, r, s, e written and read once,
// out written once): 0.184 ms at 3.35 TB/s at stage 1 (C = 64, M = 100,352),
// 0.092 at stage 2, 0.046 at stage 3, 0.023 at stage 4. So stage 1 is bound
// by bytes and stages 2-4 by operations. What the design does about it:
// * operations: wgmma's 128 x 64 or 128 x 128 tiles reuse each A fragment
//   over the whole tile width and read B straight from shared memory, and
//   the B split is done once per call instead of per block and K-step;
// * bytes: the prologues and the statistics ride the GEMMs' reads and
//   writes, so r, s and e are each written once and read once; the 64-wide
//   tiles of stage 1 (Cout = 64) keep two blocks resident per SM;
// * few tiles (stage 4: 13 row tiles at M = 1,568): K splits planned by
//   build.wg_split in waves of resident blocks.

#include "fused_conv.cuh"
#include "wg_gemm.cuh"

namespace {

// the per-stage GEMM: y = A(a) @ B from its split bs [2][N][kp], with the
// per-tile statistics into tile_sums when not nullptr
template <int BN, int VEC>
__global__ void __launch_bounds__(rt::wg::THREADS, rt::wg::Tile<BN>::MIN_BLOCKS)
block_gemm_kernel(const __grid_constant__ CUtensorMap bmap, const FusedConvTcA a,
                  float* __restrict__ y, float* __restrict__ ws, int N, int64_t k_chunk,
                  int splits, float* __restrict__ tile_sums) {
  rt::wg::gemm<BN, VEC, true>(&bmap, a, y, ws, a.M, N, (int64_t)a.ksize * a.ksize * a.Cin,
                              k_chunk, splits, tile_sums);
}

template <int BN, int VEC>
inline int launch_block_gemm(const FusedConvTcA& a, const float* bs, int64_t kp, float* y,
                             float* part, int N, float* ws, int splits, cudaStream_t s) {
  const int64_t K = (int64_t)a.ksize * a.ksize * a.Cin;
  CUtensorMap map;
  const int status = rt::wg::weight_map(&map, bs, K, N, kp, BN);
  if (status != 0) return status;
  auto* kernel = block_gemm_kernel<BN, VEC>;
  return rt::wg::launch<BN>(
      kernel,
      [&](dim3 grid, int smem, int64_t kc) {
        kernel<<<grid, rt::wg::THREADS, smem, s>>>(map, a, y, ws, N, kc, splits, part);
      },
      y, ws, a.M, N, K, splits, s);
}

// sums (2, C) from the tile partials (tile_sums), then BN's (scale, shift)
// rows from those fp32 sums over m rows, per channel
__global__ void __launch_bounds__(CT * FL)
tile_sums_affine(const float* __restrict__ part, float* __restrict__ sums,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ scale, float* __restrict__ shift, int C, int64_t m_tiles,
                 float m, float eps) {
  float s0, s1;
  if (!tile_sums(part, C, m_tiles, s0, s1)) return;
  const int c = blockIdx.x * CT + threadIdx.x;
  sums[c] = s0;
  sums[C + c] = s1;
  const float mean = __fdiv_rn(s0, m);
  float var = __fsub_rn(__fdiv_rn(s1, m), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // a NaN propagates, as clamp_min does
  const float sc = __fmul_rn(gamma[c], rsqrtf(__fadd_rn(var, eps)));
  scale[c] = sc;
  shift[c] = __fsub_rn(beta[c], __fmul_rn(sc, mean));
}

// One stage: y (M, N) of the conv gathered by `a` with the split weight bs,
// its sums (2, N) and the (scale, shift) rows of the BN that follows. part
// holds m_tiles * 2 * N floats, ws splits * M * N when splits > 1. Tiles
// 128 x 64 where N <= 64, else 128 x 128 (build.py wg_tile_n).
inline int stage(const FusedConvTcA& a, const float* bs, int64_t kp, float* y, float* part,
                 float* sums, const float* gamma, const float* beta, float* scale,
                 float* shift, int N, float* ws, int splits, float m, float eps,
                 cudaStream_t s) {
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  const bool vec = a.Cin % 4 == 0 && (uintptr_t)a.x % 16 == 0 &&
                   (!a.prologue || ((uintptr_t)a.scale | (uintptr_t)a.shift) % 16 == 0);
  auto* gemm = N <= 64 ? (vec ? launch_block_gemm<64, 4> : launch_block_gemm<64, 1>)
                       : (vec ? launch_block_gemm<128, 4> : launch_block_gemm<128, 1>);
  const int status = gemm(a, bs, kp, y, part, N, ws, splits, s);
  if (status != 0) return status;
  const unsigned ct = (unsigned)((N + CT - 1) / CT);
  if (splits > 1)
    column_partials<<<dim3(ct, (unsigned)m_tiles), dim3(CT, RT), 0, s>>>(y, part, a.M, N);
  tile_sums_affine<<<ct, dim3(CT, FL), 0, s>>>(part, sums, gamma, beta, scale, shift, N,
                                               m_tiles, m, eps);
  return (int)cudaGetLastError();
}

// the split's row stride: K rounded up to a multiple of 4 floats (TMA takes
// 16-byte row strides)
inline int kmajor_ld(int K) { return (K + 3) / 4 * 4; }

}  // namespace

// bs [2][N][kp] = the K-major tf32 split of b (K, N) row-major, kp = K
// rounded up to a multiple of 4, zeros past K (split_tf32_kmajor).
extern "C" int rt_split_tf32_f32(const float* b, float* bs, int K, int N, void* stream) {
  rt::wg::SplitJobs jobs{};
  jobs.job[0] = rt::wg::SplitJob{b, bs, K, N, kmajor_ld(K)};
  return rt::wg::launch_split(jobs, 1, (cudaStream_t)stream);
}

// One bottleneck block: x (N, H, W, C4) NHWC, w1 (C4, C), w2 (3, 3, C, C)
// HWIO, w3 (C, C4); g1, b1, g2, b2 hold C floats, g3, b3 C4. Writes out and e
// (N, H, W, C4), r and s (N, H, W, C), sums_r and sums_s (2, C), sums_e (2,
// C4), and rows = [sc_r, sh_r, sc_s, sh_s] (C each) then [sc_e, sh_e] (C4
// each). part holds ceil(M / 128) * 2 * max(C, C4) floats (M = N * H * W); ws
// holds the largest splits_i * M * Cout_i floats over the stages whose
// splits_i > 1 (stage Cout: C, C, C4), else it is not read; wsplit holds the
// three weights' splits, 2 * (C * kp(C4) + C * kp(9 C) + C4 * kp(C)) floats
// (kp: rounded up to a multiple of 4). The caller checks shapes, dtype and
// contiguity.
extern "C" int rt_block_fused_f32(const float* x, const float* w1, const float* w2,
                                  const float* w3, const float* g1, const float* b1,
                                  const float* g2, const float* b2, const float* g3,
                                  const float* b3, float* out, float* r, float* s, float* e,
                                  float* sums_r, float* sums_s, float* sums_e, float* rows,
                                  float* part, float* ws, float* wsplit, int N, int H, int W,
                                  int C4, int C, float eps, int has_cap, float cap,
                                  int splits0, int splits1, int splits2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Act act{true, has_cap != 0, cap};
  const float m = (float)((int64_t)N * H * W);
  float* sc_r = rows;
  float* sh_r = rows + C;
  float* sc_s = rows + 2 * C;
  float* sh_s = rows + 3 * C;
  float* sc_e = rows + 4 * C;
  float* sh_e = rows + 4 * C + C4;
  const int kp1 = kmajor_ld(C4), kp2 = kmajor_ld(9 * C), kp3 = kmajor_ld(C);
  float* w1s = wsplit;
  float* w2s = w1s + 2 * (int64_t)C * kp1;
  float* w3s = w2s + 2 * (int64_t)C * kp2;
  rt::wg::SplitJobs jobs{};
  jobs.job[0] = rt::wg::SplitJob{w1, w1s, C4, C, kp1};
  jobs.job[1] = rt::wg::SplitJob{w2, w2s, 9 * C, C, kp2};
  jobs.job[2] = rt::wg::SplitJob{w3, w3s, C, C4, kp3};
  int status = rt::wg::launch_split(jobs, 3, st);
  if (status != 0) return status;

  // stage 0: the 1x1 reduce, no prologue
  status = stage(conv_loader(x, nullptr, nullptr, N, H, W, C4, 1, 1, 0, 0, H, W, false, act),
                 w1s, kp1, r, part, sums_r, g1, b1, sc_r, sh_r, C, ws, splits0, m, eps, st);
  if (status != 0) return status;

  // stage 1: bn_r's affine and ReLU in the gather, the 3x3 with padding 1
  status = stage(conv_loader(r, sc_r, sh_r, N, H, W, C, 3, 1, 1, 1, H, W, true, act), w2s, kp2,
                 s, part, sums_s, g2, b2, sc_s, sh_s, C, ws, splits1, m, eps, st);
  if (status != 0) return status;

  // stage 2: bn_s's affine and ReLU in the gather, the 1x1 expand
  status = stage(conv_loader(s, sc_s, sh_s, N, H, W, C, 1, 1, 0, 0, H, W, true, act), w3s, kp3,
                 e, part, sums_e, g3, b3, sc_e, sh_e, C4, ws, splits2, m, eps, st);
  if (status != 0) return status;

  // stage 3: bn_e's affine, the identity residual, ReLU and the cap
  return launch_join(e, x, out, (int64_t)N * H * W * C4, C4, JoinIdentity{sc_e, sh_e, act}, st);
}
