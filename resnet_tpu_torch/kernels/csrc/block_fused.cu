// K10, the whole-block kernel: fp32 in, out and accumulator, or bf16 in
// and out with fp32 accumulators (rt_block_fused_bf16, the bf16 section).
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

// bf16 (rt_block_fused_bf16): what _block_fused_fwd_jnp, the kernel's
// mirror, computes for bf16 inputs (block_fused.py:202-254): each stage's
// GEMM takes bf16 operands into an fp32 accumulator, its sums come from
// that fp32 accumulator, and r, s and e are rounded to bf16 once; the
// prologues run on the rounded values in fp32 and round u and v to bf16
// before the next product; the (sc, sh) rows are fp32 (gamma and beta cast
// by the wrapper, as `row` does at :281, :317); the join rounds out once. The
// same one host call on the caller's stream with no host sync: per stage
// one persistent GEMM (block_stage_wg_kernel below) and the rows kernel
// tile_sums_affine, then K9-bf16's body with an identity residual. The
// weights come in bf16 (the wrapper casts fp32 parameters to x's dtype,
// block_fused.py:316), so there is no tf32 split. Bound at batch 32: 14
// GFLOP per block at 989 TFLOP/s dense bf16 is 0.014 ms; the bytes are
// half the fp32 ones above: 0.092 ms at stage 1 (C = 64), 0.046 at stage 2,
// 0.023 at stage 3, all bound by bytes, and 0.0115 at stage 4, bound by
// operations.
//
// The bf16 stage GEMM is K8-bf16's gather (fused_conv.cuh ConvWgBlock: the
// prologue applied in place to the chunks each thread copied, a halo tap
// left at 0; or, for ragged widths and misaligned tensors, both operands
// by 2-byte loads) on wgb_gemm.cuh's specialized loop: one block per SM
// walks the units (m tile, n tile, K split) of the stage, the ring running
// across units, two warpgroups copying and applying the prologue, two
// multiplying and running the epilogues. So the copies and the prologue of
// the slices ahead and a unit's epilogue run beside the products (K8 on
// `mainloop` does them in turn with its products, on one block a tile:
// stage 1's expand has one slice a unit, every slice loaded exposed; the
// same gather on `persistent`, whose one thread stream also does them in
// turn, was slower still). What keeps K8's bits: the units are K8's tiles
// and the K splits build.wgb_split plans for it, a slice's four k16 steps
// chain into one accumulator folded once, y is rounded once from the same
// fp32 sum, and each single-split unit runs K8's statistics epilogue
// (wgb::tile_stats, the same order) on that sum; split units write fp32
// partials that splitk_sum_stats_bf16 adds in split order, as K8's.
// rt_block_gemm_bf16 runs one stage GEMM alone, K8's witness on the card.

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

// BN's (scale, shift) of channel c from its fp32 sums s0, s1 over m rows
__device__ __forceinline__ void affine_row(float s0, float s1, const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           float* __restrict__ scale,
                                           float* __restrict__ shift, int c, float m,
                                           float eps) {
  const float mean = __fdiv_rn(s0, m);
  float var = __fsub_rn(__fdiv_rn(s1, m), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;  // a NaN propagates, as clamp_min does
  const float sc = __fmul_rn(gamma[c], rsqrtf(__fadd_rn(var, eps)));
  scale[c] = sc;
  shift[c] = __fsub_rn(beta[c], __fmul_rn(sc, mean));
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
  affine_row(s0, s1, gamma, beta, scale, shift, c, m, eps);
}

// the rows of tile_sums_affine from sums (2, C) that are complete already
// (summed over the ranks of a statistics group) over *m rows, a device
// scalar (the group's row count)
__global__ void sums_affine(const float* __restrict__ sums, const float* __restrict__ gamma,
                            const float* __restrict__ beta, float* __restrict__ scale,
                            float* __restrict__ shift, int C, const float* __restrict__ m,
                            float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C) affine_row(sums[c], sums[C + c], gamma, beta, scale, shift, c, *m, eps);
}

inline int launch_sums_affine(const float* sums, const float* gamma, const float* beta,
                              float* scale, float* shift, int C, const float* m, float eps,
                              cudaStream_t s) {
  sums_affine<<<(unsigned)((C + 127) / 128), 128, 0, s>>>(sums, gamma, beta, scale, shift, C,
                                                         m, eps);
  return (int)cudaGetLastError();
}

// One stage: y (M, N) of the conv gathered by `a` with the split weight bs,
// its sums (2, N) and the (scale, shift) rows of the BN that follows. part
// holds m_tiles * 2 * N floats, ws splits * M * N when splits > 1. Tiles
// 128 x 64 where N <= 64, else 128 x 128 (build.py wg_tile_n).
// the GEMM of a stage and its tile partials in part (after a K split, from a
// column pass over the summed y)
inline int stage_gemm(const FusedConvTcA& a, const float* bs, int64_t kp, float* y, float* part,
                      int N, float* ws, int splits, cudaStream_t s) {
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  const bool vec = a.Cin % 4 == 0 && (uintptr_t)a.x % 16 == 0 &&
                   (!a.prologue || ((uintptr_t)a.scale | (uintptr_t)a.shift) % 16 == 0);
  auto* gemm = N <= 64 ? (vec ? launch_block_gemm<64, 4> : launch_block_gemm<64, 1>)
                       : (vec ? launch_block_gemm<128, 4> : launch_block_gemm<128, 1>);
  const int status = gemm(a, bs, kp, y, part, N, ws, splits, s);
  if (status != 0) return status;
  if (splits > 1)
    column_partials<<<dim3((unsigned)((N + CT - 1) / CT), (unsigned)m_tiles), dim3(CT, RT), 0,
                      s>>>(y, part, a.M, N);
  return (int)cudaGetLastError();
}

inline int stage(const FusedConvTcA& a, const float* bs, int64_t kp, float* y, float* part,
                 float* sums, const float* gamma, const float* beta, float* scale,
                 float* shift, int N, float* ws, int splits, float m, float eps,
                 cudaStream_t s) {
  const int status = stage_gemm(a, bs, kp, y, part, N, ws, splits, s);
  if (status != 0) return status;
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  tile_sums_affine<<<(unsigned)((N + CT - 1) / CT), dim3(CT, FL), 0, s>>>(
      part, sums, gamma, beta, scale, shift, N, m_tiles, m, eps);
  return (int)cudaGetLastError();
}

// the sums (2, N) of a stage from its tile partials, with no rows: the
// stage entries' end of a stage
inline int stage_sums(const float* part, float* sums, int N, int64_t M, cudaStream_t s) {
  const int64_t m_tiles = (M + TILE_M - 1) / TILE_M;
  tile_sums_final<<<(unsigned)((N + CT - 1) / CT), dim3(CT, FL), 0, s>>>(part, sums, N,
                                                                         m_tiles);
  return (int)cudaGetLastError();
}

static_assert(wgb::COPIERS == wgb::THREADS, "ConvWgBlock lays its copies out for THREADS threads");

// K8-bf16's copies (ConvWgBlock, its fix the prologue in place) as
// wgb::specialized's Block; publish hands the thread's part of a slot over
// at once: an arrival on bar once its cp.async copies land, or, for the
// 2-byte loader, which stores them itself (the prologue applied on the
// way), after a proxy fence
template <int BN, bool kVec>
struct StageCopies : ConvWgBlock<BN, kVec> {
  using ConvWgBlock<BN, kVec>::ConvWgBlock;

  __device__ void publish(uint64_t* bar) const {
    if constexpr (kVec) {
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                       rt::tc::smem_u32(bar))
                   : "memory");
    } else {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wgb::mbar_arrive(bar);
    }
  }
};

// y (M, N) bf16 of the conv gathered by `a` with the weight w (K, N), over
// the units of un on wgb::specialized (one split: y through ymap, or with
// !kVec from the registers, and the unit's tile partials into tile_sums;
// several: split z's fp32 partials at ws + z * M * N); the copiers apply
// the prologue to their cp.async copies (kVec) or as they load (!kVec)
template <int BN, bool kVec>
__global__ void __launch_bounds__(wgb::WS_THREADS, 1)
block_stage_wg_kernel(const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ FusedConvBfA a, const uint16_t* __restrict__ w,
                      uint16_t* __restrict__ y, float* __restrict__ ws, int N,
                      float* __restrict__ tile_sums, const wgb::Units un) {
  constexpr int S = wgb::PTile<BN>::STAGES;
  using C = wgb::Crew<wgb::COPIERS>;
  extern __shared__ __align__(1024) uint8_t stage_wg_smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const wgb::Smem<BN> sm = wgb::psmem_layout<BN, S>(stage_wg_smem);
  wgb::init_ws_barriers<S>(full, empty);
  auto epi = [&](const float (&acc)[wgb::Tile<BN>::NACC], int64_t row0, int col0, int z) {
    if (ws) {
      wgb::store_pairs<BN, wgb::SameRow, C>(acc, row0, col0, a.M, N, nullptr,
                                            ws + (int64_t)z * a.M * N);
      return;
    }
    if constexpr (kVec)
      wgb::store_tile_tma<BN, C>(acc, wgb::p_out<BN, S>(sm), &ymap, row0, col0);
    else
      wgb::store_pairs<BN, wgb::SameRow, C>(acc, row0, col0, a.M, N, y, nullptr);
    wgb::tile_stats<BN, C>(acc, sm, row0 / wgb::BM, col0, a.M, N, tile_sums);
  };
  StageCopies<BN, kVec> blk(a, &wmap, w, sm, full, 0, N, 0, 0);
  bool fix = false;
  if constexpr (kVec) fix = a.prologue;
  if (fix) {
    if constexpr (kVec) wgb::specialized<BN, S, true>(blk, sm, full, empty, un, epi);
  } else {
    wgb::specialized<BN, S, false>(blk, sm, full, empty, un, epi);
  }
  wgb::store_tma_wait<C>();
}

template <int BN, bool kVec>
inline int stage_gemm_wg(const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* part,
                         int N, float* ws, const wgb::Units& un, cudaStream_t s) {
  CUtensorMap wmap, ymap;
  memset(&wmap, 0, sizeof(wmap));
  memset(&ymap, 0, sizeof(ymap));
  int status = 0;
  if constexpr (kVec) {
    status = wgb::cached_matrix_map(&wmap, w, un.K, N, wgb::BK);
    if (status == 0 && un.splits == 1)
      status = wgb::cached_matrix_map(&ymap, y, a.M, N, wgb::BM);
  }
  auto* kernel = block_stage_wg_kernel<BN, kVec>;
  constexpr int smem = wgb::PTile<BN>::STATS_SMEM;
  int sms = 0;
  if (status == 0) status = wgb::max_smem_once((const void*)kernel, smem);
  if (status == 0) status = wgb::sm_count(&sms);
  if (status != 0) return status;
  const int64_t units = un.count();
  kernel<<<(unsigned)(units < sms ? units : sms), wgb::WS_THREADS, smem, s>>>(
      wmap, ymap, a, w, y, un.splits > 1 ? ws : nullptr, N, part, un);
  return (int)cudaGetLastError();
}

// y (M, N) bf16 of the conv gathered by `a` with w (K, N) bf16 row-major and
// the tile partials of its fp32 sum in part (m_tiles * 2 * N floats), on
// wgb::specialized: 128 x 64 tiles where N <= 64, else 128 x 128
// (build.wgb_tile_n), `splits` K splits of whole slices as K8 cuts them
// (ws: splits * M * N floats when splits > 1). cudaErrorInvalidValue for
// 2^31 units or more, or several splits and no ws; the loop never falls
// back to another. Enqueued on s; returns the status.
inline int stage_gemm_bf16(const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* part,
                           int N, float* ws, int splits, cudaStream_t s) {
  const int64_t K = (int64_t)a.ksize * a.ksize * a.Cin;
  const int bn = N <= 64 ? 64 : 128;
  const wgb::Units un{(a.M + wgb::BM - 1) / wgb::BM, (N + bn - 1) / bn, splits, K,
                      (wgb::slices_of(K) + splits - 1) / splits * wgb::BK};
  if (splits < 1 || (splits > 1 && ws == nullptr) || a.M == 0 || un.count() >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = a.vec && N % 8 == 0 && rt::aligned16(w) && rt::aligned16(y);
  auto* gemm = N <= 64 ? (vec ? stage_gemm_wg<64, true> : stage_gemm_wg<64, false>)
                       : (vec ? stage_gemm_wg<128, true> : stage_gemm_wg<128, false>);
  const int status = gemm(a, w, y, part, N, ws, un, s);
  if (status != 0) return status;
  if (splits > 1)
    splitk_sum_stats_bf16<<<dim3((unsigned)((N + CT - 1) / CT), (unsigned)un.m_tiles),
                            dim3(CT, RT), 0, s>>>(ws, y, part, a.M, N, splits);
  return (int)cudaGetLastError();
}

// One bf16 stage: y (M, N) bf16 of the conv gathered by `a` with w (K, N)
// bf16 row-major, its sums (2, N) from the fp32 accumulator and the
// (scale, shift) rows of the BN that follows; part and ws as stage's.
inline int stage_bf16(const FusedConvBfA& a, const uint16_t* w, uint16_t* y, float* part,
                      float* sums, const float* gamma, const float* beta, float* scale,
                      float* shift, int N, float* ws, int splits, float m, float eps,
                      cudaStream_t s) {
  const int status = stage_gemm_bf16(a, w, y, part, N, ws, splits, s);
  if (status != 0) return status;
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  tile_sums_affine<<<(unsigned)((N + CT - 1) / CT), dim3(CT, FL), 0, s>>>(
      part, sums, gamma, beta, scale, shift, N, m_tiles, m, eps);
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
  return launch_join(e, x, out, (int64_t)N * H * W * C4, C4, JoinIdentity{{sc_e, sh_e}, act}, st);
}

// rt_block_fused_f32's block one stage at a time, for a block whose BN
// statistics are those of a batch split over ranks: the caller sums each
// stage's sums over the ranks between two calls, in place, and m_rows
// points at the global row count (a device float). Stage 0: the weights'
// split, then the reduce GEMM and sums_r. Stage 1: (sc_r, sh_r) from sums_r
// over *m_rows, then the 3x3 and sums_s. Stage 2: (sc_s, sh_s), the expand
// and sums_e. Stage 3: (sc_e, sh_e) and the join. The GEMMs, their tiles, K
// splits and sums are the one call's, and so are the rows' arithmetic: with
// sums that no rank changed and *m_rows = N * H * W, the four calls write
// the one call's bits. wsplit must hold the split from stage 0 on.
extern "C" int rt_block_fused_stage_f32(int stage, const float* x, const float* w1,
                                        const float* w2, const float* w3, const float* g1,
                                        const float* b1, const float* g2, const float* b2,
                                        const float* g3, const float* b3, float* out, float* r,
                                        float* s, float* e, float* sums_r, float* sums_s,
                                        float* sums_e, float* rows, float* part, float* ws,
                                        float* wsplit, int N, int H, int W, int C4, int C,
                                        float eps, int has_cap, float cap, int splits0,
                                        int splits1, int splits2, const float* m_rows,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Act act{true, has_cap != 0, cap};
  const int64_t M = (int64_t)N * H * W;
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
  int status = 0;
  switch (stage) {
    case 0: {
      rt::wg::SplitJobs jobs{};
      jobs.job[0] = rt::wg::SplitJob{w1, w1s, C4, C, kp1};
      jobs.job[1] = rt::wg::SplitJob{w2, w2s, 9 * C, C, kp2};
      jobs.job[2] = rt::wg::SplitJob{w3, w3s, C, C4, kp3};
      status = rt::wg::launch_split(jobs, 3, st);
      if (status == 0)
        status = stage_gemm(
            conv_loader(x, nullptr, nullptr, N, H, W, C4, 1, 1, 0, 0, H, W, false, act), w1s,
            kp1, r, part, C, ws, splits0, st);
      return status != 0 ? status : stage_sums(part, sums_r, C, M, st);
    }
    case 1:
      status = launch_sums_affine(sums_r, g1, b1, sc_r, sh_r, C, m_rows, eps, st);
      if (status == 0)
        status = stage_gemm(
            conv_loader(r, sc_r, sh_r, N, H, W, C, 3, 1, 1, 1, H, W, true, act), w2s, kp2, s,
            part, C, ws, splits1, st);
      return status != 0 ? status : stage_sums(part, sums_s, C, M, st);
    case 2:
      status = launch_sums_affine(sums_s, g2, b2, sc_s, sh_s, C, m_rows, eps, st);
      if (status == 0)
        status = stage_gemm(
            conv_loader(s, sc_s, sh_s, N, H, W, C, 1, 1, 0, 0, H, W, true, act), w3s, kp3, e,
            part, C4, ws, splits2, st);
      return status != 0 ? status : stage_sums(part, sums_e, C4, M, st);
    case 3:
      status = launch_sums_affine(sums_e, g3, b3, sc_e, sh_e, C4, m_rows, eps, st);
      return status != 0 ? status
                         : launch_join(e, x, out, M * C4, C4, JoinIdentity{{sc_e, sh_e}, act}, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One bottleneck block on bf16 tensors: x, w1, w2, w3, out, r, s and e as
// rt_block_fused_f32's but bf16; g1, b1, g2, b2, g3, b3, the sums and rows
// fp32; part holds ceil(M / 128) * 2 * max(C, C4) floats, ws the largest
// splits_i * M * Cout_i floats over the stages whose splits_i > 1.
extern "C" int rt_block_fused_bf16(const __nv_bfloat16* x, const uint16_t* w1,
                                   const uint16_t* w2, const uint16_t* w3, const float* g1,
                                   const float* b1, const float* g2, const float* b2,
                                   const float* g3, const float* b3, __nv_bfloat16* out,
                                   uint16_t* r, uint16_t* s, __nv_bfloat16* e, float* sums_r,
                                   float* sums_s, float* sums_e, float* rows, float* part,
                                   float* ws, int N, int H, int W, int C4, int C, float eps,
                                   int has_cap, float cap, int splits0, int splits1,
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
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  uint16_t* eb = reinterpret_cast<uint16_t*>(e);

  // stage 0: the 1x1 reduce, no prologue
  int status = stage_bf16(
      conv_loader_bf16(xb, nullptr, nullptr, N, H, W, C4, 1, 1, 0, 0, H, W, false, act), w1,
      r, part, sums_r, g1, b1, sc_r, sh_r, C, ws, splits0, m, eps, st);
  if (status != 0) return status;

  // stage 1: bn_r's affine and ReLU in the gather, the 3x3 with padding 1
  status = stage_bf16(conv_loader_bf16(r, sc_r, sh_r, N, H, W, C, 3, 1, 1, 1, H, W, true, act),
                      w2, s, part, sums_s, g2, b2, sc_s, sh_s, C, ws, splits1, m, eps, st);
  if (status != 0) return status;

  // stage 2: bn_s's affine and ReLU in the gather, the 1x1 expand
  status = stage_bf16(conv_loader_bf16(s, sc_s, sh_s, N, H, W, C, 1, 1, 0, 0, H, W, true, act),
                      w3, eb, part, sums_e, g3, b3, sc_e, sh_e, C4, ws, splits2, m, eps, st);
  if (status != 0) return status;

  // stage 3: bn_e's affine, the identity residual, ReLU and the cap
  return launch_join(static_cast<const __nv_bfloat16*>(e), x, out, (int64_t)N * H * W * C4,
                     C4, JoinIdentity{{sc_e, sh_e}, act}, st);
}

// rt_block_fused_bf16's block one stage at a time, as
// rt_block_fused_stage_f32 runs the fp32 one: stage 0 the reduce GEMM and
// sums_r; 1 (sc_r, sh_r) from sums_r over *m_rows, the 3x3 and sums_s; 2
// (sc_s, sh_s), the expand and sums_e; 3 (sc_e, sh_e) and the join. With
// sums no rank changed and *m_rows = N * H * W, the one call's bits.
extern "C" int rt_block_fused_stage_bf16(int stage, const __nv_bfloat16* x, const uint16_t* w1,
                                         const uint16_t* w2, const uint16_t* w3,
                                         const float* g1, const float* b1, const float* g2,
                                         const float* b2, const float* g3, const float* b3,
                                         __nv_bfloat16* out, uint16_t* r, uint16_t* s,
                                         __nv_bfloat16* e, float* sums_r, float* sums_s,
                                         float* sums_e, float* rows, float* part, float* ws,
                                         int N, int H, int W, int C4, int C, float eps,
                                         int has_cap, float cap, int splits0, int splits1,
                                         int splits2, const float* m_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Act act{true, has_cap != 0, cap};
  const int64_t M = (int64_t)N * H * W;
  float* sc_r = rows;
  float* sh_r = rows + C;
  float* sc_s = rows + 2 * C;
  float* sh_s = rows + 3 * C;
  float* sc_e = rows + 4 * C;
  float* sh_e = rows + 4 * C + C4;
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  uint16_t* eb = reinterpret_cast<uint16_t*>(e);
  int status = 0;
  switch (stage) {
    case 0:
      status = stage_gemm_bf16(
          conv_loader_bf16(xb, nullptr, nullptr, N, H, W, C4, 1, 1, 0, 0, H, W, false, act), w1,
          r, part, C, ws, splits0, st);
      return status != 0 ? status : stage_sums(part, sums_r, C, M, st);
    case 1:
      status = launch_sums_affine(sums_r, g1, b1, sc_r, sh_r, C, m_rows, eps, st);
      if (status == 0)
        status = stage_gemm_bf16(
            conv_loader_bf16(r, sc_r, sh_r, N, H, W, C, 3, 1, 1, 1, H, W, true, act), w2, s,
            part, C, ws, splits1, st);
      return status != 0 ? status : stage_sums(part, sums_s, C, M, st);
    case 2:
      status = launch_sums_affine(sums_s, g2, b2, sc_s, sh_s, C, m_rows, eps, st);
      if (status == 0)
        status = stage_gemm_bf16(
            conv_loader_bf16(s, sc_s, sh_s, N, H, W, C, 1, 1, 0, 0, H, W, true, act), w3, eb,
            part, C4, ws, splits2, st);
      return status != 0 ? status : stage_sums(part, sums_e, C4, M, st);
    case 3:
      status = launch_sums_affine(sums_e, g3, b3, sc_e, sh_e, C4, m_rows, eps, st);
      return status != 0 ? status
                         : launch_join(static_cast<const __nv_bfloat16*>(e), x, out, M * C4,
                                       C4, JoinIdentity{{sc_e, sh_e}, act}, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K10-bf16's stage GEMM alone, with rt_fused_conv_bf16's arguments: y and
// the tile partials part of the conv of x (N, H, W, Cin) with w (k, k, Cin,
// Cout), the prologue and the window as K8's, on block_stage_wg_kernel, then
// sums (2, Cout) from part. K8's witness: the same inputs through both give
// the same bits (tests/test_torch_gpu.py).
extern "C" int rt_block_gemm_bf16(const uint16_t* x, const uint16_t* w, const float* scale,
                                  const float* shift, uint16_t* y, float* part, float* sums,
                                  int N, int H, int W, int Cin, int Cout, int k, int stride,
                                  int pad_top, int pad_left, int Ho, int Wo, int prologue,
                                  int relu, int has_cap, float cap, float* ws, int splits,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const FusedConvBfA a =
      conv_loader_bf16(x, scale, shift, N, H, W, Cin, k, stride, pad_top, pad_left, Ho, Wo,
                       prologue != 0, Act{relu != 0, has_cap != 0, cap});
  const int status = stage_gemm_bf16(a, w, y, part, Cout, ws, splits, s);
  if (status != 0) return status;
  const int64_t m_tiles = (a.M + TILE_M - 1) / TILE_M;
  tile_sums_final<<<(unsigned)((Cout + CT - 1) / CT), dim3(CT, FL), 0, s>>>(part, sums, Cout,
                                                                           m_tiles);
  return (int)cudaGetLastError();
}
