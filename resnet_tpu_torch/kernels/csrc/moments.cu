// Per-channel batch-norm statistics of an (M, C) row-major view in one read
// and one launch: mean = sum(x) / M and the biased var =
// max(sum(x^2) / M - mean^2, 0).
//
// Replaces the Pallas kernel resnet_tpu/kernels/bn.py::_stats_kernel
// (public function moments). The TPU version walks the rows as a
// sequential grid axis and carries (sum, sum of squares) in VMEM scratch
// from one step to the next; blocks on a GPU run in no order, so here each
// block reduces one chunk of rows and the last block to finish a channel
// tile reduces the chunks:
//
//   block (tile, chunk)  TC = VEC * ctv <= 32 channels x `chunk` rows: ctv
//                        lanes on neighbouring channels times THREADS / ctv
//                        row lanes (THREADS 1024 for a large view, 256 for a
//                        small one), so a warp reads 128 contiguous bytes
//                        of each of 32 / ctv rows; each thread sums every
//                        row lane-th row of the chunk in fp32 (16-byte loads
//                        of four channels where C % 4 == 0 and x is 16-byte
//                        aligned, VEC 4; 4-byte loads otherwise, VEC 1), the
//                        block adds its row lanes in shared memory in a
//                        fixed order and writes the chunk's (sum, sum of
//                        squares) into `part`;
//   the last block       of a tile, found by a ticket: every block fences
//                        its partials and takes a ticket from the tile's
//                        counter; the block that draws n_chunks - 1 sums the
//                        tile's chunk partials in double in a fixed order
//                        (chunk k into lane k mod FL, then the lanes in
//                        order), reading VEC channels per load with
//                        several loads in flight per thread, applies the
//                        epilogue of bn.py:83-86 in fp32 and resets the
//                        counter to 0 for the next call. This sum is a
//                        serial tail after every other block, and its time
//                        grows with the partials it reads, so tiles are
//                        narrow (32 channels: more tiles, each summed by
//                        its own last block, on its own SM) and a large
//                        view takes blocks of 1024 threads (two per SM fill
//                        the SM and leave half the partials of 256-thread
//                        blocks at four per SM).
//
// With SUMS (the entries rt_moments_sums_*) the last block writes the raw
// fp32 (sum, sum of squares) in place of the epilogue, for a caller that adds
// the sums of several processes before it divides by their rows together
// (the data-parallel step's batch statistics). Everything before the last
// write is the same code, so the statistics entries keep their bits.
//
// No atomics in any sum, so a run repeats exactly; the ticket is the only
// atomic. The counters and `part` are a workspace that the wrapper keeps per
// (device, stream): calls on one stream run one after another, so each call
// finds its counters at 0, and two streams never share a workspace.
//
// Bound on the H100: device-memory bandwidth. The statistics read the
// activation once (4 bytes per element, 2 FLOPs each); the partials are
// C * 2 * n_chunks floats, under 1% of the read at ResNet-50's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of a block: 1024 for a large view (two blocks per SM, so that
// 2048 threads per SM stream the read and few chunk partials are left for
// the last block), 256 for a small one (more blocks over its few rows);
// either way 32 registers, so that a single wave holds every block
constexpr int LARGE = 1024;
constexpr int SMALL = 256;

// VEC floats at p into v, through L2 (another block wrote them)
template <int VEC>
__device__ __forceinline__ void load_cg(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// VEC values of x's row at p, as fp32: one 16-byte load of 4 floats, or an
// 8-byte load of 4 bf16 (each exact in fp32), or one value
template <class T, int VEC>
__device__ __forceinline__ void load_row(float (&v)[VEC], const T* p) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (sizeof(T) == 2 && VEC == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (sizeof(T) == 2) {
    v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  } else {
    v[0] = __ldg(p);
  }
}

template <class T, int VEC, int THREADS, bool SUMS>
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
moments_kernel(const T* __restrict__ x, float* __restrict__ part,
               unsigned* __restrict__ tickets, float* __restrict__ stats, int64_t M, int C,
               int64_t chunk, int n_chunks, int ctv) {
  // the row lanes' sums, then (as shd) the last block's chunk-lane sums
  __shared__ __align__(16) float sh[2][THREADS * VEC];
  __shared__ float red[THREADS];  // the row-lane segments' sums
  __shared__ bool last;
  const int t = threadIdx.x;
  const int lane = t % ctv;
  const int row_lane = t / ctv;
  const int row_lanes = THREADS / ctv;
  const int tc = VEC * ctv;  // channels of the tile
  const int c0 = blockIdx.x * tc + lane * VEC;
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int64_t r1 = M < r0 + chunk ? M : r0 + chunk;

  float s[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = s2[j] = 0.f;
  if (c0 < C) {  // with VEC 4, C % 4 == 0: all four channels exist
#pragma unroll 4
    for (int64_t r = r0 + row_lane; r < r1; r += row_lanes) {
      float v[VEC];
      load_row<T, VEC>(v, x + r * C + c0);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(&sh[0][row_lane * tc + lane * 4]) =
        make_float4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<float4*>(&sh[1][row_lane * tc + lane * 4]) =
        make_float4(s2[0], s2[1], s2[2], s2[3]);
  } else {
    sh[0][row_lane * tc + lane] = s[0];
    sh[1][row_lane * tc + lane] = s2[0];
  }
  __syncthreads();
  // the chunk's partial in two fixed-order steps: thread t adds 2 * VEC row
  // lanes of one (which, channel), segment t / outs; then one thread per
  // (which, channel) adds the segments in order
  const int outs = 2 * tc;
  {
    const int o = t % outs, seg = t / outs, per = 2 * VEC;
    const int which = o / tc, ch = o % tc;
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < per; ++k) a += sh[which][(seg * per + k) * tc + ch];
    red[t] = a;
  }
  __syncthreads();
  if (t < outs) {
    float a = 0.f;
    for (int seg = 0; seg < THREADS / outs; ++seg) a += red[seg * outs + t];
    const int which = t / tc, c = blockIdx.x * tc + t % tc;
    if (c < C) part[((int64_t)blockIdx.y * 2 + which) * C + c] = a;
  }
  __threadfence();  // the partials are visible to every block before the ticket
  __syncthreads();
  if (t == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of the tile: its 2 * tc sums as `groups` loads of VEC
  // channels per chunk, over FL chunk lanes (chunk k into lane k mod FL),
  // each lane's chunks added in order in double, B loads in flight at a time;
  // then the lanes in order. THREADS = FL * groups (tc is a power of two).
  double* shd = reinterpret_cast<double*>(&sh[0][0]);  // THREADS * VEC doubles
  const int groups = outs / VEC;
  const int fl = THREADS / groups;
  const int o = t % groups, k0 = t / groups;
  const int which = o / (tc / VEC);
  const int c = blockIdx.x * tc + (o % (tc / VEC)) * VEC;
  double acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.0;
  if (c < C) {
    const float* base = part + (int64_t)which * C + c;
    const int64_t step = 2 * (int64_t)C;  // from one chunk's partials to the next
    constexpr int B = 2;  // loads in flight, within 32 registers (2048 threads per SM)
    for (int k = k0; k < n_chunks; k += B * fl) {
      float v[B][VEC];
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (k + i * fl < n_chunks) load_cg<VEC>(v[i], base + (int64_t)(k + i * fl) * step);
#pragma unroll
      for (int i = 0; i < B; ++i)
        if (k + i * fl < n_chunks)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += (double)v[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) shd[t * VEC + j] = acc[j];
  __syncthreads();
  if (t < tc && blockIdx.x * tc + t < C) {
    // channel t of the tile: load group t / VEC (sums) and the group tc / VEC
    // further on (sums of squares), lane j = t % VEC of each
    const int g = t / VEC, j = t % VEC;
    double sa = 0.0, sb = 0.0;
    for (int k = 0; k < fl; ++k) {
      sa += shd[(k * groups + g) * VEC + j];
      sb += shd[(k * groups + tc / VEC + g) * VEC + j];
    }
    if constexpr (SUMS) {
      stats[blockIdx.x * tc + t] = (float)sa;
      stats[C + blockIdx.x * tc + t] = (float)sb;
    } else {
      // bn.py:83-86 in fp32, each operation rounded on its own (no FMA)
      const float m = (float)M;
      const float mu = __fdiv_rn((float)sa, m);
      const float v = __fsub_rn(__fdiv_rn((float)sb, m), __fmul_rn(mu, mu));
      stats[blockIdx.x * tc + t] = mu;
      stats[C + blockIdx.x * tc + t] = v < 0.f ? 0.f : v;  // a NaN propagates, as in jnp.maximum
    }
  }
  if (t == 0) tickets[blockIdx.x] = 0u;
}

}  // namespace

namespace {

template <class T, bool SUMS>
int launch_moments(const T* x, float* part, unsigned* tickets, float* stats, int64_t M, int C,
                   int64_t chunk, int n_chunks, int vec, int ctv, int threads,
                   cudaStream_t s) {
  const int tc = vec * ctv;
  const dim3 grid((unsigned)((C + tc - 1) / tc), (unsigned)n_chunks);
  if (threads == LARGE && vec == 4)
    moments_kernel<T, 4, LARGE, SUMS><<<grid, LARGE, 0, s>>>(x, part, tickets, stats, M, C,
                                                             chunk, n_chunks, ctv);
  else if (threads == LARGE)
    moments_kernel<T, 1, LARGE, SUMS><<<grid, LARGE, 0, s>>>(x, part, tickets, stats, M, C,
                                                             chunk, n_chunks, ctv);
  else if (vec == 4)
    moments_kernel<T, 4, SMALL, SUMS><<<grid, SMALL, 0, s>>>(x, part, tickets, stats, M, C,
                                                             chunk, n_chunks, ctv);
  else
    moments_kernel<T, 1, SMALL, SUMS><<<grid, SMALL, 0, s>>>(x, part, tickets, stats, M, C,
                                                             chunk, n_chunks, ctv);
  return (int)cudaGetLastError();
}

}  // namespace

// stats (2, C): mean, then var, of x (M, C). part holds 2 * n_chunks * C
// floats, n_chunks = ceil(M / chunk) <= 65535; tickets one counter per
// channel tile, all 0, left at 0. vec is 4 (C % 4 == 0 and x 16-byte
// aligned) or 1; ctv a power of two <= 32 / vec, so a tile is vec * ctv
// channels; threads 1024 or 256. The caller checks M > 0, shapes, dtype and
// contiguity.
extern "C" int rt_moments_f32(const float* x, float* part, unsigned* tickets, float* stats,
                              int64_t M, int C, int64_t chunk, int n_chunks, int vec,
                              int ctv, int threads, void* stream) {
  return launch_moments<float, false>(x, part, tickets, stats, M, C, chunk, n_chunks, vec, ctv,
                                     threads, (cudaStream_t)stream);
}

// The same for bf16 x (its 16-bit patterns), read as fp32 into the same
// fp32 sums (bn.py:77, :101): vec 4 is an 8-byte load of 4 values
// (C % 4 == 0 and x 8-byte aligned). The statistics are fp32.
extern "C" int rt_moments_bf16(const uint16_t* x, float* part, unsigned* tickets,
                               float* stats, int64_t M, int C, int64_t chunk, int n_chunks,
                               int vec, int ctv, int threads, void* stream) {
  return launch_moments<__nv_bfloat16, false>(reinterpret_cast<const __nv_bfloat16*>(x), part,
                                             tickets, stats, M, C, chunk, n_chunks, vec, ctv,
                                             threads, (cudaStream_t)stream);
}

// The raw sums: sums (2, C) holds sum(x), then sum(x^2), each the fp32
// rounding of the tile's double sum; the arguments are rt_moments_f32's and
// rt_moments_bf16's.
extern "C" int rt_moments_sums_f32(const float* x, float* part, unsigned* tickets, float* sums,
                                   int64_t M, int C, int64_t chunk, int n_chunks, int vec,
                                   int ctv, int threads, void* stream) {
  return launch_moments<float, true>(x, part, tickets, sums, M, C, chunk, n_chunks, vec, ctv,
                                     threads, (cudaStream_t)stream);
}

extern "C" int rt_moments_sums_bf16(const uint16_t* x, float* part, unsigned* tickets,
                                    float* sums, int64_t M, int C, int64_t chunk, int n_chunks,
                                    int vec, int ctv, int threads, void* stream) {
  return launch_moments<__nv_bfloat16, true>(reinterpret_cast<const __nv_bfloat16*>(x), part,
                                             tickets, sums, M, C, chunk, n_chunks, vec, ctv,
                                             threads, (cudaStream_t)stream);
}
