// Batch-norm apply and the BN(+ReLU) backward over an (M, C) row-major
// view, fp32 or bf16.
//
// Replaces two Pallas kernel families of resnet_tpu/kernels/bn.py:
//
//   K5 ::_apply_kernel (called by _apply; public through
//      kernels/fused.py::bias_act and bn.py::batch_norm_act):
//        y = clip(relu(x * scale[c] + shift[c]))   (relu and cap optional)
//      rt_bn_apply_f32: one elementwise pass. The TPU version pads the view
//      to (512, 128)-blocks; here it is one flat range whose element i has
//      channel i mod C (rowwise.cuh). float4 loads and stores when x and y
//      are 16-byte aligned, a scalar loop for the remainder (or the whole
//      range when they are not).
//
//   K6 ::_bwd_reduce_kernel and ::_bwd_dx_kernel (bn.py::_bn_bwd_impl, the
//      backward of batch_norm_act): with x_hat = (x - mean) * inv_std and
//      dy_g = dy gated by the recomputed ReLU (x_hat * gamma + beta > 0),
//        s1 = sum over rows of dy_g, s2 = sum of dy_g * x_hat,
//        dx = gamma * inv_std * (dy_g - s1 / M - x_hat * s2 / M),
//        dgamma = s2, dbeta = s1.
//      rt_bn_bwd_f32: the TPU reduction carries (s1, s2) in VMEM along a
//      sequential grid; blocks on a GPU run in no order. Here one kernel,
//      bn_bwd_kernel, on K4's layout (csrc/moments.cu): block (tile, chunk)
//      owns a channel tile of 128 bytes of a row (ctv lanes of one 16-byte
//      access: 4 fp32 or 8 bf16 channels; one value a lane where C or the
//      pointers' alignment forbid it) over a chunk of rows, BWD_THREADS / ctv
//      row lanes, each loading BWD_ROWS rows of x and dy at once. One block
//      of 512 threads a SM: a bf16 lane keeps its 8 channels' mean,
//      inv_std, gamma and beta, and in the dx pass their three
//      coefficients, in registers (up to 128 a thread).
//        1. Each block sums its chunk's (s1, s2) in fp32, adds its row
//           lanes in shared memory in a fixed order and writes the chunk's
//           partials; then every block of the tile sums the tile's chunk
//           partials in double in one fixed order (K4's finish, run by each
//           block, so all agree bit for bit) into s1 and s2. No sum takes
//           an atomic: a run repeats bit for bit.
//        2. The dx pass reads x and dy again, each thread walking its own
//           rows in the reverse of the order in which it summed them, so
//           that the rows it read last, those the L2 is likeliest to still
//           hold, come first; these second reads and the dx stores stream
//           (evict-first).
//      With at most one block a SM (the wrapper's plan: tiles * n_chunks <=
//      the SMs), 1 and 2 run in one cooperative launch (mode BOTH): a block
//      that has written its partials arrives on its tile's counter and
//      waits until every block of the tile has; the last to leave resets
//      the counter, so calls on one stream may follow each other. A wider
//      view takes two launches (REDUCE, then DX), where the kernel boundary
//      is the wait.
//
// Each product and sum the plain PyTorch versions round on their own is
// rounded on its own here too (__fmul_rn, __fadd_rn: no contraction into an
// FMA), so the elementwise results match them bit for bit: K5's y, and
// K6's gate and dx given the same s1 and s2.
//
// bf16 (rt_bn_apply_bf16, rt_bn_bwd_bf16): the same bodies, one template
// over the storage type (rowwise.cuh), as the Pallas kernels take bf16:
// x and dy are read into fp32 (bn.py:135, :174-175, :192-193), the
// per-channel rows stay fp32 (the wrapper casts gamma and beta, as
// _bn_bwd_impl's rows are cast at bn.py:210), s1 and s2 are fp32 sums, and
// y and dx are rounded to bf16 once (bn.py:140, :201). 16-byte accesses
// move eight values where x, dy, y and dx are 16-byte aligned.
//
// Bound on the H100: device-memory bandwidth. K5 reads 4 and writes 4 bytes
// per element for 2 FLOPs (bf16: 2 and 2); K6 must read x and dy, write
// dx, and read again what of x and dy the L2 no longer holds when s1 and s2
// are known (12 bytes per element plus that second read; bf16: 6). wgmma
// has no role here.

#include "rowwise.cuh"

namespace {

using rt::Act;
using rt::ChannelWalk;

__device__ __forceinline__ float affine(float x, float s, float t) {
  return __fadd_rn(__fmul_rn(x, s), t);
}

// y = act(x * scale + shift) over nv 16-byte groups of x (Vec16<T>::N values)
template <class T>
__global__ void bn_apply_vec(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ shift, T* __restrict__ y, int64_t nv,
                             int C, Act act) {
  using V = rt::Vec16<T>;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(V::N * i, V::N * stride, C);
  for (; i < nv; i += stride, ch.advance()) {
    float v[V::N];
    V::load(x + V::N * i, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const int c = ch.at(j);
      v[j] = act(affine(v[j], scale[c], shift[c]));
    }
    V::store(y + V::N * i, v);
  }
}

template <class T>
__global__ void bn_apply_scalar(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ shift, T* __restrict__ y,
                                int64_t begin, int64_t end, int C, Act act) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ChannelWalk ch(i, stride, C);
  for (; i < end; i += stride, ch.advance())
    rt::st(y + i, act(affine(rt::ld(x + i), scale[ch.c], shift[ch.c])));
}

// x_hat and the gated gradient of one element
__device__ __forceinline__ float gated(float x, float dy, float mu, float iv, float g,
                                       float b, bool relu, float& xh) {
  xh = __fmul_rn(__fsub_rn(x, mu), iv);
  return (relu && !(affine(xh, g, b) > 0.f)) ? 0.f : dy;
}

// ---------------------------------------------------------------------- K6

constexpr int BWD_THREADS = 512;  // one block a SM (bn.py _BWD_THREADS)
constexpr int BWD_ROWS = 4;       // rows of x and dy a thread loads at once
// bn_bwd_kernel's modes: the sums, the dx pass, or both in one launch
constexpr int REDUCE = 1, DX = 2, BOTH = 3;

// N values of a row at p: one 16-byte access (VEC) or one value. ld reads
// through the read-only path, ld_last and st_last stream (evict-first: the
// value is not read again)
template <class T, bool VEC>
struct RowIo;

template <class T>
struct RowIo<T, true> {
  using V = rt::Vec16<T>;
  static constexpr int N = V::N;
  using Raw = uint4;
  __device__ static Raw ld(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static Raw ld_last(const T* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const Raw& u, float (&v)[N]) { V::unpack(u, v); }
  __device__ static void st_last(T* p, const float (&v)[N]) {
    __stcs(reinterpret_cast<uint4*>(p), V::pack(v));
  }
};

template <>
struct RowIo<float, false> {
  static constexpr int N = 1;
  using Raw = float;
  __device__ static Raw ld(const float* p) { return __ldg(p); }
  __device__ static Raw ld_last(const float* p) { return __ldcs(p); }
  __device__ static void unpack(Raw u, float (&v)[1]) { v[0] = u; }
  __device__ static void st_last(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
};

template <>
struct RowIo<__nv_bfloat16, false> {
  static constexpr int N = 1;
  using Raw = unsigned short;  // the bf16's bits
  __device__ static Raw ld(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static Raw ld_last(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void unpack(Raw u, float (&v)[1]) { v[0] = __uint_as_float((uint32_t)u << 16); }
  __device__ static void st_last(__nv_bfloat16* p, const float (&v)[1]) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
};

// G floats at p, through the L2 (another block wrote them)
template <int G>
__device__ __forceinline__ void load_cg(float (&v)[G], const float* p) {
  if constexpr (G == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    v[0] = __ldcg(p);
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <class T>
struct BwdArgs {
  const T* x;
  const T* dy;
  const float* mean;
  const float* inv;
  const float* gamma;
  const float* beta;
  float* part;        // 2 * n_chunks * C: chunk k's s1 row at 2k, its s2 row at 2k + 1
  unsigned* tickets;  // a counter a channel tile; all 0, left at 0
  float* sums;        // (2, C): s1 (dbeta), then s2 (dgamma)
  T* dx;
  int64_t M, chunk;
  int C, n_chunks, ctv, mode;
  bool relu;
};

template <class T, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS, 1) bn_bwd_kernel(const BwdArgs<T> a) {
  using IO = RowIo<T, VEC>;
  using Raw = typename IO::Raw;
  constexpr int N = IO::N;
  constexpr int U = BWD_ROWS;
  constexpr int G = VEC ? 4 : 1;  // partials a load in the finish
  // the row lanes' sums, then (as doubles) the finish's chunk-lane sums
  __shared__ __align__(16) float sh[2][BWD_THREADS * N];
  __shared__ float red[BWD_THREADS];  // the row-lane segments' sums
  __shared__ float s12[2][64];        // the tile's s1 and s2 (at most 64 channels)
  const int t = threadIdx.x;
  const int lane = t % a.ctv, row_lane = t / a.ctv, row_lanes = BWD_THREADS / a.ctv;
  const int tc = N * a.ctv;  // channels of the tile
  const int c0 = blockIdx.x * tc + lane * N;
  const bool live = c0 < a.C;  // with VEC, C % N == 0: all N channels exist
  const int64_t C = a.C;
  // the thread's rows: first + i * row_lanes for i < rows
  const int64_t first = (int64_t)blockIdx.y * a.chunk + row_lane;
  const int64_t end = (int64_t)blockIdx.y * a.chunk + a.chunk;
  const int64_t r1 = a.M < end ? a.M : end;
  const int64_t rows = live && first < r1 ? (r1 - 1 - first) / row_lanes + 1 : 0;
  unsigned* count = a.tickets + blockIdx.x;
  // the dx pass's j-th row: the thread's rows backwards, so that those read
  // last in the reduction, which the L2 is likeliest to hold, come first
  auto dx_row = [rows](int64_t j) { return rows - 1 - j; };

  float mu[N], iv[N], g[N], b[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = live ? c0 + j : 0;
    mu[j] = a.mean[c];
    iv[j] = a.inv[c];
    g[j] = a.gamma[c];
    b[j] = a.beta[c];
  }

  if (a.mode & REDUCE) {
    float s1[N], s2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s1[j] = s2[j] = 0.f;
    for (int64_t k = 0; k < rows; k += U) {
      Raw xr[U], dr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= rows) continue;
        const int64_t at = (first + (k + u) * row_lanes) * C + c0;
        xr[u] = IO::ld(a.x + at);
        dr[u] = IO::ld(a.dy + at);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k + u >= rows) continue;
        float xv[N], dv[N];
        IO::unpack(xr[u], xv);
        IO::unpack(dr[u], dv);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float xh;
          const float d = gated(xv[j], dv[j], mu[j], iv[j], g[j], b[j], a.relu, xh);
          s1[j] += d;
          s2[j] += d * xh;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      sh[0][row_lane * tc + lane * N + j] = s1[j];
      sh[1][row_lane * tc + lane * N + j] = s2[j];
    }
    __syncthreads();
    // the chunk's partials in two fixed-order steps: thread t adds 2 * N row
    // lanes of one (which, channel), segment t / outs; then one thread per
    // (which, channel) adds the segments in order
    const int outs = 2 * tc;
    {
      const int o = t % outs, seg = t / outs, which = o / tc, ch = o % tc;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 2 * N; ++k) acc += sh[which][(seg * 2 * N + k) * tc + ch];
      red[t] = acc;
    }
    __syncthreads();
    if (t < outs) {
      float acc = 0.f;
      for (int seg = 0; seg < BWD_THREADS / outs; ++seg) acc += red[seg * outs + t];
      const int c = blockIdx.x * tc + t % tc;
      if (c < a.C) a.part[((int64_t)blockIdx.y * 2 + t / tc) * C + c] = acc;
    }
    if (a.mode == REDUCE) return;  // the launch boundary is the wait
    __threadfence();  // the partials are visible to every block before the arrival
    __syncthreads();
    if (t == 0) {  // arrive, wait for the tile's other blocks, leave
      atomicAdd(count, 1u);
      for (unsigned n = 0; ld_acquire(count) < (unsigned)a.n_chunks; ++n) {
        if (n == (1u << 22)) __trap();  // a block that never arrives: fail, not hang
        __nanosleep(64);
      }
      // the last to leave resets the counter: every block is past its wait
      if (atomicAdd(count, 1u) == 2u * (unsigned)a.n_chunks - 1u) *count = 0u;
    }
    __syncthreads();
  }

  // s1 and s2 of the tile's channels: every block sums the tile's chunk
  // partials itself, in one fixed order, so all agree bit for bit: 2 * tc
  // sums as `groups` loads of G partials a chunk over fl chunk lanes (chunk
  // k into lane k mod fl), each lane's chunks added in order in double, B
  // loads in flight; then the lanes in order. The tile's first block writes
  // them out.
  {
    double* shd = reinterpret_cast<double*>(&sh[0][0]);  // BWD_THREADS * G doubles
    const int outs = 2 * tc, groups = outs / G, fl = BWD_THREADS / groups, per = tc / G;
    const int o = t % groups;
    const int c = blockIdx.x * tc + (o % per) * G;
    double acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.0;
    if (c < a.C) {
      const float* base = a.part + (o / per) * C + c;
      constexpr int B = 4;
      for (int k = t / groups; k < a.n_chunks; k += B * fl) {
        float v[B][G];
#pragma unroll
        for (int i = 0; i < B; ++i)
          if (k + i * fl < a.n_chunks) load_cg<G>(v[i], base + (int64_t)(k + i * fl) * 2 * C);
#pragma unroll
        for (int i = 0; i < B; ++i)
          if (k + i * fl < a.n_chunks)
#pragma unroll
            for (int j = 0; j < G; ++j) acc[j] += (double)v[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) shd[t * G + j] = acc[j];
    __syncthreads();
    if (t < tc && blockIdx.x * tc + t < a.C) {
      const int gi = t / G, j = t % G;
      double sa = 0.0, sb = 0.0;
      for (int k = 0; k < fl; ++k) {
        sa += shd[(k * groups + gi) * G + j];
        sb += shd[(k * groups + per + gi) * G + j];
      }
      s12[0][t] = (float)sa;
      s12[1][t] = (float)sb;
      if (blockIdx.y == 0) {
        a.sums[blockIdx.x * tc + t] = (float)sa;
        a.sums[C + blockIdx.x * tc + t] = (float)sb;
      }
    }
    __syncthreads();
  }

  // dx: the coefficients of the thread's channels, gamma * inv_std, s1 / M
  // and s2 / M, each rounded on its own as the plain version rounds them
  float ca[N], cb[N], cc[N];
  const float m = (float)a.M;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int i = live ? lane * N + j : 0;  // the channel's place in the tile
    ca[j] = __fmul_rn(g[j], iv[j]);
    cb[j] = __fdiv_rn(s12[0][i], m);
    cc[j] = __fdiv_rn(s12[1][i], m);
  }
  for (int64_t k = 0; k < rows; k += U) {
    Raw xr[U], dr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u >= rows) continue;
      const int64_t at = (first + dx_row(k + u) * row_lanes) * C + c0;
      xr[u] = IO::ld_last(a.x + at);
      dr[u] = IO::ld_last(a.dy + at);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k + u >= rows) continue;
      float xv[N], dv[N];
      IO::unpack(xr[u], xv);
      IO::unpack(dr[u], dv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float xh;
        const float d = gated(xv[j], dv[j], mu[j], iv[j], g[j], b[j], a.relu, xh);
        xv[j] = __fmul_rn(ca[j], __fsub_rn(__fsub_rn(d, cb[j]), __fmul_rn(xh, cc[j])));
      }
      IO::st_last(a.dx + (first + dx_row(k + u) * row_lanes) * C + c0, xv);
    }
  }
}

template <class T>
int bn_apply(const T* x, const float* scale, const float* shift, T* y, int64_t n, int C,
             Act act, cudaStream_t s) {
  constexpr int N = rt::Vec16<T>::N;
  const int64_t nv = rt::aligned16(x) && rt::aligned16(y) ? n / N : 0;
  if (nv > 0)
    bn_apply_vec<T><<<rt::ew_blocks(nv), rt::EW_THREADS, 0, s>>>(x, scale, shift, y, nv, C,
                                                                  act);
  if (N * nv < n)
    bn_apply_scalar<T><<<rt::ew_blocks(n - N * nv), rt::EW_THREADS, 0, s>>>(
        x, scale, shift, y, N * nv, n, C, act);
  return (int)cudaGetLastError();
}

template <class T, bool VEC>
int launch_bn_bwd(BwdArgs<T> a, bool fused, cudaStream_t s) {
  const int tc = RowIo<T, VEC>::N * a.ctv;
  const dim3 grid((unsigned)((a.C + tc - 1) / tc), (unsigned)a.n_chunks);
  if (fused) {  // every block resident, or the launch is refused
    a.mode = BOTH;
    void* args[] = {&a};
    return (int)cudaLaunchCooperativeKernel((const void*)bn_bwd_kernel<T, VEC>, grid,
                                            dim3(BWD_THREADS), args, 0, s);
  }
  a.mode = REDUCE;
  bn_bwd_kernel<T, VEC><<<grid, BWD_THREADS, 0, s>>>(a);
  a.mode = DX;
  bn_bwd_kernel<T, VEC><<<grid, BWD_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int bn_bwd(const BwdArgs<T>& a, int vec, int fused, cudaStream_t s) {
  const bool shape_ok = a.M > 0 && a.C > 0 && a.chunk > 0 && a.n_chunks > 0 &&
                        a.n_chunks <= 65535 && (int64_t)(a.n_chunks - 1) * a.chunk < a.M &&
                        (int64_t)a.n_chunks * a.chunk >= a.M && a.ctv > 0 &&
                        (a.ctv & (a.ctv - 1)) == 0 && a.ctv <= (vec ? 8 : 32);
  const bool vec_ok = !vec || (a.C % rt::Vec16<T>::N == 0 && rt::aligned16(a.x) &&
                               rt::aligned16(a.dy) && rt::aligned16(a.dx));
  if (!shape_ok || !vec_ok) return (int)cudaErrorInvalidValue;
  return vec ? launch_bn_bwd<T, true>(a, fused != 0, s) : launch_bn_bwd<T, false>(a, fused != 0, s);
}

}  // namespace

// y = act(x * scale + shift) over n elements of an (n / C, C) view; scale
// and shift hold C floats. The caller checks shapes, dtype and contiguity.
extern "C" int rt_bn_apply_f32(const float* x, const float* scale, const float* shift,
                               float* y, int64_t n, int C, int relu, int has_cap, float cap,
                               void* stream) {
  return bn_apply(x, scale, shift, y, n, C, Act{relu != 0, has_cap != 0, cap},
                  (cudaStream_t)stream);
}

extern "C" int rt_bn_apply_bf16(const __nv_bfloat16* x, const float* scale, const float* shift,
                                __nv_bfloat16* y, int64_t n, int C, int relu, int has_cap,
                                float cap, void* stream) {
  return bn_apply(x, scale, shift, y, n, C, Act{relu != 0, has_cap != 0, cap},
                  (cudaStream_t)stream);
}

// dx (M, C) and sums (2, C) (s1 = dbeta, then s2 = dgamma) of
// batch_norm_act from x, dy (M, C) and the per-channel mean, inv_std, gamma
// and beta (fp32 rows). vec 1: 16-byte accesses (C a multiple of 4 fp32 or
// 8 bf16 values, x, dy and dx 16-byte aligned), 0: one value a lane; ctv a
// power of two, at most 8 (vec) or 32; n_chunks = ceil(M / chunk) row chunks
// of each tile of vec ? 4 or 8 : 1 times ctv channels; part holds 2 *
// n_chunks * C floats, tickets a counter a tile, all 0 (left at 0). fused 1:
// one cooperative launch, which the card refuses unless every block is
// resident (tiles * n_chunks blocks of BWD_THREADS, at most one a SM is
// always resident); 0: two launches. The caller checks shapes, dtype and
// contiguity; a plan the kernel cannot run returns cudaErrorInvalidValue.
extern "C" int rt_bn_bwd_f32(const float* x, const float* dy, const float* mean,
                             const float* inv, const float* gamma, const float* beta,
                             float* part, unsigned* tickets, float* sums, float* dx, int64_t M,
                             int C, int64_t chunk, int n_chunks, int vec, int ctv, int fused,
                             int relu, void* stream) {
  return bn_bwd(BwdArgs<float>{x, dy, mean, inv, gamma, beta, part, tickets, sums, dx, M,
                               chunk, C, n_chunks, ctv, 0, relu != 0},
                vec, fused, (cudaStream_t)stream);
}

extern "C" int rt_bn_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                              const float* mean, const float* inv, const float* gamma,
                              const float* beta, float* part, unsigned* tickets, float* sums,
                              __nv_bfloat16* dx, int64_t M, int C, int64_t chunk, int n_chunks,
                              int vec, int ctv, int fused, int relu, void* stream) {
  return bn_bwd(BwdArgs<__nv_bfloat16>{x, dy, mean, inv, gamma, beta, part, tickets, sums,
                                       dx, M, chunk, C, n_chunks, ctv, 0, relu != 0},
                vec, fused, (cudaStream_t)stream);
}
