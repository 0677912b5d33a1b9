// Guarded Adam over every parameter tensor in one launch, in place.
//
// Replaces the Pallas kernel resnet_tpu/kernels/adam.py::_adam_kernel
// (public function fused_adam_flat), whose caller ravels all parameters,
// gradients and moments into flat vectors and unravels the result. Here a
// table of (p, g, m, v, numel, first block, 16-byte flag) rows, one per
// tensor, takes the place of the raveled copies. The table travels in the
// kernel's parameter bank (a __grid_constant__ struct of up to MAX_ROWS
// rows, 48 bytes each): no device table, no host-to-device copy, nothing
// allocated per call. Block b finds its tensor by binary search over the
// first-block column and updates CHUNK elements of it, four at a time with
// 16-byte loads and stores where the row's flag says that all four
// pointers are 16-byte aligned and numel % 4 == 0, one at a time otherwise.
// More rows than MAX_ROWS launch once per group of MAX_ROWS rows, each
// group's first blocks counted from 0. p, m and v are updated IN PLACE,
// which saves three copies of the model (and the ravel and unravel passes)
// per step.
//
// The arithmetic is adam.py:38-53, in fp32, with the hyper row
// h = [lr, wd, b1, b2, eps, b1^t, b2^t, guard] read from device memory (the
// learning rate and the decay products are device scalars, so no host sync):
//   g' = g + wd*p; m' = b1*m + (1-b1)*g'; v' = b2*v + (1-b2)*g'^2
//   m', v' keep m, v where g is non-finite            (guard > 0)
//   p' = p - (lr * (m'/(1-b1^t)) / (sqrt(v'/(1-b2^t)) + eps) + wd*p)
//   p' keeps p where p' is non-finite                 (guard > 0)
//
// Bound on the H100: device-memory bandwidth, 16 bytes read and 12 written
// per parameter (about 8 FLOPs and one sqrt each).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t CHUNK = 4096;  // elements per block
constexpr int MAX_ROWS = 256;    // rows per launch
constexpr int COLS = 7;          // host table: p, m, v, numel, first block, flag, tensor

struct Row {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t numel;
  int first;  // the tensor's first block in its launch
  int vec;    // 1: p, g, m, v 16-byte aligned and numel % 4 == 0
};

struct Table {
  int n;
  Row rows[MAX_ROWS];
};
static_assert(sizeof(Row) == 48, "a row is 48 bytes");
static_assert(sizeof(Table) <= 32764, "a kernel's parameters hold at most 32,764 bytes");

struct Hyper {
  float lr, wd, b1, b2, eps, cmd, cvd;
  bool guard;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Hyper& hy) {
  const float pv = p, mv = m, vv = v;
  const float g_wd = g + hy.wd * pv;
  float nm = hy.b1 * mv + (1.f - hy.b1) * g_wd;
  float nv = hy.b2 * vv + (1.f - hy.b2) * g_wd * g_wd;
  if (hy.guard && !isfinite(g)) {
    nm = mv;
    nv = vv;
  }
  const float m_adj = nm / (1.f - hy.cmd);
  const float v_adj = nv / (1.f - hy.cvd);
  float np = pv - (hy.lr * m_adj / (sqrtf(v_adj) + hy.eps) + hy.wd * pv);
  if (hy.guard && !isfinite(np)) np = pv;
  p = np;
  m = nm;
  v = nv;
}

__global__ void __launch_bounds__(THREADS)
adam_multi_tensor(const __grid_constant__ Table table, const float* __restrict__ h) {
  __shared__ int t_sh;
  if (threadIdx.x == 0) {
    int lo = 0, hi = table.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table.rows[mid].first <= (int)blockIdx.x)
        lo = mid;
      else
        hi = mid - 1;
    }
    t_sh = lo;
  }
  __syncthreads();
  const Row& row = table.rows[t_sh];
  float* p = row.p;
  const float* g = row.g;
  float* m = row.m;
  float* v = row.v;
  const int64_t begin = ((int64_t)blockIdx.x - row.first) * CHUNK;
  const int64_t end = row.numel < begin + CHUNK ? row.numel : begin + CHUNK;
  const Hyper hy{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7] > 0.f};
  if (row.vec) {  // begin and end are multiples of 4
    for (int64_t i = begin + 4 * threadIdx.x; i < end; i += 4 * THREADS) {
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      const float4 gv = __ldg(reinterpret_cast<const float4*>(g + i));
      float4 mv = *reinterpret_cast<const float4*>(m + i);
      float4 vv = *reinterpret_cast<const float4*>(v + i);
      update(pv.x, gv.x, mv.x, vv.x, hy);
      update(pv.y, gv.y, mv.y, vv.y, hy);
      update(pv.z, gv.z, mv.z, vv.z, hy);
      update(pv.w, gv.w, mv.w, vv.w, hy);
      *reinterpret_cast<float4*>(p + i) = pv;
      *reinterpret_cast<float4*>(m + i) = mv;
      *reinterpret_cast<float4*>(v + i) = vv;
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += THREADS) {
      float pv = p[i], mv = m[i], vv = v[i];
      update(pv, g[i], mv, vv, hy);
      p[i] = pv;
      m[i] = mv;
      v[i] = vv;
    }
  }
}

}  // namespace

// table: n_rows host rows of COLS int64 (p, m, v, numel > 0, first block
// counted from the start of the row's group of MAX_ROWS rows, flag 1 where
// p, m, v are 16-byte aligned and numel % 4 == 0, the tensor's index into
// grads); grads: the host array of gradient pointers by tensor index;
// h: 8 floats on the device. One launch per group of MAX_ROWS rows; a row
// takes 16-byte accesses only where its gradient is 16-byte aligned too.
extern "C" int rt_adam_f32(const int64_t* table, int n_rows, const int64_t* grads,
                           const float* h, void* stream) {
  Table t;
  for (int start = 0; start < n_rows; start += MAX_ROWS) {
    t.n = n_rows - start < MAX_ROWS ? n_rows - start : MAX_ROWS;
    for (int i = 0; i < t.n; ++i) {
      const int64_t* r = table + (int64_t)(start + i) * COLS;
      Row& row = t.rows[i];
      row.p = (float*)r[0];
      row.m = (float*)r[1];
      row.v = (float*)r[2];
      row.numel = r[3];
      row.first = (int)r[4];
      row.g = (const float*)grads[r[6]];
      row.vec = r[5] != 0 && ((uintptr_t)row.g & 15) == 0;
    }
    const Row& last = t.rows[t.n - 1];
    const int64_t blocks = last.first + (last.numel + CHUNK - 1) / CHUNK;
    adam_multi_tensor<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(t, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
