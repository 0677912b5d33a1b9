// Helpers for elementwise passes over an (rows, C) row-major view whose
// element i belongs to channel i mod C (the BN apply, its backward's dx pass
// and the residual join).
//
// The passes are grid-stride loops. Instead of a 64-bit modulo per element,
// each thread computes its first channel once and then advances it by the
// loop's stride mod C on every iteration.
//
// Each pass is one template over its storage type, float or __nv_bfloat16:
// a value is read into a float (ld, Vec16::load), all arithmetic is fp32,
// and a result is rounded once as it is stored (st, Vec16::store). Vec16
// moves 16 bytes at a time: four floats or eight bf16 (unpack and pack
// convert a 16-byte register value, for loads and stores with cache hints).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int EW_THREADS = 256;
constexpr int64_t EW_MAX_BLOCKS = 132 * 16;

inline unsigned ew_blocks(int64_t n) {
  const int64_t b = (n + EW_THREADS - 1) / EW_THREADS;
  return (unsigned)(b < EW_MAX_BLOCKS ? (b > 0 ? b : 1) : EW_MAX_BLOCKS);
}

// The channel of element `first`, then of first + stride, first + 2 stride...
struct ChannelWalk {
  int c, step, C;
  __device__ ChannelWalk(int64_t first, int64_t stride, int C_)
      : c((int)(first % C_)), step((int)(stride % C_)), C(C_) {}
  __device__ void advance() {
    c += step;
    if (c >= C) c -= C;
  }
  // the channel of the element t places after the current one
  __device__ int at(int t) const {
    int ch = c + t;
    while (ch >= C) ch -= C;
    return ch;
  }
};

// max(v, 0), then min(v, cap) when has_cap; a NaN propagates, as
// jnp.maximum and jnp.minimum do
struct Act {
  bool relu, has_cap;
  float cap;
  __device__ float operator()(float v) const {
    if (relu) {
      v = v < 0.f ? 0.f : v;
      if (has_cap) v = v > cap ? cap : v;
    }
    return v;
  }
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 bytes of T at a 16-byte aligned p, as N floats
template <class T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float (&v)[N]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static void load(const float* p, float (&v)[N]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float (&v)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[N]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    *reinterpret_cast<uint4*>(p) = pack(v);
  }
};

__host__ __device__ inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace rt
