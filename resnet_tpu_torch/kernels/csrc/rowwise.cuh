// Helpers for elementwise passes over an (rows, C) row-major view whose
// element i belongs to channel i mod C (the BN apply, its backward's dx pass
// and the residual join).
//
// The passes are grid-stride loops. Instead of a 64-bit modulo per element,
// each thread computes its first channel once and then advances it by the
// loop's stride mod C on every iteration.
#pragma once

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

}  // namespace rt
