// The K-major im2col gather of a conv's input for tc_gemm.cuh's gemm_k and
// wg_gemm.cuh's gemm, shared by the conv forward (K1, conv.cu, without a
// prologue), the fused conv (K8, fused_conv.cuh, with one) and K10's three
// GEMMs (block_fused.cu, with one).
//
// Row (n, oy, ox) of the GEMM is one output pixel, column (di, dj, ci) one
// tap and input channel: A(m, k) = x[n, s*oy - pad_top + di,
// s*ox - pad_left + dj, ci], 0 outside the image. The window origin is an
// explicit padding, so the reference's centred windows (pad k/2 on both
// sides, ops/padding.py), the stem's (3, 2) among them, and any other
// padding take one path, and a stride gathers directly. A copying thread
// decodes its rows once and walks a (di, dj, ci) cursor by BK columns with
// carries; where Cin % 32 == 0 a K-step is one tap, at the stem (Cin = 3)
// one step crosses about 11 taps.
//
// kPrologue (K8, K10): each element read is rewritten in shared memory, once its
// slice has landed, to act(__fadd_rn(__fmul_rn(v, scale[ci]), shift[ci]))
// (rounded step by step as the plain version is); elements outside the
// image were zero-filled and stay exactly 0. Without it (K1) gemm_k's
// `if constexpr (ALoader::kPrologue)` compiles the pass out, and scale,
// shift, prologue and act are never read.
#pragma once

#include "rowwise.cuh"  // Act
#include "tc_gemm.cuh"

namespace {

template <bool kPro>
struct Im2colTcA {
  static constexpr bool kKMajor = true;
  static constexpr bool kPrologue = kPro;
  const float* __restrict__ x;
  const float* __restrict__ scale;
  const float* __restrict__ shift;
  int H, W, Cin, ksize;
  int HoWo, Wo, stride, pad_top, pad_left;
  bool prologue;
  rt::Act act;
  int64_t M;

  // the window's top-left input pixel and x's offset there
  struct Row {
    long long off;
    int iy, ix;
    bool ok;
  };
  struct Cursor {
    int di, dj, ci;
  };

  __device__ Row row(int64_t m) const {
    Row r;
    r.ok = m < M;
    const int64_t mm = r.ok ? m : 0;
    const int64_t n = mm / HoWo;
    const int rem = (int)(mm - n * HoWo);
    const int oy = rem / Wo;
    r.iy = stride * oy - pad_top;
    r.ix = stride * (rem - oy * Wo) - pad_left;
    r.off = ((n * H + r.iy) * W + r.ix) * Cin;
    return r;
  }

  __device__ Cursor cursor(int64_t k) const {
    Cursor c;
    const int tap = (int)(k / Cin);
    c.ci = (int)(k - (int64_t)tap * Cin);
    c.di = tap / ksize;
    c.dj = tap - c.di * ksize;
    return c;
  }

  __device__ void advance(Cursor& c) const {
    c.ci += rt::tc::BK;
    while (c.ci >= Cin) {
      c.ci -= Cin;
      if (++c.dj == ksize) {
        c.dj = 0;
        ++c.di;
      }
    }
  }

  __device__ bool in(const Row& r, const Cursor& c) const {
    const int iy = r.iy + c.di;
    const int ix = r.ix + c.dj;
    return r.ok && iy >= 0 && iy < H && ix >= 0 && ix < W;  // else the halo
  }

  __device__ const float* at(const Row& r, const Cursor& c) const {
    return x + r.off + ((long long)c.di * W + c.dj) * Cin + c.ci;
  }

  // the prologue of v given its channel's (scale, shift)
  __device__ float affine(float v, float sc, float sh) const {
    return act(__fadd_rn(__fmul_rn(v, sc), sh));
  }

  // the prologue of the element read at channel c.ci + j
  __device__ float apply(float v, const Cursor& c, int j) const {
    const int ch = c.ci + j;
    return affine(v, __ldg(scale + ch), __ldg(shift + ch));
  }

  // the (scale, shift) of channels c.ci .. c.ci + 3 in two 16-byte loads
  // (Cin a multiple of 4, scale and shift 16-byte aligned)
  __device__ void affine4(const Cursor& c, float4& sc, float4& sh) const {
    sc = __ldg(reinterpret_cast<const float4*>(scale + c.ci));
    sh = __ldg(reinterpret_cast<const float4*>(shift + c.ci));
  }

  __device__ int64_t out_row(int64_t m) const { return m; }
};

// The gather of x (N, H, W, Cin) for a k x k window at stride `stride` whose
// origin is (pad_top, pad_left) above and left of the input, output (Ho, Wo);
// no prologue (the caller sets it for kPro)
template <bool kPro>
inline Im2colTcA<kPro> im2col(const float* x, int N, int H, int W, int Cin, int k, int stride,
                              int pad_top, int pad_left, int Ho, int Wo) {
  Im2colTcA<kPro> a;
  a.x = x;
  a.scale = a.shift = nullptr;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.ksize = k;
  a.Wo = Wo;
  a.HoWo = Ho * Wo;
  a.stride = stride;
  a.pad_top = pad_top;
  a.pad_left = pad_left;
  a.prologue = false;
  a.act = rt::Act{false, false, 0.f};
  a.M = (int64_t)N * Ho * Wo;
  return a;
}

}  // namespace
