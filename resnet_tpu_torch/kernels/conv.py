"""Direct NHWC convolution and its VJP: the port of
resnet_tpu.kernels.conv.conv2d_pallas.

Reference-centered windows (``ops.padding.reference_padding``): out = in /
stride, taps outside the image skipped. ``conv2d`` is a
``torch.autograd.Function``. On CUDA tensors its forward launches the conv
kernel of ``csrc/conv.cu``, and its backward the two gradient kernels of the
same file (dx only when the input needs a gradient, dW only when the weight
does); anything the kernels do not take raises. All three run on the
split-TF32 tensor-core GEMM of ``csrc/tc_gemm.cuh`` (fp32 accurate), each
splitting K by ``build.tc_split`` (dx at stride 1 only); the forward gathers its input through
the fused conv's im2col (``csrc/im2col.cuh``) without the prologue. On CPU
tensors each of the three runs its plain version:

* ``conv2d_reference``: F.pad with the explicit, possibly negative padding,
  then F.conv2d (``ops.conv.conv2d``);
* ``conv2d_dx_reference``: the JAX VJP's recipe (conv.py:150-170): dilate the
  gradient by the stride, pad, and convolve with the flipped, transposed
  filter, then crop;
* ``conv2d_dw_reference``: per tap, the strided window of the padded input
  contracted with the gradient over (N, Ho, Wo) (conv.py:172-196).

The counters ``LAUNCHES``, ``DX_LAUNCHES`` and ``DW_LAUNCHES`` count the
launches of the forward, dx and dW kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d as _plain_conv2d
from ..ops.padding import reference_padding
from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of a launch walks the 64- or 128-wide column tiles


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain forward (cuDNN on the card: TF32 must be off to compare)."""
    return _plain_conv2d(x, w, stride=stride)


def _dilate(g: torch.Tensor, s: int) -> torch.Tensor:
    """Insert s - 1 zeros between spatial elements (conv.py::_dilate)."""
    if s == 1:
        return g
    n, h, w, c = g.shape
    z = g.new_zeros((n, h, s, w, s, c))
    z[:, :, 0, :, 0, :] = g
    return z.reshape(n, h * s, w * s, c)[:, : (h - 1) * s + 1, : (w - 1) * s + 1, :]


def conv2d_dx_reference(g: torch.Tensor, w: torch.Tensor, x_shape, stride: int = 1
                        ) -> torch.Tensor:
    """Plain dx: conv of the dilated gradient with the flipped, transposed
    filter, cropped to the input grid."""
    n, h, wd, cin = x_shape
    k = w.shape[0]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = (reference_padding(h, k, stride),
                                      reference_padding(wd, k, stride))
    w_flip = torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)
    pad = ((k - 1 - ph_lo, k - 1 - ph_hi + (h + ph_lo + ph_hi - k) % stride),
           (k - 1 - pw_lo, k - 1 - pw_hi + (wd + pw_lo + pw_hi - k) % stride))
    dx = _plain_conv2d(_dilate(g, stride), w_flip, stride=1, padding=pad)
    return dx[:, :h, :wd, :].contiguous()


def conv2d_dw_reference(x: torch.Tensor, g: torch.Tensor, k: int, stride: int = 1
                        ) -> torch.Tensor:
    """Plain dW (k, k, Cin, Cout): per-tap windows of x times g."""
    n, h, wd, cin = x.shape
    ho, wo, cout = g.shape[1], g.shape[2], g.shape[3]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = (reference_padding(h, k, stride),
                                      reference_padding(wd, k, stride))
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    # guarantee slice bounds for the largest tap
    pad_h = max(0, (k - 1) + (ho - 1) * stride + 1 - xp.shape[1])
    pad_w = max(0, (k - 1) + (wo - 1) * stride + 1 - xp.shape[2])
    if pad_h or pad_w:
        xp = F.pad(xp, (0, 0, 0, pad_w, 0, pad_h))
    g2 = g.reshape(n * ho * wo, cout)
    taps = [[xp[:, i:i + (ho - 1) * stride + 1:stride,
                j:j + (wo - 1) * stride + 1:stride, :].reshape(-1, cin).t() @ g2
             for j in range(k)] for i in range(k)]
    return torch.stack([torch.stack(row) for row in taps])


def _shapes(x: torch.Tensor, w: torch.Tensor, stride: int) -> Tuple[int, ...]:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d: x {tuple(x.shape)}, w {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if kh != kw or kh % 2 == 0 or wcin != cin:
        raise ValueError(
            f"conv2d: w {tuple(w.shape)} must be (k, k, {cin}, Cout) with odd k"
        )
    if stride < 1 or h % stride or wd % stride:
        raise ValueError(f"conv2d: stride {stride} must divide {h}x{wd}")
    return n, h, wd, cin, cout, kh


def _forward(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    global LAUNCHES
    n, h, wd, cin, cout, k = _shapes(x, w, stride)
    if not build.on_card("conv2d", x, w):
        return conv2d_reference(x, w, stride)
    if -(-cout // 64) > _MAX_N_TILES or k * k * cin >= 2**31:
        raise ValueError(f"conv2d: Cout={cout}, k*k*Cin beyond the kernel's grid")
    out = torch.empty((n, h // stride, wd // stride, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        m = n * (h // stride) * (wd // stride)
        splits = build.tc_split(m, cout, k * k * cin)
        ws_ptr, _ws = build.gemm_workspace(splits, m, cout, x)
        build.launch("rt_conv2d_nhwc_f32", x.data_ptr(), w.data_ptr(),
                     out.data_ptr(), n, h, wd, cin, cout, k, stride, ws_ptr, splits,
                     device=x.device)
        LAUNCHES += 1
    return out


def phase_taps(p: int, k: int, s: int) -> Tuple[int, int]:
    """(first, count): the taps i = first + s*t of a k-wide window that reach
    input rows of phase p (iy mod s = p); csrc/conv.cu PhaseTaps."""
    first = (p + k // 2) % s
    return first, ((k - 1 - first) // s + 1 if first < k else 0)


def dx_phase_weights(w: torch.Tensor, stride: int) -> torch.Tensor:
    """The B operands of the dx kernel: for each phase (py, px) in row-major
    order, the taps that reach it of w^T (k, k, Cout, Cin), as one
    contiguous (taps * Cout, Cin) block after another (a small torch op on
    the weight, as the flip and transpose are jnp ops in the JAX VJP)."""
    k, cin = w.shape[0], w.shape[2]
    wt = w.permute(0, 1, 3, 2)
    parts = [wt[phase_taps(py, k, stride)[0]::stride,
                phase_taps(px, k, stride)[0]::stride].reshape(-1, cin)
             for py in range(stride) for px in range(stride)]
    return torch.cat(parts).contiguous()


def conv2d_dx(g: torch.Tensor, w: torch.Tensor, x_shape, stride: int = 1) -> torch.Tensor:
    """dx (N, H, W, Cin) of ``conv2d`` from its output gradient
    g (N, H/s, W/s, Cout) and the weight w (k, k, Cin, Cout)."""
    global DX_LAUNCHES
    n, h, wd, cin = x_shape
    k, cout = w.shape[0], w.shape[3]
    if tuple(g.shape) != (n, h // stride, wd // stride, cout):
        raise ValueError(f"conv2d_dx: g {tuple(g.shape)} for x {tuple(x_shape)}")
    if not build.on_card("conv2d_dx", g, w):
        return conv2d_dx_reference(g, w, x_shape, stride)
    if -(-cin // 64) > _MAX_N_TILES or k * k * cout >= 2**31:
        raise ValueError(f"conv2d_dx: Cin={cin}, k*k*Cout beyond the kernel's grid")
    dx = torch.empty((n, h, wd, cin), dtype=g.dtype, device=g.device)
    if dx.numel():
        if g.numel() == 0:
            return dx.zero_()
        wp = dx_phase_weights(w, stride)
        m = n * h * wd
        # a K split only at stride 1: the phases of a strided dx write rows
        # that are not contiguous
        splits = build.tc_split(m, cin, k * k * cout) if stride == 1 else 1
        ws_ptr, _ws = build.gemm_workspace(splits, m, cin, g)
        build.launch("rt_conv2d_dx_nhwc_f32", g.data_ptr(), wp.data_ptr(),
                     dx.data_ptr(), n, h, wd, cin, cout, k, stride, ws_ptr, splits,
                     device=g.device)
        DX_LAUNCHES += 1
    return dx


def conv2d_dw(x: torch.Tensor, g: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """dW (k, k, Cin, Cout) of ``conv2d`` from its input x (N, H, W, Cin) and
    output gradient g (N, H/s, W/s, Cout)."""
    global DW_LAUNCHES
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    if tuple(g.shape) != (n, h // stride, wd // stride, cout):
        raise ValueError(f"conv2d_dw: g {tuple(g.shape)} for x {tuple(x.shape)}")
    if not build.on_card("conv2d_dw", x, g):
        return conv2d_dw_reference(x, g, k, stride)
    pixels = n * (h // stride) * (wd // stride)
    if -(-cout // 64) > _MAX_N_TILES or pixels >= 2**31:
        raise ValueError(f"conv2d_dw: Cout={cout}, N*Ho*Wo beyond the kernel's grid")
    dw = torch.empty((k, k, cin, cout), dtype=x.dtype, device=x.device)
    if dw.numel():
        if pixels == 0:
            return dw.zero_()
        splits = build.tc_split(k * k * cin, cout, pixels)
        ws_ptr, _ws = build.gemm_workspace(splits, k * k * cin, cout, x)
        build.launch("rt_conv2d_dw_nhwc_f32", x.data_ptr(), g.data_ptr(),
                     dw.data_ptr(), n, h, wd, cin, cout, k, stride, ws_ptr, splits,
                     device=x.device)
        DW_LAUNCHES += 1
    return dw


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return _forward(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand over a strided view
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dx(g, w, x.shape, ctx.stride)
        if ctx.needs_input_grad[1]:
            dw = conv2d_dw(x, g, w.shape[0], ctx.stride)
        return dx, dw, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N, H, W, Cin) NHWC, w (k, k, Cin, Cout) HWIO, odd square k,
    stride | H and stride | W -> (N, H/stride, W/stride, Cout).
    Differentiable in x and w."""
    _shapes(x, w, stride)
    return _Conv2d.apply(x, w, stride)
