"""Direct NHWC convolution: the port of resnet_tpu.kernels.conv.conv2d_pallas.

Reference-centered windows (``ops.padding.reference_padding``): out = in /
stride, taps outside the image skipped. On CUDA tensors ``conv2d`` launches
``csrc/conv.cu`` (or raises); on CPU tensors it runs the plain version
``conv2d_reference`` (``ops.conv.conv2d``: F.pad with the explicit, possibly
negative padding, then F.conv2d). Forward only: the VJP comes with the
training step.
"""

from __future__ import annotations

import torch

from ..ops.conv import conv2d as _plain_conv2d
from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of the launch walks the 64-wide Cout tiles


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Plain version (cuDNN on the card: TF32 must be off to compare)."""
    return _plain_conv2d(x, w, stride=stride)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (N, H, W, Cin) NHWC, w (k, k, Cin, Cout) HWIO, odd square k,
    stride | H and stride | W -> (N, H/stride, W/stride, Cout)."""
    global LAUNCHES
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
    if not build.on_card("conv2d", x, w):
        return conv2d_reference(x, w, stride)
    if -(-cout // 64) > _MAX_N_TILES or kh * kh * cin >= 2**31:
        raise ValueError(f"conv2d: Cout={cout}, k*k*Cin beyond the kernel's grid")
    out = torch.empty((n, h // stride, wd // stride, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        build.launch("rt_conv2d_nhwc_f32", x.data_ptr(), w.data_ptr(),
                     out.data_ptr(), n, h, wd, cin, cout, kh, stride,
                     device=x.device)
        LAUNCHES += 1
    return out
