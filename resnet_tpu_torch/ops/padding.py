"""Reference-compatible convolution/pool window geometry.

The reference computes ``out = in // stride`` and centers each window at
``stride * out_pos`` with offsets ``-k//2 .. +k//2``, skipping out-of-bounds
taps (doConvolution, resnet.cu:109-157). That is not torch's symmetric
``padding=k//2``: for k=7, s=2, in=224 the reference pads (3, 2), so the
port always pads explicitly. Same contract as resnet_tpu.ops.padding.
"""

from __future__ import annotations

from typing import Tuple


def reference_padding(in_dim: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(lo, hi) explicit padding reproducing the reference's centered windows.

    out = in_dim // stride; window o spans [s*o - k//2, s*o + k//2].
    hi may be negative, meaning the window grid crops the input.
    """
    if in_dim % stride != 0:
        raise ValueError(
            f"reference conv geometry requires stride | in_dim, got {in_dim}/{stride}"
        )
    out = in_dim // stride
    half = kernel // 2
    lo = half
    hi = stride * (out - 1) + half - (in_dim - 1)
    return lo, hi
