"""Plain 2-D convolution with the reference's centered windows (NHWC or
NCHW activations, HWIO weights).

The counterpart of resnet_tpu.ops.conv.conv2d: explicit, possibly negative
(lo, hi) padding from ``reference_padding``, then ``F.conv2d`` with
``padding=0``. An NCHW input goes to ``F.conv2d`` as it is; an NHWC one as
a permuted view (an NHWC tensor viewed as NCHW is channels_last, so no copy
is made), its result permuted back. Weights stay HWIO in both layouts
(resnet_tpu/ops/conv.py:13-15). On the card this is cuDNN, whose fp32
follows ``torch.backends.cudnn.allow_tf32``: the model's entry points set it
from ``ExecutionConfig.matmul_precision`` (``ops.precision``; off under the
default 'highest'), and a check that calls this function directly turns it
off itself (``kernels.checks.fp32_strict``). A bf16 input convolves in bf16
(cuDNN's bf16 with fp32 accumulation on the card), the weight cast to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .padding import reference_padding


def spatial_dims(layout: str) -> Tuple[int, int]:
    return (1, 2) if layout == "NHWC" else (2, 3)


def channel_dim(layout: str) -> int:
    return 3 if layout == "NHWC" else 1


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    layout: str = "NHWC",
    padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    groups: int = 1,
) -> torch.Tensor:
    """x: (N, H, W, C) or (N, C, H, W); w: (kh, kw, C/groups, Cout) HWIO ->
    (N, Ho, Wo, Cout) or (N, Cout, Ho, Wo)."""
    kh, kw = w.shape[0], w.shape[1]
    hdim, wdim = spatial_dims(layout)
    if padding is None:
        padding = (
            reference_padding(x.shape[hdim], kh, stride),
            reference_padding(x.shape[wdim], kw, stride),
        )
    (h_lo, h_hi), (w_lo, w_hi) = padding
    w_oihw = w.to(x.dtype).permute(3, 2, 0, 1)
    if layout == "NCHW":
        xp = F.pad(x, (w_lo, w_hi, h_lo, h_hi))
        return F.conv2d(xp, w_oihw, stride=stride, groups=groups)
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w_oihw, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()
