"""Plain 2-D convolution with the reference's centered windows (NHWC, HWIO).

The counterpart of resnet_tpu.ops.conv.conv2d: explicit, possibly negative
(lo, hi) padding from ``reference_padding``, then ``F.conv2d`` with
``padding=0`` on a permuted view (an NHWC tensor viewed as NCHW is
channels_last, so no copy is made). On the card this is cuDNN, whose fp32
follows ``torch.backends.cudnn.allow_tf32``: the model's entry points set it
from ``ExecutionConfig.matmul_precision`` (``ops.precision``; off under the
default 'highest'), and a check that calls this function directly turns it
off itself (``kernels.checks.fp32_strict``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .padding import reference_padding


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    groups: int = 1,
) -> torch.Tensor:
    """x: (N, H, W, C); w: (kh, kw, C/groups, Cout) HWIO -> (N, Ho, Wo, Cout)."""
    kh, kw = w.shape[0], w.shape[1]
    if padding is None:
        padding = (
            reference_padding(x.shape[1], kh, stride),
            reference_padding(x.shape[2], kw, stride),
        )
    (h_lo, h_hi), (w_lo, w_hi) = padding
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(
        xp.permute(0, 3, 1, 2),
        w.to(x.dtype).permute(3, 2, 0, 1),
        stride=stride,
        groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()
