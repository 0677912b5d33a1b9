"""Pooling forward, as resnet_tpu.ops.pooling: max pool over the
reference's centered windows with -inf padding (doMaxPool,
resnet.cu:433-471), and the global average pool (doFilterAvgPool,
resnet.cu:500-543). NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .padding import reference_padding


def max_pool(x: torch.Tensor, *, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    h_lo, h_hi = reference_padding(x.shape[1], kernel, stride)
    w_lo, w_hi = reference_padding(x.shape[2], kernel, stride)
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C): mean over space."""
    return x.mean(dim=(1, 2))
