"""Fully-connected layer: x @ w (+ b), w stored (in, out) as in
resnet_tpu.ops.linear. The reference FC has no bias (resnet.cu:1759)."""

from __future__ import annotations

from typing import Optional

import torch


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
