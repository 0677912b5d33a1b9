"""Activations, as resnet_tpu.ops.activation: the forward is where(x > 0, x, 0)
(doActivation, resnet.cu:545-566); relu_cap clips at the cuDNN-fast
variant's ceiling (resnet_cudnn_fast.cu:1143-1145)."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.zeros_like(x))


def relu_cap(x: torch.Tensor, cap: float = 10.0) -> torch.Tensor:
    return torch.clamp(x, 0.0, cap)
