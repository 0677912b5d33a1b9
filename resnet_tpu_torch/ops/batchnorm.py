"""Batch normalization, eval path (running statistics).

Same formula, in the same order, as resnet_tpu.ops.batchnorm.batch_norm:
fp32 statistics, inv_std = rsqrt(var + eps), scale = gamma * inv_std,
shift = beta - gamma * mean * inv_std, y = x * scale + shift. Activations
are NHWC, so the per-channel rows broadcast over the last axis. Batch
statistics belong to the training step (ROADMAP.md queue A, item A2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import ROADMAP_TRAIN, not_ported


def batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-7,
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BN with the given (mean, var). Returns (y, (mean, var))."""
    if mean is None or var is None:
        raise not_ported("batch-statistics BN", ROADMAP_TRAIN)
    f32 = torch.float32
    mean, var = mean.to(f32), var.to(f32)
    inv_std = torch.rsqrt(var + eps)
    scale = gamma.to(f32) * inv_std
    shift = beta.to(f32) - gamma.to(f32) * mean * inv_std
    y = x.to(f32) * scale + shift
    return y.to(x.dtype), (mean, var)


def batch_norm_inference(x, gamma, beta, running_mean, running_var, *,
                         eps: float = 1e-7) -> torch.Tensor:
    y, _ = batch_norm(x, gamma, beta, eps=eps, mean=running_mean,
                      var=running_var)
    return y
