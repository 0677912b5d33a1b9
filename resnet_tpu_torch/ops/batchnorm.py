"""Batch normalization with the reference's training semantics, NHWC.

The port of resnet_tpu.ops.batchnorm: per-channel statistics over
(N, H, W) of the current batch, biased variance, fp32 statistics, and the
same formula in the same order: inv_std = rsqrt(var + eps),
scale = gamma * inv_std, shift = beta - gamma * mean * inv_std,
y = x * scale + shift. ``batch_moments`` is the plain one-pass Σx, Σx² over
the (N·H·W, C) rows with the closed-form VJP of ops/batchnorm.py:65-98
(d mean/dx = 1/n, d var/dx = 2(x - mean)/n): the autograd Function of the
K4 kernel module run over its plain sums, so the formula lives in one
place and this path never launches the kernel. Ghost BN
(``bn_stats_batch > 0``) is not ported (ROADMAP.md queue A, item A2b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.bn import moments_plain


def batch_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) of an NHWC tensor, fp32; differentiable
    through the closed-form VJP."""
    return moments_plain(x.reshape(-1, x.shape[-1]))


def batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-7,
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training-mode BN (batch statistics) unless mean and var are given
    (eval or frozen mode). Returns (y, (mean, var)) with fp32 statistics."""
    if mean is None or var is None:
        mean, var = batch_moments(x)
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


def update_running_stats(
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    momentum: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA of the inference statistics: m * running + (1 - m) * batch, with
    m and 1 - m the fp32 values of ops/batchnorm.py:260-273 (held as Python
    floats, so no device scalar is made)."""
    m32 = torch.tensor(momentum, dtype=torch.float32)
    m, rest = m32.item(), (1 - m32).item()
    return m * running_mean + rest * mean, m * running_var + rest * var
