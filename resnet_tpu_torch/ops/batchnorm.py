"""Batch normalization with the reference's training semantics, NHWC.

The port of resnet_tpu.ops.batchnorm: per-channel statistics over
(N, H, W) of the current batch, biased variance, fp32 statistics, and the
same formula in the same order: inv_std = rsqrt(var + eps),
scale = gamma * inv_std, shift = beta - gamma * mean * inv_std,
y = x * scale + shift. ``batch_moments`` is the plain one-pass Σx, Σx² over
the (N·H·W, C) rows with the closed-form VJP of ops/batchnorm.py:65-98
(d mean/dx = 1/n, d var/dx = 2(x - mean)/n): the autograd Function of the
K4 kernel module run over its plain sums, so the formula lives in one
place and this path never launches the kernel.

Ghost BN (``ExecutionConfig.bn_stats_batch``, ops/batchnorm.py:101-206):
``batch_norm_ghost`` takes the statistics from the first k images and
normalizes the whole batch with them, as one ``torch.autograd.Function``
whose backward is the JAX package's closed form, with no slice transpose:

    dx_i = gamma/sigma * (dy_i - [i<k] * (dbeta + x_hat_i * dgamma) / m_k)

with the full-batch sums dbeta = sum(dy), dgamma = sum(dy * x_hat) and
m_k = k*H*W. It is plain torch ops on every device, as JAX's is XLA's.
``batch_norm_ghost_reference`` is its plain counterpart: autograd of the
sliced-moments formulation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.bn import moments_plain, moments_reference


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


class _GhostBatchNorm(torch.autograd.Function):
    """y = x * scale + shift with the statistics of x[:k]; returns
    (y, mean, var). The backward is the closed form of
    ops/batchnorm.py:146-190, the statistics' own cotangents included."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, k):
        f32 = torch.float32
        # the one-pass sums of ops/batchnorm.py:52-58 over the first k images
        mean, var = moments_reference(x[:k].reshape(-1, x.shape[-1]))
        inv_std = torch.rsqrt(var + eps)
        scale = gamma.to(f32) * inv_std
        shift = beta.to(f32) - gamma.to(f32) * mean * inv_std
        y = (x.to(f32) * scale + shift).to(x.dtype)
        ctx.k = k
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, mean, inv_std)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv_std = ctx.saved_tensors
        k = ctx.k
        f32 = torch.float32
        axes = tuple(range(x.dim() - 1))
        m_k = k
        for d in x.shape[1:-1]:
            m_k *= d
        xf = x.to(f32)
        dyf = torch.zeros_like(xf) if dy is None else dy.to(f32)
        xhat = (xf - mean) * inv_std
        # full-batch sums: these are the parameter gradients
        dbeta = dyf.sum(axes)
        dgamma = (dyf * xhat).sum(axes)
        # the stats-sample mask: the first k images along dim 0
        in_sample = (torch.arange(x.shape[0], device=x.device) < k).view(
            (-1,) + (1,) * (x.dim() - 1))
        zero = torch.zeros((), dtype=f32, device=x.device)
        corr = (dbeta + xhat * dgamma) / m_k
        dx = gamma.to(f32) * inv_std * (dyf - torch.where(in_sample, corr, zero))
        if dmean is not None:
            dx = dx + torch.where(in_sample, dmean.to(f32) / m_k, zero)
        if dvar is not None:
            dx = dx + torch.where(in_sample, dvar.to(f32) * 2.0 * (xf - mean) / m_k, zero)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None, None)


def batch_norm_ghost(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    stats_batch: int,
    *,
    eps: float = 1e-7,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Ghost BN (Hoffer et al. 2017): statistics from the first
    ``stats_batch`` images, normalization over the whole batch. Returns
    (y, (mean, var)); a stats sample of 0 or of the whole batch is plain
    ``batch_norm``."""
    k = int(stats_batch)
    if k <= 0 or k >= x.shape[0]:
        return batch_norm(x, gamma, beta, eps=eps)
    y, mean, var = _GhostBatchNorm.apply(x, gamma, beta, eps, k)
    return y, (mean, var)


def batch_norm_ghost_reference(x, gamma, beta, stats_batch: int, *, eps: float = 1e-7):
    """The plain counterpart of ``batch_norm_ghost``: ``batch_norm`` with
    the moments of the sliced batch, differentiated by autograd (the slice
    included)."""
    mean, var = batch_moments(x[:stats_batch])
    return batch_norm(x, gamma, beta, eps=eps, mean=mean, var=var)


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
