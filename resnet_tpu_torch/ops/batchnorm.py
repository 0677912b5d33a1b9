"""Batch normalization with the reference's training semantics, NHWC or
NCHW: the statistics reduce every dimension but the channel one, and the
per-channel rows broadcast along it (resnet_tpu/ops/batchnorm.py:28-39).

The port of resnet_tpu.ops.batchnorm: per-channel statistics over
(N, H, W) of the current batch, biased variance, fp32 statistics, and the
same formula in the same order: inv_std = rsqrt(var + eps),
scale = gamma * inv_std, shift = beta - gamma * mean * inv_std,
y = x * scale + shift, in fp32 and cast to x's dtype (so a bf16 activation
is normalized in fp32 and rounded once). ``batch_moments`` is the plain
one-pass Σx, Σx² in fp32 over the (N·H·W, C) rows, or over (N, H, W) of an
NCHW tensor, with the closed-form VJP of ops/batchnorm.py:65-98
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
Inside ``kernels.bn.sync_stats`` the sample is the first k images of the
statistics group's global batch: each rank sums the rows it holds of them
(perhaps none) and the group sums the sums (``kernels.bn.summed``); the
backward's sums dbeta and dgamma in the correction are the group's, the
parameter gradients this rank's.
``batch_norm_ghost_reference`` is its plain counterpart: autograd of the
sliced-moments formulation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.bn import (
    mean_var_from_sums,
    moments_plain,
    moments_reference,
    moments_sums_reference,
    sample_rows,
    stats_group,
    summed,
)
from .conv import channel_dim


def _param_shape(x_ndim: int, layout: str) -> Tuple[int, ...]:
    """The shape that broadcasts a (C,) row along x's channel dimension."""
    if layout == "NHWC":
        return (1,) * (x_ndim - 1) + (-1,)
    return (1, -1) + (1,) * (x_ndim - 2)


def batch_moments(x: torch.Tensor, layout: str = "NHWC"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) of an NHWC or NCHW tensor, fp32;
    differentiable through the closed-form VJP."""
    if layout == "NHWC":
        return moments_plain(x.reshape(-1, x.shape[-1]))
    return moments_plain(x, channel_dim=1)


def batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-7,
    layout: str = "NHWC",
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training-mode BN (batch statistics) unless mean and var are given
    (eval or frozen mode). Returns (y, (mean, var)) with fp32 statistics."""
    if mean is None or var is None:
        mean, var = batch_moments(x, layout)
    f32 = torch.float32
    shape = _param_shape(x.dim(), layout)
    mean, var = mean.to(f32), var.to(f32)
    inv_std = torch.rsqrt(var + eps)
    scale = gamma.to(f32) * inv_std
    shift = beta.to(f32) - gamma.to(f32) * mean * inv_std
    y = x.to(f32) * scale.view(shape) + shift.view(shape)
    return y.to(x.dtype), (mean, var)


class _GhostBatchNorm(torch.autograd.Function):
    """y = x * scale + shift with the statistics of the first k images;
    returns (y, mean, var). The backward is the closed form of
    ops/batchnorm.py:146-190, the statistics' own cotangents included.

    With ``reduce`` (a statistics group's in-place sum, ``kernels.bn.
    sync_stats``) the k images are the first of the group's global batch,
    of which x holds the rows from ``first`` on: this rank sums those of
    its rows that are in the sample (perhaps none), and the group sums the
    sums and their row count. The backward's correction takes the group's
    full-batch sums of dy and dy * x_hat and the group's statistics'
    cotangents (one all-reduce); the gradients of gamma and beta stay this
    rank's, which the step's gradient bucket sums."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, k, layout, reduce=None, first=0):
        f32 = torch.float32
        shape = _param_shape(x.dim(), layout)
        cdim = channel_dim(layout)
        # the rows of x in the stats sample
        k_here = min(max(k - first, 0), x.shape[0])
        # the one-pass sums of ops/batchnorm.py:52-58 over the first k images
        if reduce is None:
            m_k = k * (x[:1].numel() // x.shape[cdim])
            if layout == "NHWC":
                mean, var = moments_reference(x[:k].reshape(-1, x.shape[-1]))
            else:
                mean, var = moments_reference(x[:k], cdim)
        else:
            part = x[:k_here]
            sums = torch.stack(moments_sums_reference(
                part.reshape(-1, x.shape[-1]) if layout == "NHWC" else part,
                -1 if layout == "NHWC" else cdim))
            total, m_k = summed(reduce, sums, part.numel() // x.shape[cdim])
            mean, var = mean_var_from_sums(total[0], total[1], m_k)
        inv_std = torch.rsqrt(var + eps)
        scale = gamma.to(f32) * inv_std
        shift = beta.to(f32) - gamma.to(f32) * mean * inv_std
        y = (x.to(f32) * scale.view(shape) + shift.view(shape)).to(x.dtype)
        ctx.k, ctx.layout, ctx.m_k, ctx.reduce = k_here, layout, m_k, reduce
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, gamma, mean, inv_std)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, inv_std = ctx.saved_tensors
        k, m_k, reduce = ctx.k, ctx.m_k, ctx.reduce
        f32 = torch.float32
        shape = _param_shape(x.dim(), ctx.layout)
        cdim = channel_dim(ctx.layout)
        axes = tuple(d for d in range(x.dim()) if d != cdim)
        gamma, mean, inv_std = gamma.view(shape), mean.view(shape), inv_std.view(shape)
        xf = x.to(f32)
        dyf = torch.zeros_like(xf) if dy is None else dy.to(f32)
        xhat = (xf - mean) * inv_std
        # full-batch sums: these are the parameter gradients
        dbeta = dyf.sum(axes)
        dgamma = (dyf * xhat).sum(axes)
        sum_beta, sum_gamma = dbeta, dgamma
        if reduce is not None:
            # the group's full-batch sums and statistics' cotangents
            c = dbeta.numel()
            zero_c = torch.zeros(c, dtype=f32, device=x.device)
            both = torch.cat([dbeta, dgamma, zero_c if dmean is None else dmean.to(f32),
                              zero_c if dvar is None else dvar.to(f32)])
            reduce(both)
            sum_beta, sum_gamma, dmean, dvar = both.view(4, c).unbind(0)
        # the stats-sample mask: the first k images along dim 0
        in_sample = (torch.arange(x.shape[0], device=x.device) < k).view(
            (-1,) + (1,) * (x.dim() - 1))
        zero = torch.zeros((), dtype=f32, device=x.device)
        corr = (sum_beta.view(shape) + xhat * sum_gamma.view(shape)) / m_k
        dx = gamma.to(f32) * inv_std * (dyf - torch.where(in_sample, corr, zero))
        if dmean is not None:
            dx = dx + torch.where(in_sample, dmean.to(f32).view(shape) / m_k, zero)
        if dvar is not None:
            dx = dx + torch.where(in_sample,
                                  dvar.to(f32).view(shape) * 2.0 * (xf - mean) / m_k, zero)
        return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype),
                None, None, None, None, None)


def batch_norm_ghost(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    stats_batch: int,
    *,
    eps: float = 1e-7,
    layout: str = "NHWC",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Ghost BN (Hoffer et al. 2017): statistics from the first
    ``stats_batch`` images, normalization over the whole batch. Returns
    (y, (mean, var)); a stats sample of 0 or of the whole batch is plain
    ``batch_norm``. Inside ``kernels.bn.sync_stats`` the batch is the
    group's global batch (``kernels.bn.sample_rows``)."""
    k = int(stats_batch)
    n_all, first = sample_rows(x.shape[0])
    if k <= 0 or k >= n_all:
        return batch_norm(x, gamma, beta, eps=eps, layout=layout)
    group = stats_group()
    if group is None:
        y, mean, var = _GhostBatchNorm.apply(x, gamma, beta, eps, k, layout)
    else:
        y, mean, var = _GhostBatchNorm.apply(x, gamma, beta, eps, k, layout, group.reduce,
                                             first)
    return y, (mean, var)


def batch_norm_ghost_reference(x, gamma, beta, stats_batch: int, *, eps: float = 1e-7,
                               layout: str = "NHWC"):
    """The plain counterpart of ``batch_norm_ghost``: ``batch_norm`` with
    the moments of the sliced batch, differentiated by autograd (the slice
    included)."""
    mean, var = batch_moments(x[:stats_batch], layout)
    return batch_norm(x, gamma, beta, eps=eps, layout=layout, mean=mean, var=var)


def batch_norm_inference(x, gamma, beta, running_mean, running_var, *,
                         eps: float = 1e-7, layout: str = "NHWC") -> torch.Tensor:
    y, _ = batch_norm(x, gamma, beta, eps=eps, layout=layout, mean=running_mean,
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
