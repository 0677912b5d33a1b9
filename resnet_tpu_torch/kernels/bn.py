"""Batch norm on an (M, C) view: the port of resnet_tpu.kernels.bn, its
three Pallas kernels (K4 statistics, K5 apply, K6 backward) and
``batch_norm_act``.

K4, one-read statistics.

``moments(x2d)`` gives the per-channel (mean, biased var) of an (M, C) view,
with the epilogue of bn.py:83-86: mean = Σx / M, var = max(Σx² / M − mean², 0).
It is a ``torch.autograd.Function``. On a CUDA tensor its forward launches
``rt_moments_f32`` (``csrc/moments.cu``, two passes: chunk partials, then
their sum per channel); anything the kernel does not take raises. On a CPU
tensor the plain version ``moments_reference`` runs: the same two sums in
torch. The backward is the closed form of bn.py:120-125 in torch ops,
dx = dmean / M + dvar · 2(x − mean) / M; the JAX package has no kernel for it
either. ``moments_plain`` is the same Function over the plain sums on any
device: the plain path's batch statistics (``ops.batchnorm.batch_moments``).

K5, the apply. ``bn_apply(x2d, scale, shift, relu=..., cap=None)`` is
clip(relu(x · scale + shift)) per channel (bn.py:134-160). On a CUDA tensor it
launches ``rt_bn_apply_f32`` (``csrc/bn.cu``); on a CPU tensor the plain
``bn_apply_reference`` runs. It has no gradient of its own: its callers
(``batch_norm_act`` here, ``fused.bias_act``) carry it in their Functions.

K6, the backward. ``batch_norm_act(x2d, gamma, beta, eps, relu)`` is the
training-mode BN(+ReLU) of bn.py:250-285: forward K4 then K5, returning
(y, mean, var) with the statistics not differentiated; backward
``bn_bwd``, the two-pass reduction s1 = Σdy_g, s2 = Σdy_g·x̂ (dy gated by the
recomputed ReLU) then dx = γ·inv_std·(dy_g − s1/M − x̂·s2/M), dγ = s2,
dβ = s1, launched as ``rt_bn_bwd_f32`` on a CUDA tensor, ``bn_bwd_reference``
on a CPU one. ``bn_act_reference`` (bn.py:288-299) is plain torch ops that
autograd differentiates, the yardstick of the whole.

``mean_var_from_sums`` (the statistics' epilogue) and ``bn_apply_bwd`` (the
apply's backward in torch ops) are shared with the fused engine's
``kernels.fused_conv`` and ``fused.bias_act``.

No model path of the JAX package calls ``batch_norm_act``; it is a public
entry point of its kernels package, and so of this one.

``LAUNCHES`` counts K4 launches, ``APPLY_LAUNCHES`` K5 and ``BWD_LAUNCHES``
K6 (one per backward, its three kernels together).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
APPLY_LAUNCHES = 0
BWD_LAUNCHES = 0
_CHANNEL_TILE = 32  # csrc/moments.cu CT
_TARGET_BLOCKS = 132 * 8  # about eight first-pass blocks per SM
_MAX_CHUNKS = 65535  # gridDim.y of the first pass


def mean_var_from_sums(s: torch.Tensor, s2: torch.Tensor, m: int):
    """(mean, biased var) from per-channel Σx and Σx² over m rows
    (bn.py:83-86)."""
    mean = s / m
    var = torch.clamp_min(s2 / m - mean * mean, 0.0)
    return mean, var


def moments_reference(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: Σx and Σx² over rows in torch, then the epilogue."""
    x = x2d.to(torch.float32)
    return mean_var_from_sums(x.sum(0), (x * x).sum(0), x2d.shape[0])


def chunk_rows(m: int, c: int) -> int:
    """Rows per first-pass block: about _TARGET_BLOCKS blocks in all, a
    multiple of 8, at least 64."""
    tiles = -(-c // _CHANNEL_TILE)
    chunks = max(1, -(-_TARGET_BLOCKS // tiles))
    rows = -(-m // chunks)
    rows = max(64, -(-rows // 8) * 8, -(-m // _MAX_CHUNKS))
    return rows


def _forward(x2d: torch.Tensor):
    global LAUNCHES
    if x2d.dim() != 2:
        raise ValueError(f"moments: expected (M, C), got {tuple(x2d.shape)}")
    m, c = x2d.shape
    if not build.on_card("moments", x2d):
        return moments_reference(x2d)
    if m == 0 or c == 0:
        raise ValueError(f"moments: empty input {tuple(x2d.shape)}")
    chunk = chunk_rows(m, c)
    n_chunks = -(-m // chunk)
    part = torch.empty((n_chunks, 2, c), dtype=torch.float32, device=x2d.device)
    mean = torch.empty((c,), dtype=torch.float32, device=x2d.device)
    var = torch.empty_like(mean)
    build.launch("rt_moments_f32", x2d.data_ptr(), part.data_ptr(), mean.data_ptr(),
                 var.data_ptr(), m, c, chunk, n_chunks, device=x2d.device)
    LAUNCHES += 1
    return mean, var


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, value):
        mean, var = value(x2d)
        ctx.save_for_backward(x2d, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x2d, mean = ctx.saved_tensors
        m = x2d.shape[0]
        dx = dmean / m + dvar * 2.0 * (x2d.to(torch.float32) - mean) / m
        return dx.to(x2d.dtype), None


def moments(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable one-read (mean, var) over the rows of x2d (M, C)."""
    return _Moments.apply(x2d, _forward)


def moments_plain(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moments`` with the plain sums on every device; never launches."""
    return _Moments.apply(x2d, moments_reference)


# --------------------------------------------------------------- K5 apply


def bn_apply_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                       relu: bool, cap=None) -> torch.Tensor:
    """Plain version: x · scale + shift, then ReLU and the cap, in torch,
    with scale and shift over the last dimension of x."""
    y = x * scale + shift
    if relu:
        y = torch.clamp_min(y, 0.0)
        if cap is not None:
            y = torch.clamp_max(y, cap)
    return y


def bn_apply_bwd(x, dy, scale, shift, *, relu: bool, cap=None):
    """(dx, dscale, dshift) of ``bn_apply`` at dy, in torch ops: the gate
    recomputed from x (fused.py:104-117, fused_conv.py:219-236)."""
    if relu:
        v = x * scale + shift
        gate = v > 0 if cap is None else (v > 0) & (v < cap)
        dy = torch.where(gate, dy, torch.zeros_like(dy))
    axes = tuple(range(x.dim() - 1))
    return dy * scale, (dy * x).sum(axes), dy.sum(axes)


def _check_rows(name, c, *rows):
    for r in rows:
        if tuple(r.shape) != (c,):
            raise ValueError(f"{name}: per-channel rows must be ({c},), got {tuple(r.shape)}")


def bn_apply(x2d: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
             relu: bool, cap=None) -> torch.Tensor:
    """clip(relu(x · scale + shift)) over x2d (M, C) with (C,) rows; relu
    and cap optional (cap only with relu, as in bn.py:136-139)."""
    global APPLY_LAUNCHES
    if x2d.dim() != 2:
        raise ValueError(f"bn_apply: expected (M, C), got {tuple(x2d.shape)}")
    _check_rows("bn_apply", x2d.shape[1], scale, shift)
    if not build.on_card("bn_apply", x2d, scale, shift):
        return bn_apply_reference(x2d, scale, shift, relu=relu, cap=cap)
    y = torch.empty_like(x2d)
    if x2d.numel():
        build.launch("rt_bn_apply_f32", x2d.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     y.data_ptr(), x2d.numel(), x2d.shape[1], int(relu),
                     int(cap is not None), 0.0 if cap is None else float(cap),
                     device=x2d.device)
        APPLY_LAUNCHES += 1
    return y


# ------------------------------------------------------------ K6 backward


def bn_bwd_reference(x2d, dy, mean, inv_std, gamma, beta, *, relu: bool):
    """Plain version of the backward: (dx, dgamma, dbeta) in torch, each
    product and sum rounded as the kernel rounds it."""
    m = x2d.shape[0]
    x_hat = (x2d - mean) * inv_std
    if relu:
        dy = torch.where(x_hat * gamma + beta > 0, dy, torch.zeros_like(dy))
    s1 = dy.sum(0)
    s2 = (dy * x_hat).sum(0)
    dx = gamma * inv_std * (dy - s1 / m - x_hat * (s2 / m))
    return dx, s2, s1


def bn_bwd(x2d, dy, mean, inv_std, gamma, beta, *, relu: bool):
    """(dx, dgamma, dbeta) of ``batch_norm_act`` at the output gradient dy,
    from its input x2d (M, C) and the forward's mean and inv_std."""
    global BWD_LAUNCHES
    if x2d.dim() != 2 or dy.shape != x2d.shape:
        raise ValueError(f"bn_bwd: x {tuple(x2d.shape)}, dy {tuple(dy.shape)}")
    m, c = x2d.shape
    _check_rows("bn_bwd", c, mean, inv_std, gamma, beta)
    if not build.on_card("bn_bwd", x2d, dy, mean, inv_std, gamma, beta):
        return bn_bwd_reference(x2d, dy, mean, inv_std, gamma, beta, relu=relu)
    if m == 0 or c == 0:
        raise ValueError(f"bn_bwd: empty input {tuple(x2d.shape)}")
    chunk = chunk_rows(m, c)
    n_chunks = -(-m // chunk)
    part = torch.empty((n_chunks, 2, c), dtype=torch.float32, device=x2d.device)
    aux = torch.empty((5, c), dtype=torch.float32, device=x2d.device)
    dx = torch.empty_like(x2d)
    build.launch("rt_bn_bwd_f32", x2d.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                 inv_std.data_ptr(), gamma.data_ptr(), beta.data_ptr(), part.data_ptr(),
                 aux.data_ptr(), dx.data_ptr(), m, c, chunk, n_chunks, int(relu),
                 device=x2d.device)
    BWD_LAUNCHES += 1
    return dx, aux[1], aux[0]


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, relu):
        mean, var = _forward(x2d)
        inv_std = torch.rsqrt(var + eps)
        scale = gamma * inv_std
        shift = beta - scale * mean
        y = bn_apply(x2d, scale, shift, relu=relu)
        ctx.relu = relu
        ctx.save_for_backward(x2d, gamma, beta, mean, inv_std)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, gamma, beta, mean, inv_std = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x2d, dy.contiguous(), mean, inv_std, gamma, beta,
                                   relu=ctx.relu)
        return dx, dgamma, dbeta, None, None


def batch_norm_act(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-7, relu: bool = True):
    """Training-mode BN(+ReLU) of x2d (M, C): (y, mean, var), the batch
    statistics in fp32 and not differentiated. Differentiable in x2d,
    gamma and beta."""
    return _BatchNormAct.apply(x2d, gamma, beta, eps, relu)


def bn_act_reference(x2d, gamma, beta, eps: float = 1e-7, relu: bool = True):
    """Plain torch ops (bn.py:288-299), differentiated by autograd through
    the statistics too."""
    mean = x2d.mean(0)
    var = torch.clamp_min((x2d * x2d).mean(0) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    y = (x2d - mean) * inv * gamma + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y, mean, var
