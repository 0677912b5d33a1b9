"""Batch norm on an (M, C) view: the port of resnet_tpu.kernels.bn, its
three Pallas kernels (K4 statistics, K5 apply, K6 backward) and
``batch_norm_act``.

K4, one-read statistics.

``moments(x2d)`` gives the per-channel (mean, biased var) of an (M, C) view,
with the epilogue of bn.py:83-86: mean = Σx / M, var = max(Σx² / M − mean², 0).
Where x2d requires a gradient it goes through a ``torch.autograd.Function``;
otherwise the forward runs alone. On a CUDA tensor the forward launches
``rt_moments_f32`` once (``csrc/moments.cu``: chunk partials, summed by the
last block of each channel tile) with a plan cached per (M, C, load width)
(``moments_plan``), one allocation per call (mean and var, two views of one
(2, C) tensor) and the chunk partials and tile tickets in a workspace kept
per (device, stream) (``_workspace``): the kernel leaves the tickets at 0,
so calls on one stream may follow each other, and another stream gets its
own. Anything the kernel does not take raises. On a CPU tensor the plain
version ``moments_reference`` runs: the same two sums in torch. The backward
is the closed form of bn.py:120-125 in torch ops,
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

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
APPLY_LAUNCHES = 0
BWD_LAUNCHES = 0
_CHANNEL_TILE = 32  # channels of a K6 reduce block (csrc/bn.cu CT)
_TARGET_BLOCKS = 132 * 8  # K6: about eight first-pass blocks per SM
_MAX_CHUNKS = 65535  # gridDim.y
# K4's block sizes (csrc/moments.cu LARGE, SMALL)
_MOMENTS_THREADS = (1024, 256)


class MomentsPlan(NamedTuple):
    """A K4 launch: ``ctv`` lanes of ``vec`` channels per tile, ``tiles``
    channel tiles, ``chunk`` rows per block, ``n_chunks`` blocks per tile,
    ``part`` floats of chunk partials, ``threads`` per block."""
    ctv: int
    tiles: int
    chunk: int
    n_chunks: int
    part: int
    threads: int


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


def _chunk_rows(m: int, tiles: int, target: int) -> int:
    """Rows per block for about ``target`` blocks over ``tiles`` channel
    tiles: a multiple of 8, at least 64, at most 65535 chunks."""
    chunks = max(1, -(-target // tiles))
    rows = -(-m // chunks)
    return max(64, -(-rows // 8) * 8, -(-m // _MAX_CHUNKS))


def chunk_rows(m: int, c: int) -> int:
    """Rows per first-pass block of K6's reduction (``csrc/bn.cu``)."""
    return _chunk_rows(m, -(-c // _CHANNEL_TILE), _TARGET_BLOCKS)


@functools.lru_cache(maxsize=1024)
def moments_plan(m: int, c: int, vec: int) -> MomentsPlan:
    """K4's launch for an (m, c) view read ``vec`` channels at a time: ctv,
    the lanes of a tile, is the power of two that covers c / vec, at most
    32 / vec, so a tile is vec * ctv <= 32 channels (128 bytes of a row)
    and a block's threads are ctv lanes times threads / ctv row lanes.
    Blocks of 1024 threads, two per SM, where there are at most 4 tiles
    and each thread gets at least 4 rows (the stem and the 56x56 layers up
    to 128 channels); else 256 threads at eight blocks per SM from 2^23
    elements, four from 2^21, two below (as ``k4_plans`` measured best at
    ResNet-50's shapes). A function of the shapes only, so a call repeats
    exactly."""
    lanes = -(-c // vec)
    ctv = min(32 // vec, 1 << (lanes - 1).bit_length())
    tiles = -(-c // (vec * ctv))
    threads = 1024
    chunk = _chunk_rows(m, tiles, build._SMS * 2)
    if tiles > 4 or chunk < 4 * (threads // ctv):
        threads = 256
        per_sm = 8 if m * c >= 1 << 23 else 4 if m * c >= 1 << 21 else 2
        chunk = _chunk_rows(m, tiles, build._SMS * per_sm)
    n_chunks = -(-m // chunk)
    return MomentsPlan(ctv, tiles, chunk, n_chunks, 2 * n_chunks * c, threads)


def vector_width(x2d: torch.Tensor) -> int:
    """4 where K4 reads x2d in 16-byte loads (C % 4 == 0, 16-byte aligned
    base), else 1."""
    return 4 if x2d.shape[1] % 4 == 0 and x2d.data_ptr() % 16 == 0 else 1


# (device index, stream) -> [chunk partials, tile tickets]
_WORKSPACES: Dict[Tuple[int, int], list] = {}


def _workspace(index: int, plan: MomentsPlan, stream: int = 0) -> list:
    """The chunk partials and the zeroed tile tickets of one stream, grown
    to fit the plan. The kernel leaves its tickets at 0, so the calls on one
    stream share them; a workspace replaced by a larger one is freed in
    stream order, after the calls that use it."""
    ws = _WORKSPACES.get((index, stream))
    if ws is None:
        ws = _WORKSPACES[(index, stream)] = [None, None]
    if ws[0] is None or ws[0].numel() < plan.part:
        ws[0] = torch.empty(max(plan.part, 1 << 16), dtype=torch.float32,
                            device=torch.device("cuda", index))
    if ws[1] is None or ws[1].numel() < plan.tiles:
        ws[1] = torch.zeros(max(plan.tiles, 256), dtype=torch.int32,
                            device=torch.device("cuda", index))
    return ws


def _launch(x2d: torch.Tensor, out: torch.Tensor, plan: MomentsPlan, vec: int) -> None:
    """Enqueue K4 on x2d's device and current stream, mean and var into out."""
    index = x2d.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    part, tickets = _workspace(index, plan, stream)
    build.launch_on(index, stream, build.entry("rt_moments_f32"), x2d.data_ptr(),
                    part.data_ptr(), tickets.data_ptr(), out.data_ptr(), x2d.shape[0],
                    x2d.shape[1], plan.chunk, plan.n_chunks, vec, plan.ctv, plan.threads)


def _forward(x2d: torch.Tensor):
    """(mean, var) of x2d: the kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    global LAUNCHES
    if not x2d.is_cuda:
        if x2d.dim() != 2:
            raise ValueError(f"moments: expected (M, C), got {tuple(x2d.shape)}")
        build.on_card("moments", x2d)  # raises on what the kernel would not take
        return moments_reference(x2d)
    if x2d.dim() != 2 or x2d.dtype is not torch.float32 or not x2d.is_contiguous():
        raise ValueError(f"moments: expected a contiguous float32 (M, C) tensor, got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    m, c = x2d.shape
    if m == 0 or c == 0:
        raise ValueError(f"moments: empty input {tuple(x2d.shape)}")
    vec = vector_width(x2d)
    plan = moments_plan(m, c, vec)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    _launch(x2d, out, plan, vec)
    LAUNCHES += 1
    return out.unbind(0)


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
    """One-read (mean, var) over the rows of x2d (M, C); differentiable
    where x2d requires a gradient."""
    if x2d.requires_grad and torch.is_grad_enabled():
        return _Moments.apply(x2d, _forward)
    return _forward(x2d)


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
