"""One-read batch-norm statistics: the port of resnet_tpu.kernels.bn.moments.

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

``LAUNCHES`` counts launches of the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
_CHANNEL_TILE = 32  # csrc/moments.cu CT
_TARGET_BLOCKS = 132 * 8  # about eight first-pass blocks per SM
_MAX_CHUNKS = 65535  # gridDim.y of the first pass


def _epilogue(s: torch.Tensor, s2: torch.Tensor, m: int):
    mean = s / m
    var = torch.clamp_min(s2 / m - mean * mean, 0.0)
    return mean, var


def moments_reference(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: Σx and Σx² over rows in torch, then the epilogue."""
    x = x2d.to(torch.float32)
    return _epilogue(x.sum(0), (x * x).sum(0), x2d.shape[0])


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
