"""fp32 GEMM and its VJP: the port of resnet_tpu.kernels.matmul.matmul
(the FC).

``matmul`` is a ``torch.autograd.Function``. On CUDA tensors its forward
launches one kernel of ``csrc/matmul.cu``, chosen by shape in
``matmul_route``: the skinny streaming kernel ``rt_matmul_skinny_f32`` for
M <= 32 (the FC at batch 1-32), the tiled ``rt_matmul_f32`` above. Its
backward, the VJP of matmul.py:94-98 (da = g @ b^T, db = a^T @ g), is one
launch of ``rt_matmul_bwd_f32`` for both products, or for the one a
gradient is needed of (``build.matmul_bwd_plan``; b^T is never copied).
Anything the kernels do not take raises. On CPU tensors the plain versions
run: ``matmul_reference`` and ``matmul_bwd_reference``.

``LAUNCHES`` counts forward launches (either route), ``BWD_LAUNCHES``
backward ones (one per call, whichever products it computes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
BWD_LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of the launch walks the 64-wide N tiles
_MAX_SLABS = 65535  # ... and of the skinny launch the 32-wide N slabs


def matmul_route(m: int, n: int, k: int) -> str:
    """The forward's kernel for an (m, k) @ (k, n) product: 'skinny' for
    1 <= m <= 32 (its accumulators are m rows x 4 columns per thread), else
    'tiled'. A function of the shapes only."""
    if 1 <= m <= build.SKINNY_MAX_M and -(-n // build.SKINNY_COLS) <= _MAX_SLABS:
        return "skinny"
    return "tiled"


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a @ b (on the card, only with TF32 off in
    torch.backends.cuda.matmul is it the fp32 product)."""
    return a @ b


def matmul_bwd_reference(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain VJP of a @ b: (g @ b^T, a^T @ g)."""
    return g @ b.t(), a.t() @ g


def _gemm(entry: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
          plan=build.split_k) -> torch.Tensor:
    """Launch one GEMM entry point into a new (m, n) output, K split by
    ``plan(m, n, k)``."""
    if -(-n // 64) > _MAX_N_TILES or k >= 2**31:
        raise ValueError(f"matmul: N={n}, K={k} beyond the kernel's grid")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m and n:
        if k == 0:
            return out.zero_()
        splits = plan(m, n, k)
        ws_ptr, _ws = build.gemm_workspace(splits, m, n, a)
        build.launch(entry, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     ws_ptr, splits, device=a.device)
    return out


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if not build.on_card("matmul", a, b):
        return matmul_reference(a, b)
    m, k = a.shape
    n = b.shape[1]
    if matmul_route(m, n, k) == "skinny":
        out = _gemm("rt_matmul_skinny_f32", a, b, m, n, k, build.skinny_split)
    else:
        out = _gemm("rt_matmul_f32", a, b, m, n, k)
    if m and n and k:
        LAUNCHES += 1
    return out


def matmul_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
               need_a: bool = True, need_b: bool = True
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(da, db) = (g @ b^T, a^T @ g) for a (M, K), b (K, N), g (M, N); a
    gradient that is not needed comes back as None."""
    global BWD_LAUNCHES
    m, k = a.shape
    n = b.shape[1]
    if tuple(g.shape) != (m, n):
        raise ValueError(f"matmul_bwd: g {tuple(g.shape)} for a {tuple(a.shape)} "
                         f"@ b {tuple(b.shape)}")
    if not build.on_card("matmul_bwd", a, b, g):
        da, db = matmul_bwd_reference(a, b, g)
        return (da if need_a else None), (db if need_b else None)
    if max(m, k, n) >= 2**30:  # the kernel's tile counts are 32-bit
        raise ValueError(f"matmul_bwd: M={m}, K={k}, N={n} beyond the kernel's int sizes")
    da = torch.empty((m, k), dtype=a.dtype, device=a.device) if need_a else None
    db = torch.empty((k, n), dtype=a.dtype, device=a.device) if need_b else None
    da_blocks, db_blocks = build.matmul_bwd_plan(m, k, n, need_a, need_b)
    if da_blocks + db_blocks >= 2**31:
        raise ValueError(f"matmul_bwd: {da_blocks + db_blocks} blocks beyond the grid")
    if da_blocks + db_blocks:
        build.launch("rt_matmul_bwd_f32", a.data_ptr(), b.data_ptr(), g.data_ptr(),
                     da.data_ptr() if da_blocks else None,
                     db.data_ptr() if db_blocks else None, m, k, n, da_blocks, db_blocks,
                     device=a.device)
        BWD_LAUNCHES += 1
    return da, db


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _forward(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return matmul_bwd(a, b, g.contiguous(), *ctx.needs_input_grad)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32, row-major contiguous operands.
    Differentiable in a and b."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b)
    return _forward(a, b)  # no graph to record: skip the Function's host cost
