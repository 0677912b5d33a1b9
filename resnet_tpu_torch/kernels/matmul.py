"""Tiled fp32 GEMM and its VJP: the port of resnet_tpu.kernels.matmul.matmul
(the FC).

``matmul`` is a ``torch.autograd.Function``. On CUDA tensors its forward
launches ``rt_matmul_f32`` of ``csrc/matmul.cu`` and its backward the two
transposed forms on the same core, as matmul.py:94-98 does: da = g @ b^T
(``rt_matmul_nt_f32``, b read transposed in place) and db = a^T @ g
(``rt_matmul_tn_f32``), each only where a gradient is needed. Anything the
kernels do not take raises. On CPU tensors the plain versions run:
``matmul_reference`` and ``matmul_bwd_reference``.

``LAUNCHES`` counts forward launches, ``BWD_LAUNCHES`` backward ones (one
per product).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
BWD_LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of the launch walks the 64-wide N tiles


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a @ b (on the card, only with TF32 off in
    torch.backends.cuda.matmul is it the fp32 product)."""
    return a @ b


def matmul_bwd_reference(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain VJP of a @ b: (g @ b^T, a^T @ g)."""
    return g @ b.t(), a.t() @ g


def _gemm(entry: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int
          ) -> torch.Tensor:
    """Launch one GEMM entry point into a new (m, n) output."""
    if -(-n // 64) > _MAX_N_TILES or k >= 2**31:
        raise ValueError(f"matmul: N={n}, K={k} beyond the kernel's grid")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m and n:
        if k == 0:
            return out.zero_()
        splits = build.split_k(m, n, k)
        ws_ptr, _ws = build.gemm_workspace(splits, m, n, a)
        build.launch(entry, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     ws_ptr, splits, device=a.device)
    return out


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if not build.on_card("matmul", a, b):
        return matmul_reference(a, b)
    m, k = a.shape
    out = _gemm("rt_matmul_f32", a, b, m, b.shape[1], k)
    if m and b.shape[1] and k:
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
    da = db = None
    if need_a:
        da = _gemm("rt_matmul_nt_f32", g, b, m, k, n)
        BWD_LAUNCHES += bool(m and k and n)
    if need_b:
        db = _gemm("rt_matmul_tn_f32", a, g, k, n, m)
        BWD_LAUNCHES += bool(m and k and n)
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
    return _Matmul.apply(a, b)
