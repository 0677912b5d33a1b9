"""fp32 GEMM and its VJP: the port of resnet_tpu.kernels.matmul.matmul
(the FC).

``matmul`` is a ``torch.autograd.Function`` whose forward is the custom op
``ops.matmul`` (called directly where no gradient is recorded; its
implementations ``_forward`` on CUDA tensors and ``_forward_plain`` on CPU
ones, called directly in eager mode, ``ops.implement``). On CUDA tensors its forward
launches one kernel of ``csrc/matmul.cu``, chosen by shape in
``matmul_route``: the skinny streaming kernel ``rt_matmul_skinny_f32`` for
M <= 32 (the FC at batch 1-32), the tiled ``rt_matmul_f32`` above. Its
backward, the VJP of matmul.py:94-98 (da = g @ b^T, db = a^T @ g), is one
launch of ``rt_matmul_bwd_f32`` for both products, or for the one a
gradient is needed of (``build.matmul_bwd_plan``; b^T is never copied).
Anything the kernels do not take raises. On CPU tensors the plain versions
run: ``matmul_reference`` and ``matmul_bwd_reference``.

bf16 tensors take the bf16 entry points of the same file: the forward
``rt_matmul_bf16`` for every M, on ``csrc/wgb_gemm.cuh``'s persistent
``wgmma`` loop with the loaders ``fwd_bf16_route`` names: at M <= 32 the
operands swapped (c^T = b^T a^T, so the FC's 1000 columns fill the
``wgmma`` rows), else K1's bf16 forward (``conv.cu``) on a as an (M, 1, 1,
K) image and b as a 1x1 weight; the K split of the fp32 route of the same
M (``build.skinny_split`` for M <= 32, ``build.split_k`` above), in
``csrc/bf16_gemm.cuh``'s chunks, so the bits of that core's kernel, which
ran it before. The backward is one launch of ``rt_matmul_bwd_bf16``
(``mma.sync`` with ``ldmatrix``, planned by ``build.matmul_bwd_plan_bf16``).
An fp32 accumulator and a bf16 result rounded once, result_type(a, b) as
in matmul.py:53; da and db in bf16 (matmul.py:96-97). The plain versions
compute in fp32 and cast once.

``LAUNCHES`` counts fp32 forward launches (either route), ``BWD_LAUNCHES``
fp32 backward ones (one per call, whichever products it computes);
``LAUNCHES_BF16`` and ``BWD_LAUNCHES_BF16`` the bf16 ones.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build, ops

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
BWD_LAUNCHES = 0
LAUNCHES_BF16 = 0
BWD_LAUNCHES_BF16 = 0
_MAX_N_TILES = 65535  # gridDim.y of the launch walks the 64-wide N tiles
_MAX_SLABS = 65535  # ... and of the skinny launch the 32-wide N slabs
# rt_matmul_bf16's loaders as csrc/matmul.cu numbers them: conv.cu's FWD_*
# (an (M, 1, 1, K) conv), then FC_SWAP and FC_SWAP_SCALAR
FWD_BF16_ROUTES = ("gather", "matrix", "scalar", "stem", "swap", "swap_scalar")


def matmul_route(m: int, n: int, k: int) -> str:
    """The forward's kernel for an (m, k) @ (k, n) product: 'skinny' for
    1 <= m <= 32 (its accumulators are m rows x 4 columns per thread), else
    'tiled'. A function of the shapes only."""
    if 1 <= m <= build.SKINNY_MAX_M and -(-n // build.SKINNY_COLS) <= _MAX_SLABS:
        return "skinny"
    return "tiled"


def fwd_splits(m: int, n: int, k: int) -> int:
    """K splits of the forward: ``build.skinny_split`` on the 'skinny'
    route, ``build.split_k`` on the 'tiled' one (``matmul_route``); the
    bf16 forward takes the same count."""
    return (build.skinny_split if matmul_route(m, n, k) == "skinny" else build.split_k)(m, n, k)


@functools.lru_cache(maxsize=None)
def fwd_bf16_route(m: int, n: int, k: int, aligned: bool = True) -> str:
    """The loaders of the bf16 forward (``csrc/matmul.cu``
    ``rt_matmul_bf16``, all on the persistent ``wgmma`` loop), K split
    ``fwd_splits`` ways. For m <= 32 (the FC at batch 1-32) the operands
    swapped, c^T = b^T a^T: 'swap' (b by TMA boxes as it lies, a by 16-byte
    copies) where k and n are multiples of 8 and a and b are 16-byte
    ``aligned``, else 'swap_scalar' (2-byte loads of both). Above, K1's
    bf16 forward on a 1x1/s1 conv of m pixels, k input and n output
    channels (``conv.fwd_bf16_route``): 'matrix' (a by TMA boxes where the
    splits are whole 64-deep slices), 'gather' (a by 16-byte copies) or
    'scalar' (2-byte loads: n % 8 or k % 8 != 0, or a misaligned operand).
    The wrapper hands it to the kernel (``FWD_BF16_ROUTES``)."""
    from .conv import fwd_bf16_route as conv_route

    if m <= build.SKINNY_MAX_M:
        return "swap" if k % 8 == 0 and n % 8 == 0 and aligned else "swap_scalar"
    return conv_route(m, k, n, 1, 1, aligned, fwd_splits(m, n, k))


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a @ b in fp32, cast to a's dtype (on the card, only
    with TF32 off in torch.backends.cuda.matmul is it the fp32 product)."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_bwd_reference(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain VJP of a @ b: (g @ b^T, a^T @ g), each in fp32, cast to the
    inputs' dtype."""
    af, bf, gf = a.float(), b.float(), g.float()
    return (gf @ bf.t()).to(a.dtype), (af.t() @ gf).to(b.dtype)


def _gemm(entry: str, a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int,
          plan=build.split_k, route: Optional[str] = None) -> torch.Tensor:
    """Launch one GEMM entry point into a new (m, n) output, K split by
    ``plan(m, n, k)``; the bf16 entry also takes its loaders ``route``."""
    if -(-n // 64) > _MAX_N_TILES or k >= 2**31:
        raise ValueError(f"matmul: N={n}, K={k} beyond the kernel's grid")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m and n:
        if k == 0:
            return out.zero_()
        splits = plan(m, n, k)
        ws_ptr, _ws = build.gemm_workspace(splits, m, n, a)
        extra = () if route is None else (FWD_BF16_ROUTES.index(route),)
        build.launch(entry, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                     ws_ptr, splits, *extra, device=a.device)
    return out


def _forward_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.matmul``'s CPU implementation: the plain version after the
    kernel's checks."""
    build.on_card("matmul", a, b)
    return matmul_reference(a, b)


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.matmul``'s CUDA implementation: one launch of K3's forward."""
    if not build.on_card("matmul", a, b):
        raise ValueError("matmul: CPU tensors reached the CUDA implementation")
    m, k = a.shape
    n = b.shape[1]
    if a.dtype is torch.bfloat16:  # one entry point, the route's split
        out = _gemm("rt_matmul_bf16", a, b, m, n, k, fwd_splits,
                    fwd_bf16_route(m, n, k, build.aligned16(a, b)))
    elif matmul_route(m, n, k) == "skinny":
        out = _gemm("rt_matmul_skinny_f32", a, b, m, n, k, build.skinny_split)
    else:
        out = _gemm("rt_matmul_f32", a, b, m, n, k)
    if m and n and k:
        build.count(__name__, "LAUNCHES", a)
    return out


_matmul = ops.implement("matmul", cpu=_forward_plain, cuda=_forward)


def matmul_bwd(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
               need_a: bool = True, need_b: bool = True
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(da, db) = (g @ b^T, a^T @ g) for a (M, K), b (K, N), g (M, N); a
    gradient that is not needed comes back as None."""
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
    bf16 = a.dtype is torch.bfloat16
    plan = build.matmul_bwd_plan_bf16 if bf16 else build.matmul_bwd_plan
    da_blocks, db_blocks = plan(m, k, n, need_a, need_b)
    if da_blocks + db_blocks >= 2**31:
        raise ValueError(f"matmul_bwd: {da_blocks + db_blocks} blocks beyond the grid")
    if (need_a and m * k) or (need_b and k * n):
        build.launch(build.entry_name("matmul_bwd", a), a.data_ptr(), b.data_ptr(),
                     g.data_ptr(), da.data_ptr() if da_blocks else None,
                     db.data_ptr() if db_blocks else None, m, k, n, da_blocks, db_blocks,
                     device=a.device)
        build.count(__name__, "BWD_LAUNCHES", a)
    return da, db


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return matmul_bwd(a, b, g.contiguous(), *ctx.needs_input_grad)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32 or bf16 (both operands alike),
    row-major contiguous operands. Differentiable in a and b."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Matmul.apply(a, b)
    return _matmul(a, b)  # no graph to record: skip the Function's host cost
