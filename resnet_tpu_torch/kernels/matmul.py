"""Tiled fp32 GEMM: the port of resnet_tpu.kernels.matmul.matmul (the FC).

On CUDA tensors ``matmul`` launches ``csrc/matmul.cu`` (or raises); on CPU
tensors it runs the plain version ``matmul_reference``. Forward only: the
custom VJP's transposed products come with the training step.
"""

from __future__ import annotations

import torch

from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of the launch walks the 64-wide N tiles


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a @ b (on the card, only with TF32 off in
    torch.backends.cuda.matmul is it the fp32 product)."""
    return a @ b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N), fp32, row-major contiguous operands."""
    global LAUNCHES
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if not build.on_card("matmul", a, b):
        return matmul_reference(a, b)
    m, k = a.shape
    n = b.shape[1]
    if -(-n // 64) > _MAX_N_TILES or k >= 2**31:
        raise ValueError(f"matmul: N={n}, K={k} beyond the kernel's grid")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m and n:
        if k == 0:
            return out.zero_()
        build.launch("rt_matmul_f32", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     m, n, k, device=a.device)
        LAUNCHES += 1
    return out
