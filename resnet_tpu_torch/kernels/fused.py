"""Residual join relu(a + b): the port of resnet_tpu.kernels.fused.add_relu.

On a CUDA tensor ``add_relu`` launches ``csrc/add_relu.cu`` (or raises); on
a CPU tensor it runs the plain version ``add_relu_reference``. Forward only:
the backward (the Pallas ``_add_relu_mask_kernel``) comes with the training
step.
"""

from __future__ import annotations

import torch

from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0


def add_relu_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: max(a + b, 0) in fp32, NaN propagating."""
    return torch.relu(a + b)


def add_relu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(a + b) for two fp32 contiguous tensors of one shape."""
    global LAUNCHES
    if a.shape != b.shape:
        raise ValueError(f"add_relu: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not build.on_card("add_relu", a, b):
        return add_relu_reference(a, b)
    out = torch.empty_like(a)
    if a.numel():
        build.launch("rt_add_relu_f32", a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), a.numel(), device=a.device)
        LAUNCHES += 1
    return out
