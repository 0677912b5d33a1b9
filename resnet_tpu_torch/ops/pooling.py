"""Pooling, as resnet_tpu.ops.pooling: max pool over the reference's
centered windows with -inf padding (doMaxPool, resnet.cu:433-471), and the
global average pool (doFilterAvgPool, resnet.cu:500-543). NHWC or NCHW.

The max pool's backward is autograd's of F.max_pool2d: the gradient goes to
the first maximum of each window in scan order (strict >), as the
reference's maxPoolDeriv and JAX's select_scatter VJP do, and the padded
cells, which F.pad's backward drops, never win over a real value. The
JAX package's ``maxpool_vjp='mask'`` is a TPU negative result and is not
ported. On a rank's rows under spatial partitioning both pools run in
``parallel.spatial`` (the max pool on the haloed tile, -inf at the image's
edges only; the average pool's row sums summed over the spatial group)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv import spatial_dims
from .padding import reference_padding


def max_pool(x: torch.Tensor, *, kernel: int = 3, stride: int = 2,
             layout: str = "NHWC") -> torch.Tensor:
    hdim, wdim = spatial_dims(layout)
    h_lo, h_hi = reference_padding(x.shape[hdim], kernel, stride)
    w_lo, w_hi = reference_padding(x.shape[wdim], kernel, stride)
    if layout == "NCHW":
        xp = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
        return F.max_pool2d(xp, kernel, stride)
    xp = F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool(x: torch.Tensor, *, layout: str = "NHWC") -> torch.Tensor:
    """(N, H, W, C) or (N, C, H, W) -> (N, C): mean over space."""
    return x.mean(dim=spatial_dims(layout))
