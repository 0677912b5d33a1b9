"""The tensor-parallel FC head of the data x model grid: what JAX's
partitioner derives for ``composite_shardings`` (the logit all-gather and
the features' cotangent sum), as two explicit autograd Functions.

Inside ``fc_head(model)``, where ``model`` is a grid's model group
(``parallel.mesh.Mesh2D.model``) and the FC weight and bias in the
parameters are this rank's slices of the class dimension, the forward's
head runs ``head_in`` on the pooled features and ``head_out`` on the fp32
logit slice:

* ``head_in`` is the identity; its backward sums the features' cotangent,
  dlogits_slice @ W_slice^T on each rank, over the model group: the whole
  dlogits @ W^T;
* ``head_out`` gathers the model group's logit slices into the whole row
  (rank order is column order); its backward keeps this rank's slice of
  the cotangent. The loss on the whole row is replicated over the model
  group, not summed over it, so its cotangent is not summed either.

Outside ``fc_head`` both are the identity, so no other path changes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from .mesh import Mesh

# the model group whose ranks hold the FC head's slices (``fc_head``), or None
_HEAD: Optional[Mesh] = None


@contextlib.contextmanager
def fc_head(model: Optional[Mesh]):
    """Within the block the FC head is split over ``model``'s ranks (None:
    whole on each rank)."""
    global _HEAD
    before, _HEAD = _HEAD, model
    try:
        yield
    finally:
        _HEAD = before


class _HeadIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, model):
        ctx.model = model
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        d = dx.contiguous().clone()
        ctx.model.sum_(d)
        return d, None


class _HeadOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, model):
        ctx.model, ctx.cols = model, logits.shape[-1]
        return torch.cat(model.all_gather(logits), dim=-1)

    @staticmethod
    def backward(ctx, dlogits):
        at = ctx.model.rank * ctx.cols
        return dlogits[..., at:at + ctx.cols].contiguous(), None


def head_in(pooled: torch.Tensor) -> torch.Tensor:
    """The FC's input: its cotangent summed over the model group."""
    return pooled if _HEAD is None else _HeadIn.apply(pooled, _HEAD)


def head_out(logits: torch.Tensor) -> torch.Tensor:
    """The whole logit row from this rank's slice of it."""
    return logits if _HEAD is None else _HeadOut.apply(logits, _HEAD)
