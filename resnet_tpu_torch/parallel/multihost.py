"""Cutting state into ZeRO shards (or the composite grid's FC slices) and
gathering it back: the port of resnet_tpu.parallel.multihost. The parts are
split over the mesh's ``shards`` group: the data group of a ``Mesh``, the
model group of a ``Mesh2D``.

``put_global(tree, plan, mesh)`` cuts each leaf the plan shards into this
rank's part along the planned dimension, as an owned contiguous tensor that
lives as long as the state (the fused Adam kernel keys its plan by the
tensors' storage); replicated leaves pass through. Every rank passes the
same value, as in the JAX package (seeded init, a restored dump).
``fetch_global(tree, plan, mesh)`` is the inverse, a collective every rank
must call in step: the shards of all sharded leaves go in one flat bucket
per dtype through one all-gather, and each leaf is put together along its
dimension. ``barrier`` orders the ranks around a checkpoint's publish.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, _tree_map


def shard_of(leaf: torch.Tensor, dim: Optional[int], mesh: Mesh) -> torch.Tensor:
    """This rank's part of ``leaf`` along ``dim`` over the mesh's plan group
    (``Mesh.shards``), contiguous; the leaf itself where ``dim`` is None."""
    if dim is None:
        return leaf
    mesh = mesh.shards
    k = leaf.shape[dim] // mesh.size
    return leaf.narrow(dim, mesh.rank * k, k).contiguous()


def put_global(tree, plan, mesh: Mesh):
    """``tree`` with the leaves ``plan`` shards cut to this rank's parts,
    each an owned copy."""
    def cut(leaf, dim):
        if dim is None or not isinstance(leaf, torch.Tensor):
            return leaf
        return shard_of(leaf, dim, mesh).clone()

    return _tree_map(cut, tree, plan)


def fetch_global(tree, plan=None, mesh: Optional[Mesh] = None):
    """``tree`` with every sharded leaf whole again (an all-gather over the
    ranks); the tree itself without a plan."""
    if plan is None or mesh is None:
        return tree
    mesh = mesh.shards
    sharded: List[tuple] = []
    _tree_map(lambda leaf, dim: sharded.append((leaf, dim))
              if dim is not None and isinstance(leaf, torch.Tensor) else None, tree, plan)
    whole: Dict[int, torch.Tensor] = {}
    by_dtype: Dict[torch.dtype, List[tuple]] = {}
    for leaf, dim in sharded:
        by_dtype.setdefault(leaf.dtype, []).append((leaf, dim))
    for group in by_dtype.values():
        parts = mesh.all_gather(torch.cat([leaf.reshape(-1) for leaf, _ in group]))
        at = 0
        for leaf, dim in group:
            n = leaf.numel()
            whole[id(leaf)] = torch.cat([p[at:at + n].view(leaf.shape) for p in parts], dim)
            at += n
    return _tree_map(lambda leaf, dim: whole.get(id(leaf), leaf)
                     if dim is not None else leaf, tree, plan)


def barrier(name: str = "") -> None:
    """All ranks meet here (a no-op without a group of more than one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
