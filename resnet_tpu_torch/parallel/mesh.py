"""The data group of ranks and placement helpers: the port of
resnet_tpu.parallel.mesh, the 1-D data layout.

A ``Mesh`` here is the ranks of the default ``torch.distributed`` group on
one axis, ``data``: each rank holds its rows of the global batch and a
replica (or, under ZeRO, its shards) of the state. Its collectives are
explicit calls on that group: ``sum_`` (an in-place all-reduce SUM, the role
of ``jax.lax.psum``), ``sum_tree`` (one flat fp32 bucket for a list of
tensors) and ``broadcast_``. The data x model mesh with a tensor-parallel FC
head and the spatial (H-sharded) layout raise NotImplementedError naming
ROADMAP.md queue A item A13.

``zero_shardings`` is JAX's ZeRO rule, leaf by leaf: each leaf of at least
``min_bytes`` is sharded on its largest dimension that the ranks divide
(ties to the last), scalars and small leaves replicated. The plan it returns
has the state's nesting, with the sharded dimension (an int) or None at each
leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from ..config import ROADMAP_PARALLEL, not_ported


@dataclass(frozen=True)
class Mesh:
    """The ranks of the default group on one axis."""

    size: int
    rank: int
    axis: str = "data"

    def sum_(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM)

    def sum_tree(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sums over the ranks of ``tensors`` (of any float dtype), by one
        all-reduce of a flat fp32 bucket: each result is a view of the bucket
        (fp32 tensors) or its values cast back to the tensor's dtype."""
        if not tensors:
            return []
        bucket = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        self.sum_(bucket)
        out, at = [], 0
        for t in tensors:
            n = t.numel()
            part = bucket[at:at + n].view(t.shape)
            out.append(part if t.dtype is torch.float32 else part.to(t.dtype))
            at += n
        return out

    def broadcast_(self, tensors: List[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank, in place (the
        tensors keep their storage), one broadcast per dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src)
            at = 0
            with torch.no_grad():
                for t in group:
                    t.copy_(flat[at:at + t.numel()].view(t.shape))
                    at += t.numel()


def make_mesh(num_devices: int = 0, axis: str = "data") -> Mesh:
    """The data group: every rank of the default group. ``num_devices`` 0
    means the whole world; any other value must equal it, since one rank
    drives one device."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no torch.distributed process group; start the ranks with "
            "torchrun or parallel.initialize_distributed")
    world = dist.get_world_size()
    if num_devices and num_devices > world:
        raise ValueError(f"mesh wants {num_devices} devices, only {world} available")
    if num_devices and num_devices != world:
        raise ValueError(f"mesh wants {num_devices} devices, but {world} ranks are running "
                         "(one rank drives one device)")
    return Mesh(size=world, rank=dist.get_rank(), axis=axis)


def rows_of(batch, index: int, count: int, grad_accum: int = 1):
    """Part ``index`` of ``count`` of each array in ``batch`` (a dict), along
    its first dimension; other values pass through. With ``grad_accum`` a,
    each of the a microbatches is split across the parts, so that a part's
    microbatch i is its share of the whole batch's microbatch i (the rows
    JAX's accumulated step gives each device). Raises on a batch the parts
    do not divide evenly."""
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape") or not len(v.shape):
            out[k] = v
            continue
        n = v.shape[0]
        if n % (count * grad_accum):
            raise ValueError(f"batch[{k!r}] of {n} rows does not split into {count} "
                             f"ranks x {grad_accum} microbatches")
        per = n // (count * grad_accum)
        micro = v.reshape((grad_accum, n // grad_accum) + tuple(v.shape[1:]))
        part = micro[:, index * per:(index + 1) * per]
        out[k] = part.reshape((grad_accum * per,) + tuple(v.shape[1:]))
    return out


def shard_batch(batch, mesh: Mesh, axis: str = "data", grad_accum: int = 1):
    """This rank's rows of a global batch dict, split along the batch
    dimension (``rows_of``)."""
    return rows_of(batch, mesh.rank, mesh.size, grad_accum)


def _tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of trees of NamedTuples, dicts, lists and tuples;
    the first tree's nesting is kept, None in it stays None, and None in
    another tree (a plan) stands for None at every leaf below."""
    if tree is None:
        return None

    def sub(r, key):
        return None if r is None else (getattr(r, key) if isinstance(key, str) else r[key])

    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, getattr(tree, f), *(sub(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(None if r is None else r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(sub(r, i) for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def replicate(tree, mesh: Mesh):
    """Rank 0's values of every tensor of ``tree`` on every rank, in place;
    returns the tree."""
    tensors: List[torch.Tensor] = []
    _tree_map(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None, tree)
    mesh.broadcast_(tensors)
    return tree


def zero_dim(shape, nbytes: int, size: int, min_bytes: int) -> Optional[int]:
    """The dimension JAX's ZeRO rule shards a leaf on, or None: the largest
    dimension ``size`` divides, ties to the last; scalars and leaves under
    ``min_bytes`` replicated."""
    if not shape or nbytes < min_bytes:
        return None
    best = -1
    for i, d in enumerate(shape):
        if d % size == 0 and (best < 0 or d >= shape[best]):
            best = i
    return None if best < 0 else best


def zero_shardings(state, mesh: Mesh, axis: str = "data", min_bytes: int = 2 ** 16):
    """ZeRO plan of a state (``resnet_tpu.parallel.zero_shardings``): the
    state's nesting with each leaf's sharded dimension or None."""
    def assign(leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        return zero_dim(tuple(leaf.shape), leaf.numel() * leaf.element_size(), mesh.size,
                        min_bytes)

    return _tree_map(assign, state)


def make_mesh_2d(data: int, model: int, devices=None, axes=("data", "model")):
    raise not_ported("the data x model mesh (make_mesh_2d)", ROADMAP_PARALLEL)


def composite_shardings(state, mesh, model_axis: str = "model"):
    raise not_ported("the tensor-parallel FC head (composite_shardings)", ROADMAP_PARALLEL)


def spatial_batch_specs(data_axis: str = "data", spatial_axis: str = "spatial",
                        layout: str = "NHWC"):
    raise not_ported("spatial partitioning (spatial_batch_specs)", ROADMAP_PARALLEL)


def spatial_shard_batch(batch, mesh, data_axis: str = "data",
                        spatial_axis: str = "spatial", layout: str = "NHWC"):
    raise not_ported("spatial partitioning (spatial_shard_batch)", ROADMAP_PARALLEL)

