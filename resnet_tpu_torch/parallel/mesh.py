"""The groups of ranks and placement helpers: the port of
resnet_tpu.parallel.mesh.

A ``Mesh`` is the ranks of one ``torch.distributed`` group on one axis: the
default group's, ``data`` (``make_mesh``), each rank holding its rows of
the global batch and a replica (or, under ZeRO, its shards) of the state;
or a subgroup of a grid. Its collectives are explicit calls on its group:
``sum_`` (an in-place all-reduce SUM, the role of ``jax.lax.psum``),
``sum_tree`` (one flat fp32 bucket for a list of tensors), ``broadcast_``
and ``all_gather``.

``make_mesh_2d(data, model)`` is JAX's composite grid of data x model
ranks, the model axis innermost (rank = d * model + m): a ``Mesh2D`` whose
``data`` is this rank's data group (the ranks of its model index, where
the gradients and BN statistics are summed) and ``model`` its model group
(the ranks of its data index, which hold the same rows and split the FC
head). ``composite_shardings`` is JAX's rule for that grid: every leaf on a
path through ``fc`` whose last dimension the model size divides is split
on that dimension over the model group, every other leaf replicated. With
``axes=("data", "spatial")`` (or ``kind="spatial"``, the grid's
``Mesh2D.kind``) the same grid is JAX's data x spatial mesh:
the second group is this rank's spatial group (the ranks of its data index,
which split the images' height, ``parallel.spatial``), and
``spatial_shard_batch`` gives a rank its rows of the batch and its slice
of the height.

``zero_shardings`` is JAX's ZeRO rule, leaf by leaf: each leaf of at least
``min_bytes`` is sharded on its largest dimension that the ranks divide
(ties to the last), scalars and small leaves replicated. Each plan returned
has the state's nesting, with the sharded dimension (an int) or None at
each leaf; a mesh's ``shards`` is the group a plan's shards are split over
(the data group of a ``Mesh`` and of a data x spatial grid, the model group
of a data x model ``Mesh2D``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The ranks of a group on one axis: the default group (``group``
    None), or a subgroup of a grid. ``rank`` is this rank's index in it."""

    size: int
    rank: int
    axis: str = "data"
    group: Optional[dist.ProcessGroup] = field(default=None, compare=False, repr=False)

    @property
    def shards(self) -> "Mesh":
        """The group a state plan's shards are split over: this one."""
        return self

    def sum_(self, t: torch.Tensor) -> None:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)

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

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (of one shape on all), in rank order."""
        flat = t.contiguous()
        gathered = torch.empty((self.size,) + tuple(flat.shape), dtype=flat.dtype,
                               device=flat.device)
        parts = list(gathered.unbind(0))
        dist.all_gather(parts, flat, group=self.group)
        return parts

    def broadcast_(self, tensors: List[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s values into ``tensors`` on every rank, in place (the
        tensors keep their storage), one broadcast per dtype."""
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=src, group=self.group)
            at = 0
            with torch.no_grad():
                for t in group:
                    t.copy_(flat[at:at + t.numel()].view(t.shape))
                    at += t.numel()


GRID_KINDS = ("model", "spatial")


@dataclass(frozen=True)
class Mesh2D:
    """A grid of data x model ranks, the model axis innermost (rank = d *
    model + m): ``data`` this rank's data group (index d), ``model`` its
    model group (index m), ``rank`` its rank in the default group. ``kind``
    says what the second group does: "model" (it splits the FC head) or
    "spatial" (it splits the images' height; ``model`` is then the spatial
    group, ``spatial``)."""

    data: Mesh
    model: Mesh
    rank: int
    axis_names: Tuple[str, str] = ("data", "model")
    kind: str = "model"

    def __post_init__(self):
        if self.kind not in GRID_KINDS:
            raise ValueError(f"Mesh2D kind {self.kind!r}; expected one of {GRID_KINDS}")

    @property
    def size(self) -> int:
        return self.data.size * self.model.size

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: self.data.size, self.axis_names[1]: self.model.size}

    @property
    def is_spatial(self) -> bool:
        """A data x spatial grid: its second axis splits the images' height."""
        return self.kind == "spatial"

    @property
    def spatial(self) -> Optional[Mesh]:
        """The spatial group of a data x spatial grid, else None."""
        return self.model if self.is_spatial else None

    @property
    def shards(self) -> Mesh:
        """The group a state plan's shards are split over: the model group
        (``composite_shardings``); on a data x spatial grid the data group
        (ZeRO sharded over data, replicated over spatial, as JAX's Trainer
        composes them)."""
        return self.data if self.is_spatial else self.model

    @property
    def world(self) -> Mesh:
        """Every rank of the grid (the default group)."""
        return Mesh(size=self.size, rank=self.rank, axis="world")

    def sum_(self, t: torch.Tensor) -> None:
        """Sum ``t`` over every rank of the grid, in place."""
        self.world.sum_(t)


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
    state's nesting with each leaf's sharded dimension or None, over the
    mesh's ``shards`` group (a data x spatial grid's data group)."""
    def assign(leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        return zero_dim(tuple(leaf.shape), leaf.numel() * leaf.element_size(),
                        mesh.shards.size, min_bytes)

    return _tree_map(assign, state)


def make_mesh_2d(data: int, model: int, axes=("data", "model"), kind=None) -> Mesh2D:
    """The data x model grid of JAX's ``make_mesh_2d`` over every rank of
    the default group, the model axis innermost: one process group for
    each data index (its model group) and one for each model index (its
    data group), made by every rank in the same order. ``kind`` (None: the
    second axis's name, which must then be "model" or "spatial") is the
    grid's ``Mesh2D.kind``: "spatial" gives the data x spatial grid
    (``Mesh2D.spatial``)."""
    kind = axes[1] if kind is None else kind
    if kind not in GRID_KINDS:
        raise ValueError(f"make_mesh_2d: the second axis {axes[1]!r} names no grid kind; "
                         f"name it one of {GRID_KINDS} or pass kind=")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh_2d: no torch.distributed process group; start the ranks with "
            "torchrun or parallel.initialize_distributed")
    n, world = data * model, dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh wants {data}x{model}={n} devices, only {world} available")
    if n != world:
        raise ValueError(f"mesh wants {data}x{model}={n} devices, but {world} ranks are "
                         "running (one rank drives one device)")
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    model_groups = [dist.new_group(list(range(i * model, (i + 1) * model)))
                    for i in range(data)]
    data_groups = [dist.new_group(list(range(j, n, model))) for j in range(model)]
    return Mesh2D(data=Mesh(data, d, axes[0], data_groups[m]),
                  model=Mesh(model, m, axes[1], model_groups[d]), rank=rank,
                  axis_names=tuple(axes), kind=kind)


def _tree_map_path(fn: Callable, tree, path: Tuple = ()):
    """fn(path, leaf) over the leaves of trees of NamedTuples, dicts, lists
    and tuples, the path holding the dict keys and list indices on the way
    (a NamedTuple's fields are not keys, as in JAX's tree paths); None
    stays None."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map_path(fn, getattr(tree, f), path) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def composite_shardings(state, mesh: Mesh2D, model_axis: str = "model"):
    """The plan of a state on the data x model grid
    (``resnet_tpu.parallel.composite_shardings``): the state's nesting with,
    at each leaf on a path through ``fc`` (the FC weights, bias and their
    optimizer buffers) whose last dimension the model size divides, that
    dimension, split over the model group; None (replicated) elsewhere."""
    size = mesh.shape[model_axis]

    def assign(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if "fc" in path and shape and shape[-1] % size == 0:
            return len(shape) - 1
        return None

    return _tree_map_path(assign, state)


def spatial_batch_specs(data_axis: str = "data", spatial_axis: str = "spatial",
                        layout: str = "NHWC"):
    """(images, labels) specs as JAX writes them: the axis name of each
    dimension or None; the image HEIGHT is dim 1 in NHWC, dim 2 in NCHW."""
    if layout == "NHWC":
        img = (data_axis, spatial_axis)
    elif layout == "NCHW":
        img = (data_axis, None, spatial_axis)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return img, (data_axis,)


def height_slice(images, index: int, count: int, layout: str = "NHWC"):
    """Part ``index`` of ``count`` of a batch of images (a tensor or an
    array) along its height (the even split, ``parallel.spatial.even_rows``),
    contiguous."""
    hdim = 1 if layout == "NHWC" else 2
    h = images.shape[hdim]
    if h % count:
        raise ValueError(f"image height {h} does not split over {count} spatial ranks")
    per = h // count
    sl = [slice(None)] * len(images.shape)
    sl[hdim] = slice(index * per, (index + 1) * per)
    part = images[tuple(sl)]
    return part.contiguous() if hasattr(part, "contiguous") else part.copy()


def spatial_shard_batch(batch, mesh: Mesh2D, data_axis: str = "data",
                        spatial_axis: str = "spatial", layout: str = "NHWC"):
    """This rank's part of a global batch on a data x spatial grid: its rows
    of the batch (its data index, ``rows_of``) and, of each image (an array
    of 3 dimensions or more), its slice of the height (its spatial index);
    the labels whole for its rows."""
    spatial_batch_specs(data_axis, spatial_axis, layout)  # the layout's check
    rows = rows_of(batch, mesh.data.rank, mesh.data.size)
    return {k: (height_slice(v, mesh.model.rank, mesh.model.size, layout)
                if len(getattr(v, "shape", ())) >= 3 else v) for k, v in rows.items()}

