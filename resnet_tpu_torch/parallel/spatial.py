"""Spatial partitioning: the image height split over the ranks of a spatial
group, what JAX's SPMD partitioner derives for ``spatial_shard_batch``
(resnet_tpu/parallel/mesh.py:128-170), written out.

The row plan. The input's rows start as the even split of the image over
the group (``even_rows``; JAX requires ``input_dim % spatial == 0``).
After that, output row o of a layer with stride s belongs to the rank that
holds its window's centre row s*o (``next_rows``): one rule for every layer
keeps both operands of a residual join, the strided main branch and its
projection, on the same rows. It makes the splits uneven: ResNet-50 at 224
on 2 ranks gives stage 4 rows of 4 + 3; on 4 ranks stage 3 gets 4, 3, 4, 3
rows and stage 4 2, 2, 2, 1. A plan in which a rank would hold no row
raises, with the sizes named.

A rank's tile (``tile_of``): for a k x k window at stride s over a layer
of global height H with a global (lo, hi) padding, the rank's output rows,
the halo rows above and below its own that their windows reach (3 for the
stem's 7x7/s2 with the reference's (3, 2) padding, 1 for a 3x3 or the
3x3/s2 max pool, none for a 1x1, 2 above and 1 below for the s2d stem's
4x4/s1 padded (2, 1), one below for the s2d fold's 2x2/s2 padded (0, 0) on
rows that end on an odd row), and the explicit padding of the haloed tile:
the global padding at the image's top and bottom, none at a seam, where the
neighbour's rows stand; a window grid that starts inside the tile has a
negative padding (a 1x1/s2, or the fold, on a tile whose first row is
odd). The global padding is the reference's ``reference_padding(H, k, s)``
unless the layer names its own; every layer gives H / s output rows. The
tile's padding is JAX's ``conv2d_pallas`` padding, which K1 and K8 take
(``kernels.conv.conv2d``, ``kernels.fused_conv.fused_conv``).

The halo exchange (``halo``) is an autograd Function: the forward brings
each rank its neighbours' edge rows through one ``Mesh.all_gather`` of
every rank's first and last rows (the most any neighbour takes; no rank
sends more), which runs on gloo with CUDA tensors and on NCCL alike; the
backward sends the halo rows' cotangents back the same way, and their
owner adds them. Every rank calls the collectives of a layer in the same
order, the reruns of a checkpointed block under remat included, since each
rank runs the same graph.

Inside ``partition(group)`` (the step's forward and backward), ``conv``,
``max_pool`` and ``global_avg_pool`` run on the rank's rows: the conv (a
plain one, K1, K8 or the chain, whose ``run`` may return K8's (y, sums)
pair) and the pool take the haloed tile with the plan's padding (the max pool pads
-inf at the image's edges only, so a window across a seam sees the real
rows in the same scan order and the first maximum still wins); the global
average pool is the rank's row sum, summed over the group (its backward
the identity: the cotangent of the pooled features is the same on every
rank of the group), over the global H*W. No rank gathers the image or a
whole activation. The plans are keyed by the activation's width, which is
never split: every layer halves H and W together, so a width names its
global height.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import spatial_dims
from ..ops.padding import reference_padding

Rows = Tuple[Tuple[int, int], ...]
Padding = Tuple[Tuple[int, int], Tuple[int, int]]


def even_rows(height: int, parts: int) -> Rows:
    """The even split of ``height`` rows over ``parts`` ranks: [a, b) each."""
    if parts < 1 or height % parts:
        raise ValueError(f"spatial: {height} rows do not split evenly over {parts} ranks")
    per = height // parts
    return tuple((r * per, (r + 1) * per) for r in range(parts))


def next_rows(rows: Rows, height: int, stride: int) -> Tuple[int, Rows]:
    """(height, rows) of a layer's output at ``stride`` (the reference's
    geometry, out = height / stride): output row o on the rank that holds
    row stride * o of the input. Raises where a rank would hold none."""
    if height % stride:
        raise ValueError(f"spatial: stride {stride} does not divide the height {height}")
    out = tuple((-(-a // stride), -(-b // stride)) for a, b in rows)
    empty = [r for r, (a, b) in enumerate(out) if b <= a]
    if empty:
        raise ValueError(
            f"spatial: {len(rows)} ranks over {height} rows at stride {stride} leave rank(s) "
            f"{empty} no output row (input rows {list(rows)}, output rows {list(out)} of "
            f"{height // stride})")
    return height // stride, out


@dataclass(frozen=True)
class Tile:
    """A rank's part of one layer: its output rows [oa, ob), the halo rows
    ``top`` and ``bottom`` it takes from its neighbours, and the explicit
    (lo, hi) padding of its haloed tile (JAX's, along H)."""

    oa: int
    ob: int
    top: int
    bottom: int
    lo: int
    hi: int

    @property
    def ho(self) -> int:
        return self.ob - self.oa


def _global_pad(height: int, k: int, stride: int,
                pad: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """The layer's global (lo, hi) along H: ``pad`` or the reference's; it
    must give height / stride output rows, as the row plan does."""
    if pad is None:
        return reference_padding(height, k, stride)
    if height % stride or (height + pad[0] + pad[1] - k) // stride + 1 != height // stride:
        raise ValueError(f"spatial: a {k}x{k}/s{stride} window padded {pad} over {height} "
                         f"rows does not give {height} / {stride} rows")
    return pad


def tile_of(rows: Rows, rank: int, height: int, k: int, stride: int,
            pad: Optional[Tuple[int, int]] = None) -> Tile:
    """Rank ``rank``'s tile of a k x k window at ``stride`` over a layer of
    ``height`` rows split as ``rows``, the image padded ``pad`` (lo, hi)
    (default the reference's)."""
    lo_ref, _ = _global_pad(height, k, stride, pad)
    a, b = rows[rank]
    oa, ob = -(-a // stride), -(-b // stride)
    first = max(0, stride * oa - lo_ref)                  # rows the windows reach
    last = min(height, stride * (ob - 1) - lo_ref + k)    # ... up to, exclusive
    top, bottom = max(0, a - first), max(0, last - b)
    start = a - top
    lo = lo_ref - stride * oa + start
    hi = stride * (ob - oa - 1) + k - (b + bottom - start) - lo
    return Tile(oa, ob, top, bottom, lo, hi)


def tiles_of(rows: Rows, height: int, k: int, stride: int,
             pad: Optional[Tuple[int, int]] = None) -> List[Tile]:
    """Every rank's tile (``tile_of``); raises where a halo would reach past
    a direct neighbour's rows."""
    tiles = [tile_of(rows, r, height, k, stride, pad) for r in range(len(rows))]
    for r, t in enumerate(tiles):
        if (t.top and (r == 0 or t.top > rows[r - 1][1] - rows[r - 1][0])) or (
                t.bottom and (r == len(rows) - 1 or t.bottom > rows[r + 1][1] - rows[r + 1][0])):
            raise ValueError(
                f"spatial: rank {r}'s {k}x{k}/s{stride} windows over {height} rows reach "
                f"{t.top} rows above and {t.bottom} below its rows {rows[r]}, beyond its "
                f"neighbours' (rows {list(rows)})")
    return tiles


def _pad_rows(t: torch.Tensor, dim: int, rows: int, front: bool) -> torch.Tensor:
    """``t`` with zero rows along ``dim`` up to ``rows`` (before or after)."""
    extra = rows - t.shape[dim]
    if extra <= 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    z = t.new_zeros(shape)
    return torch.cat([z, t] if front else [t, z], dim)


def _edges(x: torch.Tensor, dim: int, first: int, last: int) -> torch.Tensor:
    """x's first ``first`` rows (zero-padded after) and last ``last`` rows
    (zero-padded before) along ``dim``, one tensor."""
    h = x.shape[dim]
    head = _pad_rows(x.narrow(dim, 0, min(first, h)), dim, first, front=False)
    tail = _pad_rows(x.narrow(dim, h - min(last, h), min(last, h)), dim, last, front=True)
    return torch.cat([head, tail], dim)


class _Halo(torch.autograd.Function):
    """(above, x, below) along ``dim``: ``top`` rows of the rank above and
    ``bottom`` of the rank below. Every rank sends its first ``up`` and last
    ``down`` rows (the most any rank takes of a neighbour's top and bottom)."""

    @staticmethod
    def forward(ctx, x, group, dim, top, bottom, up, down):
        ctx.group, ctx.dim, ctx.top, ctx.bottom, ctx.up, ctx.down = (
            group, dim, top, bottom, up, down)
        ctx.h = x.shape[dim]
        parts = group.all_gather(_edges(x, dim, up, down))
        pieces = []
        if top:
            pieces.append(parts[group.rank - 1].narrow(dim, up + down - top, top))
        pieces.append(x)
        if bottom:
            pieces.append(parts[group.rank + 1].narrow(dim, 0, bottom))
        return torch.cat(pieces, dim) if len(pieces) > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        dim, top, h, up, down, group = ctx.dim, ctx.top, ctx.h, ctx.up, ctx.down, ctx.group
        # the cotangents of the rows taken: those of the rank above go back
        # up (the tail of its rows), those of the rank below back down
        above = _pad_rows(g.narrow(dim, 0, top), dim, down, front=True)
        below = _pad_rows(g.narrow(dim, top + h, ctx.bottom), dim, up, front=False)
        parts = group.all_gather(torch.cat([above, below], dim).contiguous())
        dx = g.narrow(dim, top, h).clone()
        if group.rank + 1 < group.size:   # the rank below took my last rows
            n = min(down, h)
            dx.narrow(dim, h - n, n).add_(parts[group.rank + 1].narrow(dim, down - n, n))
        if group.rank > 0:                # the rank above took my first rows
            n = min(up, h)
            dx.narrow(dim, 0, n).add_(parts[group.rank - 1].narrow(dim, down, n))
        return dx, None, None, None, None, None, None


def halo(x: torch.Tensor, group, dim: int, tiles: Sequence[Tile]) -> torch.Tensor:
    """This rank's tile of x: its rows with its halo rows above and below
    (``tiles``, every rank's, from ``tiles_of``). No collective where no
    rank takes a halo."""
    up = max(t.bottom for t in tiles)
    down = max(t.top for t in tiles)
    if up == 0 and down == 0:
        return x
    t = tiles[group.rank]
    return _Halo.apply(x.contiguous(), group, dim, t.top, t.bottom, up, down)


class _GroupSum(torch.autograd.Function):
    """The sum over the group; the backward keeps the cotangent, which is
    the same on every rank (the group's ranks compute one replicated loss)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        group.sum_(t)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass
class Partition:
    """The spatial group (a ``parallel.mesh.Mesh``: ``rank``, ``size``,
    ``sum_``, ``all_gather``) and the row plans met so far: global width ->
    (global height, every rank's rows)."""

    group: object
    plans: Dict[int, Tuple[int, Rows]]

    def plan(self, x: torch.Tensor, layout: str) -> Tuple[int, Rows]:
        """(global height, rows) of an activation of this rank; the first one
        met is the input, split evenly."""
        hdim, wdim = spatial_dims(layout)
        width, h = x.shape[wdim], x.shape[hdim]
        if width not in self.plans:
            if self.plans:
                raise ValueError(f"spatial: an activation of width {width} that no layer "
                                 f"made (known widths {sorted(self.plans)})")
            height = h * self.group.size
            self.plans[width] = (height, even_rows(height, self.group.size))
        height, rows = self.plans[width]
        a, b = rows[self.group.rank]
        if b - a != h:
            raise ValueError(f"spatial: rank {self.group.rank} holds {h} rows of width "
                             f"{width}; its plan gives rows {(a, b)} of {height}")
        return height, rows

    def tiles(self, x: torch.Tensor, k: int, stride: int, layout: str,
              padding: Optional[Padding] = None
              ) -> Tuple[List[Tile], Padding]:
        """Every rank's tile of a k x k window at ``stride`` over x, the
        image padded ``padding`` ((lo, hi), (lo_w, hi_w); default the
        reference's), and this rank's padding; records the output's plan."""
        height, rows = self.plan(x, layout)
        width = x.shape[spatial_dims(layout)[1]]
        out_height, out_rows = next_rows(rows, height, stride)
        known = self.plans.setdefault(width // stride, (out_height, out_rows))
        if known != (out_height, out_rows):
            raise ValueError(f"spatial: width {width // stride} planned as {known}, "
                             f"a layer gives {(out_height, out_rows)}")
        pad_h, pad_w = padding or (None, reference_padding(width, k, stride))
        tiles = tiles_of(rows, height, k, stride, pad_h)
        t = tiles[self.group.rank]
        return tiles, ((t.lo, t.hi), pad_w)


# the partition in force (``partition``), or None; not thread-local, since a
# checkpointed block's forward reruns inside the backward on the autograd
# engine's device thread
_ACTIVE: Optional[Partition] = None


@contextlib.contextmanager
def partition(group):
    """Within the block the activations are this rank's rows of the images,
    split over ``group`` (a spatial group of more than one rank; None or a
    group of one: no partition)."""
    global _ACTIVE
    part = Partition(group, {}) if group is not None and group.size > 1 else None
    before, _ACTIVE = _ACTIVE, part
    try:
        yield part
    finally:
        _ACTIVE = before


def active() -> Optional[Partition]:
    """The partition in force, or None."""
    return _ACTIVE


def conv(x: torch.Tensor, k: int, stride: int, layout: str,
         run: Callable[[torch.Tensor, Padding], Any],
         padding: Optional[Padding] = None) -> Any:
    """A k x k conv at ``stride`` on this rank's rows: ``run(tile, padding)``
    on the haloed tile with the plan's explicit padding (of the image padded
    ``padding``, default the reference's). ``run`` returns the rank's output
    rows, or a tuple whose first entry they are (K8's (y, sums))."""
    part = _ACTIVE
    tiles, pad = part.tiles(x, k, stride, layout, padding)
    hdim = spatial_dims(layout)[0]
    out = run(halo(x, part.group, hdim, tiles), pad)
    y = out[0] if isinstance(out, tuple) else out
    want = tiles[part.group.rank].ho
    if y.shape[hdim] != want:
        raise RuntimeError(f"spatial: the conv gave {y.shape[hdim]} rows, the plan {want}")
    return out


def max_pool(x: torch.Tensor, kernel: int, stride: int, layout: str) -> torch.Tensor:
    """The max pool on this rank's rows: -inf padding at the image's edges
    only (the plan's), the neighbours' rows at a seam."""
    def run(t, padding):
        (lo, hi), (lo_w, hi_w) = padding
        if layout == "NCHW":
            tp = F.pad(t, (lo_w, hi_w, lo, hi), value=float("-inf"))
            return F.max_pool2d(tp, kernel, stride)
        tp = F.pad(t, (0, 0, lo_w, hi_w, lo, hi), value=float("-inf"))
        return F.max_pool2d(tp.permute(0, 3, 1, 2), kernel, stride).permute(0, 2, 3, 1).contiguous()

    return conv(x, kernel, stride, layout, run)


def global_avg_pool(x: torch.Tensor, layout: str) -> torch.Tensor:
    """(N, C): the mean over the whole image, from this rank's rows: the
    row sums (fp32) summed over the group, over the global H*W."""
    part = _ACTIVE
    height, _ = part.plan(x, layout)
    dims = spatial_dims(layout)
    total = _GroupSum.apply(x.to(torch.float32).sum(dim=dims), part.group)
    return (total / (height * x.shape[dims[1]])).to(x.dtype)
