"""Batch norm on an (M, C) view: the port of resnet_tpu.kernels.bn, its
three Pallas kernels (K4 statistics, K5 apply, K6 backward) and
``batch_norm_act``.

K4, one-read statistics.

``moments(x2d)`` gives the per-channel (mean, biased var) of an (M, C) view,
with the epilogue of bn.py:83-86: mean = Σx / M, var = max(Σx² / M − mean², 0).
Where x2d requires a gradient it goes through a ``torch.autograd.Function``;
otherwise the forward runs alone. On a CUDA tensor the forward launches
``rt_moments_f32`` once (``csrc/moments.cu``: chunk partials, summed by the
last block of each channel tile) with a plan cached per (M, C, load width)
(``moments_plan``), one allocation per call (mean and var, two views of one
(2, C) tensor) and the chunk partials and tile tickets in a workspace kept
per (device, stream) (``_workspace``): the kernel leaves the tickets at 0,
so calls on one stream may follow each other, and another stream gets its
own. Anything the kernel does not take raises. On a CPU tensor the plain
version ``moments_reference`` runs: the same two sums in torch. The backward
is the closed form of bn.py:120-125 in torch ops,
dx = dmean / M + dvar · 2(x − mean) / M; the JAX package has no kernel for it
either. ``moments_plain`` is the same Function over the plain sums on any
device: the plain path's batch statistics (``ops.batchnorm.batch_moments``).

Statistics of a batch split over ranks (``sync_stats``). Inside
``sync_stats(reduce, index, size)``, where ``reduce`` sums a tensor in
place over the ranks of a statistics group (``parallel.mesh.Mesh.sum_`` of
the data group; a ``StatsGroup``), every batch statistic is the global
batch's, as the JAX package's pjit step computes it. The one place they are
summed is ``summed``: a layer's raw per-channel sums and their row count in
one float64 all-reduce (the count exact, no rounding added to the fp32 sums
of two ranks), returned as fp32 with the count a device scalar, so nothing
waits for the host. ``moments`` and ``moments_plain`` take this rank's raw
Σx and Σx² (on a CUDA tensor K4 launched once through
``rt_moments_sums_*``, the same kernel writing its sums in place of its
epilogue; on a CPU tensor ``moments_sums_reference``), sum them and apply
the epilogue with the global row count m; their backward sums (dmean, dvar)
over the ranks before the closed form. ``sum_stats`` is the same sum as an
autograd Function for statistics that come as raw sums from elsewhere (the
fused engines' K8 and ``conv_chain`` sites): its backward sums the sums'
cotangent over the ranks. K10 (``block_fused``) and ghost BN
(``ops.batchnorm``) call ``summed`` inside their own Functions.
``sample_rows`` gives the global batch's rows and this rank's first one
(the group holds equal, contiguous slices in rank order), for ghost BN's
sample. Outside ``sync_stats`` nothing changes: K4 writes its epilogue as
before.

K5, the apply. ``bn_apply(x2d, scale, shift, relu=..., cap=None)`` is
clip(relu(x · scale + shift)) per channel (bn.py:134-160). On a CUDA tensor it
launches ``rt_bn_apply_f32`` (``csrc/bn.cu``); on a CPU tensor the plain
``bn_apply_reference`` runs. It has no gradient of its own: its callers
(``batch_norm_act`` here, ``fused.bias_act``) carry it in their Functions.

K6, the backward. ``batch_norm_act(x2d, gamma, beta, eps, relu)`` is the
training-mode BN(+ReLU) of bn.py:250-285: forward K4 then K5, returning
(y, mean, var) with the statistics not differentiated; backward
``bn_bwd``: the reduction s1 = Σdy_g, s2 = Σdy_g·x̂ (dy gated by the
recomputed ReLU), then dx = γ·inv_std·(dy_g − s1/M − x̂·s2/M), dγ = s2,
dβ = s1, launched as ``rt_bn_bwd_f32`` on a CUDA tensor (``csrc/bn.cu``:
K4's layout, chunk partials that every block of a channel tile sums in one
fixed order once its tile's counter says all are written, then the dx pass
over each thread's rows in reverse, so that what the L2 still holds is
read first; one cooperative launch where the grid fits one block a SM),
``bn_bwd_reference`` on a CPU one. Its plan (``bn_bwd_plan``) is cached per
(M, C, load width, SMs); it shares K4's workspace per (device, stream), and
each call allocates dx and one (2, C) tensor whose rows are dβ and dγ.
``bn_act_reference`` (bn.py:288-299) is plain torch ops that autograd
differentiates, the yardstick of the whole.

``mean_var_from_sums`` (the statistics' epilogue) and ``bn_apply_bwd`` (the
apply's backward in torch ops) are shared with the fused engine's
``kernels.fused_conv`` and ``fused.bias_act``.

No model path of the JAX package calls ``batch_norm_act``; it is a public
entry point of its kernels package, and so of this one.

Every kernel here takes bf16 data as it takes fp32, as the Pallas kernels
do: K4 (``rt_moments_bf16``) the same fp32 sums and fp32 statistics
(bn.py:77, :101; its VJP's dx in fp32 cast to bf16, bn.py:120-125); K5
(``rt_bn_apply_bf16``) x read into fp32, fp32 arithmetic, y rounded once
(bn.py:134-140); K6 (``rt_bn_bwd_bf16``) x and dy read into fp32, s1 and
s2 fp32, dx rounded to x's dtype once, dγ and dβ cast to γ's dtype
(bn.py:192-201, :244). Their per-channel rows are fp32 whatever the data's
dtype (``build.rows_f32``: a bf16 γ or β is cast, as bn.py:210 casts
them). The plain versions compute in fp32 on the upcast values and round
where the kernels round.

``LAUNCHES`` counts fp32 K4 launches, ``APPLY_LAUNCHES`` K5 and
``BWD_LAUNCHES`` K6 (one per backward, its one or two launches together); the
``*_BF16`` counters the bf16 ones.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
LAUNCHES_BF16 = 0
APPLY_LAUNCHES = 0
APPLY_LAUNCHES_BF16 = 0
BWD_LAUNCHES = 0
BWD_LAUNCHES_BF16 = 0
_MAX_CHUNKS = 65535  # gridDim.y
# K4's block sizes (csrc/moments.cu LARGE, SMALL)
_MOMENTS_THREADS = (1024, 256)
# K6's block size and rows in flight a thread (csrc/bn.cu BWD_THREADS,
# BWD_ROWS): one block a SM
_BWD_THREADS = 512
_BWD_ROWS = 4


class MomentsPlan(NamedTuple):
    """A K4 launch: ``ctv`` lanes of ``vec`` channels per tile, ``tiles``
    channel tiles, ``chunk`` rows per block, ``n_chunks`` blocks per tile,
    ``part`` floats of chunk partials, ``threads`` per block."""
    ctv: int
    tiles: int
    chunk: int
    n_chunks: int
    part: int
    threads: int


def mean_var_from_sums(s: torch.Tensor, s2: torch.Tensor, m: int):
    """(mean, biased var) from per-channel Σx and Σx² over m rows
    (bn.py:83-86)."""
    mean = s / m
    var = torch.clamp_min(s2 / m - mean * mean, 0.0)
    return mean, var


def moments_sums_reference(x: torch.Tensor, channel_dim: int = -1
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the raw sums: Σx and Σx² in fp32 over every
    dimension but ``channel_dim`` (the rows of an (M, C) view by default)."""
    xf = x.to(torch.float32)
    dims = tuple(d for d in range(x.dim()) if d != channel_dim % x.dim())
    return xf.sum(dims), (xf * xf).sum(dims)


def moments_reference(x: torch.Tensor, channel_dim: int = -1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``moments_sums_reference``, then the epilogue."""
    return mean_var_from_sums(*moments_sums_reference(x, channel_dim),
                              x.numel() // max(x.shape[channel_dim], 1))


def _chunk_rows(m: int, tiles: int, target: int) -> int:
    """Rows per block for about ``target`` blocks over ``tiles`` channel
    tiles: a multiple of 8, at least 64, at most 65535 chunks."""
    chunks = max(1, -(-target // tiles))
    rows = -(-m // chunks)
    return max(64, -(-rows // 8) * 8, -(-m // _MAX_CHUNKS))


@functools.lru_cache(maxsize=1024)
def moments_plan(m: int, c: int, vec: int) -> MomentsPlan:
    """K4's launch for an (m, c) view read ``vec`` channels at a time: ctv,
    the lanes of a tile, is the power of two that covers c / vec, at most
    32 / vec, so a tile is vec * ctv <= 32 channels (128 bytes of a row)
    and a block's threads are ctv lanes times threads / ctv row lanes.
    Blocks of 1024 threads, two per SM, where there are at most 4 tiles
    and each thread gets at least 4 rows (the stem and the 56x56 layers up
    to 128 channels); else 256 threads at eight blocks per SM from 2^23
    elements, four from 2^21, two below (as ``k4_plans`` measured best at
    ResNet-50's shapes). A function of the shapes only, so a call repeats
    exactly."""
    lanes = -(-c // vec)
    ctv = min(32 // vec, 1 << (lanes - 1).bit_length())
    tiles = -(-c // (vec * ctv))
    threads = 1024
    chunk = _chunk_rows(m, tiles, build._SMS * 2)
    if tiles > 4 or chunk < 4 * (threads // ctv):
        threads = 256
        per_sm = 8 if m * c >= 1 << 23 else 4 if m * c >= 1 << 21 else 2
        chunk = _chunk_rows(m, tiles, build._SMS * per_sm)
    n_chunks = -(-m // chunk)
    return MomentsPlan(ctv, tiles, chunk, n_chunks, 2 * n_chunks * c, threads)


def vector_width(x2d: torch.Tensor) -> int:
    """4 where K4 reads x2d four channels at a time (C % 4 == 0 and a base
    aligned to four elements: 16-byte loads of fp32, 8-byte ones of bf16),
    else 1."""
    return 4 if x2d.shape[1] % 4 == 0 and x2d.data_ptr() % (4 * x2d.element_size()) == 0 else 1


# (device index, stream) -> [chunk partials, tile tickets], shared by K4,
# K6 and Q1 (``quant.qconv``, whose split partials are int32 of the same
# size)
_WORKSPACES: Dict[Tuple[int, int], list] = {}


def _workspace(index: int, part: int, tickets: int,
               stream: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk partials (``part`` floats at least) and the zeroed tile
    tickets (``tickets`` at least) of one stream. The kernels leave their
    tickets at 0, so the calls on one stream share them; a workspace
    replaced by a larger one is freed in stream order, after the calls that
    use it, as long as each caller holds the two tensors until its launch
    is enqueued. The two returned are the ones checked here, so a thread
    that replaces the stream's entry meanwhile cannot hand another a
    smaller one."""
    ws = _WORKSPACES.setdefault((index, stream), [None, None])
    part_ws, tickets_ws = ws
    if part_ws is None or part_ws.numel() < part:
        part_ws = ws[0] = torch.empty(max(part, 1 << 16), dtype=torch.float32,
                                      device=torch.device("cuda", index))
    if tickets_ws is None or tickets_ws.numel() < tickets:
        tickets_ws = ws[1] = torch.zeros(max(tickets, 256), dtype=torch.int32,
                                         device=torch.device("cuda", index))
    return part_ws, tickets_ws


def _launch(x2d: torch.Tensor, out: torch.Tensor, plan: MomentsPlan, vec: int,
            sums: bool = False) -> None:
    """Enqueue K4 on x2d's device and current stream, mean and var into out
    (with ``sums``, Σx and Σx²)."""
    index = x2d.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    part, tickets = _workspace(index, plan.part, plan.tiles, stream)
    entry = build.entry_name("moments_sums" if sums else "moments", x2d)
    build.launch_on(index, stream, build.entry(entry), x2d.data_ptr(),
                    part.data_ptr(), tickets.data_ptr(), out.data_ptr(), x2d.shape[0],
                    x2d.shape[1], plan.chunk, plan.n_chunks, vec, plan.ctv, plan.threads)


def _forward(x2d: torch.Tensor, sums: bool = False):
    """(mean, var) of x2d, or with ``sums`` (Σx, Σx²): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not x2d.is_cuda:
        if x2d.dim() != 2:
            raise ValueError(f"moments: expected (M, C), got {tuple(x2d.shape)}")
        build.on_card("moments", x2d)  # raises on what the kernel would not take
        return moments_sums_reference(x2d) if sums else moments_reference(x2d)
    if (x2d.dim() != 2 or x2d.dtype not in (torch.float32, torch.bfloat16)
            or not x2d.is_contiguous()):
        raise ValueError(f"moments: expected a contiguous float32 or bfloat16 (M, C) "
                         f"tensor, got {x2d.dtype} {tuple(x2d.shape)}")
    m, c = x2d.shape
    if m == 0 or c == 0:
        raise ValueError(f"moments: empty input {tuple(x2d.shape)}")
    vec = vector_width(x2d)
    plan = moments_plan(m, c, vec)
    out = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    _launch(x2d, out, plan, vec, sums)
    build.count(__name__, "LAUNCHES", x2d)
    return out.unbind(0)


def moments_sums(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw (Σx, Σx²) over the rows of x2d (M, C), fp32: one K4 launch in
    its sums mode on a CUDA tensor, ``moments_sums_reference`` on a CPU one.
    Not differentiable by itself: ``moments`` carries it inside
    ``sync_stats``."""
    return _forward(x2d, sums=True)


class StatsGroup(NamedTuple):
    """The ranks whose rows make one batch for BN: ``reduce`` sums a tensor
    in place over them (``parallel.mesh.Mesh.sum_`` of the data group), and
    this rank is ``index`` of ``size``, holding rows [index * n, (index + 1)
    * n) of each global (micro)batch of size * n rows (``parallel.rows_of``)."""
    reduce: Callable[[torch.Tensor], None]
    index: int = 0
    size: int = 1


# the statistics group that batch statistics are summed over (``sync_stats``),
# or None; not thread-local, since a checkpointed block's forward reruns
# inside the backward on the autograd engine's device thread
_SYNC: Optional[StatsGroup] = None


@contextlib.contextmanager
def sync_stats(reduce, index: int = 0, size: int = 1):
    """Within the block, batch statistics are those of the batch of every
    rank of a statistics group: ``reduce`` a ``StatsGroup``, or its in-place
    sum with this rank's ``index`` of ``size``; None leaves them this
    process's own."""
    global _SYNC
    group = (reduce if reduce is None or isinstance(reduce, StatsGroup)
             else StatsGroup(reduce, index, size))
    before, _SYNC = _SYNC, group
    try:
        yield
    finally:
        _SYNC = before


def stats_group() -> Optional[StatsGroup]:
    """The statistics group in force (``sync_stats``), or None."""
    return _SYNC


def sample_rows(n: int) -> Tuple[int, int]:
    """(rows of the global batch, this rank's first row in it) for a batch
    dimension of n rows here: (n, 0) outside ``sync_stats``."""
    if _SYNC is None:
        return n, 0
    return n * _SYNC.size, n * _SYNC.index


def summed(reduce, sums: torch.Tensor, m):
    """(sums, m) over the ranks ``reduce`` reaches, in one float64 all-reduce:
    fp32 per-channel sums of any shape and their row count m (an int),
    returned as fp32 (the count exact, no rounding added to the sums of two
    ranks), m a device scalar, so nothing waits for the host."""
    n = sums.numel()
    buf = torch.empty(n + 1, dtype=torch.float64, device=sums.device)
    buf[:n].copy_(sums.reshape(-1))
    buf[n:].fill_(m)
    reduce(buf)
    return buf[:n].to(torch.float32).view(sums.shape), buf[n].to(torch.float32)


def _global_stats(x, sums, reduce):
    """(mean, var, m) from this rank's raw sums (s, s2) of x, summed with
    the row count over the ranks (``summed``)."""
    s, s2 = sums
    total, m = summed(reduce, torch.stack((s, s2)), x.numel() // s.numel())
    mean, var = mean_var_from_sums(total[0], total[1], m)
    return mean, var, m


class _SumStats(torch.autograd.Function):
    """``summed`` as a Function: the cotangent of the summed sums is summed
    over the same ranks (every rank's loss depends on them)."""

    @staticmethod
    def forward(ctx, sums, m, reduce):
        total, m_all = summed(reduce, sums, m)
        ctx.reduce = reduce
        ctx.mark_non_differentiable(m_all)
        return total, m_all

    @staticmethod
    def backward(ctx, dsums, _dm):
        d = dsums.to(torch.float32, copy=True).contiguous()
        ctx.reduce(d)
        return d, None, None


def sum_stats(sums: torch.Tensor, m: int):
    """(sums, m) of the statistics group in force: a layer's raw per-channel
    sums (fp32, e.g. K8's [Σy, Σy²]) and their row count, summed over the
    group's ranks, differentiable in the sums (``_SumStats``); outside
    ``sync_stats`` the arguments themselves."""
    if _SYNC is None:
        return sums, m
    return _SumStats.apply(sums, m, _SYNC.reduce)


class _Moments(torch.autograd.Function):
    """(mean, var) by ``value``; with ``reduce``, ``value`` gives the raw
    sums and the statistics are those of every rank's rows."""

    @staticmethod
    def forward(ctx, x, value, channel_dim=-1, reduce=None):
        if reduce is None:
            mean, var = value(x)
            m = x.numel() // mean.numel()
        else:
            mean, var, m = _global_stats(x, value(x), reduce)
        ctx.channel_dim, ctx.reduce, ctx.m = channel_dim, reduce, m
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        shape = [1] * x.dim()
        shape[ctx.channel_dim] = -1
        m = ctx.m
        if ctx.reduce is not None:
            # the statistics depend on every rank's rows: sum their cotangents
            both = torch.cat([dmean, dvar])
            ctx.reduce(both)
            dmean, dvar = both.chunk(2)
        dx = (dmean.view(shape) / m
              + dvar.view(shape) * 2.0 * (x.to(torch.float32) - mean.view(shape)) / m)
        return dx.to(x.dtype), None, None, None


def moments(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-read (mean, var) over the rows of x2d (M, C); differentiable
    where x2d requires a gradient. Inside ``sync_stats`` the rows of every
    rank: K4's raw sums, summed over the ranks."""
    if _SYNC is not None:
        return _Moments.apply(x2d, moments_sums, -1, _SYNC.reduce)
    if x2d.requires_grad and torch.is_grad_enabled():
        return _Moments.apply(x2d, _forward)
    return _forward(x2d)


def moments_plain(x: torch.Tensor, channel_dim: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moments`` with the plain sums on every device, over every dimension
    of x but ``channel_dim`` (the rows of an (M, C) view by default); never
    launches. Inside ``sync_stats`` the rows of every rank, as ``moments``."""
    if _SYNC is not None:
        return _Moments.apply(
            x, functools.partial(moments_sums_reference, channel_dim=channel_dim),
            channel_dim, _SYNC.reduce)
    return _Moments.apply(x, functools.partial(moments_reference, channel_dim=channel_dim),
                          channel_dim)


# --------------------------------------------------------------- K5 apply


def bn_apply_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                       relu: bool, cap=None) -> torch.Tensor:
    """Plain version: x · scale + shift, then ReLU and the cap, in fp32 on
    the upcast x with scale and shift over its last dimension, rounded once
    to x's dtype."""
    y = x.float() * scale.float() + shift.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
        if cap is not None:
            y = torch.clamp_max(y, cap)
    return y.to(x.dtype)


def bn_apply_bwd(x, dy, scale, shift, *, relu: bool, cap=None):
    """(dx, dscale, dshift) of ``bn_apply`` at dy, in torch ops: the gate
    recomputed from x (fused.py:104-117, fused_conv.py:219-236), in fp32 on
    the upcast x and dy; dx rounded to x's dtype, dscale and dshift to the
    rows' dtypes."""
    xf, dv, sf = x.float(), dy.float(), scale.float()
    if relu:
        v = xf * sf + shift.float()
        gate = v > 0 if cap is None else (v > 0) & (v < cap)
        dv = torch.where(gate, dv, torch.zeros_like(dv))
    axes = tuple(range(x.dim() - 1))
    return ((dv * sf).to(x.dtype), (dv * xf).sum(axes).to(scale.dtype),
            dv.sum(axes).to(shift.dtype))


def _check_rows(name, c, *rows):
    for r in rows:
        if tuple(r.shape) != (c,):
            raise ValueError(f"{name}: per-channel rows must be ({c},), got {tuple(r.shape)}")


def bn_apply(x2d: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
             relu: bool, cap=None) -> torch.Tensor:
    """clip(relu(x · scale + shift)) over x2d (M, C), fp32 or bf16, with (C,)
    rows; relu and cap optional (cap only with relu, as in bn.py:136-139).
    The result has x2d's dtype."""
    if x2d.dim() != 2:
        raise ValueError(f"bn_apply: expected (M, C), got {tuple(x2d.shape)}")
    _check_rows("bn_apply", x2d.shape[1], scale, shift)
    scale, shift = build.rows_f32(scale, shift)
    if not build.on_card("bn_apply", x2d, rows=(scale, shift)):
        return bn_apply_reference(x2d, scale, shift, relu=relu, cap=cap)
    y = torch.empty_like(x2d)
    if x2d.numel():
        build.launch(build.entry_name("bn_apply", x2d), x2d.data_ptr(), scale.data_ptr(),
                     shift.data_ptr(), y.data_ptr(), x2d.numel(), x2d.shape[1], int(relu),
                     int(cap is not None), 0.0 if cap is None else float(cap),
                     device=x2d.device)
        build.count(__name__, "APPLY_LAUNCHES", x2d)
    return y


# ------------------------------------------------------------ K6 backward


def bn_bwd_reference(x2d, dy, mean, inv_std, gamma, beta, *, relu: bool):
    """Plain version of the backward: (dx, dgamma, dbeta) in torch, in fp32
    on the upcast x, dy and rows, each product and sum rounded as the kernel
    rounds it; dx in x2d's dtype, dgamma and dbeta in gamma's (beta's).
    ``beta`` may be None without ``relu``."""
    m = x2d.shape[0]
    xf, dyf, g = x2d.float(), dy.float(), gamma.float()
    x_hat = (xf - mean) * inv_std
    if relu:
        dyf = torch.where(x_hat * g + beta.float() > 0, dyf, torch.zeros_like(dyf))
    s1 = dyf.sum(0)
    s2 = (dyf * x_hat).sum(0)
    dx = g * inv_std * (dyf - s1 / m - x_hat * (s2 / m))
    return (dx.to(x2d.dtype), s2.to(gamma.dtype),
            s1.to(gamma.dtype if beta is None else beta.dtype))


class BwdPlan(NamedTuple):
    """A K6 launch: ``vec`` values a lane (a 16-byte access, or 1), ``ctv``
    lanes a channel tile, ``tiles`` channel tiles (a counter each),
    ``chunk`` rows a block, ``n_chunks`` blocks a tile, ``part`` floats of
    chunk partials, and ``fused``: one cooperative launch, or two."""
    vec: int
    ctv: int
    tiles: int
    chunk: int
    n_chunks: int
    part: int
    fused: bool


def bwd_vector_width(x2d: torch.Tensor, dy: torch.Tensor) -> int:
    """The values a K6 lane reads at once: 16 bytes (4 fp32 or 8 bf16) where
    C is a multiple of that and x and dy start on 16-byte boundaries (dx, a
    new tensor, always does), else 1."""
    n = 16 // x2d.element_size()
    aligned = x2d.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    return n if aligned and x2d.shape[1] % n == 0 else 1


@functools.lru_cache(maxsize=1024)
def bn_bwd_plan(m: int, c: int, vec: int, sms: int) -> BwdPlan:
    """K6's launch for an (m, c) view read ``vec`` values a lane on a card
    of ``sms`` SMs. ctv is the power of two that covers c / vec, at most 8
    lanes of 16 bytes or 32 of one value, so that a tile is 128 bytes of a
    row (32 fp32 or 64 bf16 channels, 32 channels a value at a time). Where
    the tiles fit one block a SM, each tile gets as many row chunks as fill
    the SMs in that one wave (``fused``: the reduction and the dx pass in
    one cooperative launch); else about four blocks a SM in two launches.
    A chunk is a multiple of 8 rows and gives each row lane at least
    BWD_ROWS rows. A function of the shapes and the card only, so a call
    repeats exactly."""
    lanes = -(-c // vec)
    ctv = min(8 if vec > 1 else 32, 1 << (lanes - 1).bit_length())
    tiles = -(-c // (vec * ctv))
    fused = tiles <= sms
    want = sms // tiles if fused else -(-4 * sms // tiles)
    rows = max(-(-m // want), _BWD_ROWS * (_BWD_THREADS // ctv), -(-m // _MAX_CHUNKS))
    chunk = -(-rows // 8) * 8
    n_chunks = -(-m // chunk)
    return BwdPlan(vec, ctv, tiles, chunk, n_chunks, 2 * n_chunks * c, fused)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_launch(x2d, dy, rows, sums, dx, plan: BwdPlan, relu: bool) -> None:
    """Enqueue K6 on x2d's device and current stream: dx, and s1 and s2 into
    the rows of sums."""
    index = x2d.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    part, tickets = _workspace(index, plan.part, plan.tiles, stream)
    build.launch_on(index, stream, build.entry(build.entry_name("bn_bwd", x2d)),
                    x2d.data_ptr(), dy.data_ptr(), *(r.data_ptr() for r in rows),
                    part.data_ptr(), tickets.data_ptr(), sums.data_ptr(), dx.data_ptr(),
                    x2d.shape[0], x2d.shape[1], plan.chunk, plan.n_chunks, int(plan.vec > 1),
                    plan.ctv, int(plan.fused), int(relu))


def bn_bwd(x2d, dy, mean, inv_std, gamma, beta, *, relu: bool):
    """(dx, dgamma, dbeta) of ``batch_norm_act`` at the output gradient dy,
    from its input x2d (M, C) and the forward's mean and inv_std; dx in
    x2d's dtype, dgamma and dbeta in gamma's and beta's."""
    if x2d.dim() != 2 or dy.shape != x2d.shape:
        raise ValueError(f"bn_bwd: x {tuple(x2d.shape)}, dy {tuple(dy.shape)}")
    m, c = x2d.shape
    _check_rows("bn_bwd", c, mean, inv_std, gamma, beta)
    rows = build.rows_f32(mean, inv_std, gamma, beta)
    if not build.on_card("bn_bwd", x2d, dy, rows=rows):
        return bn_bwd_reference(x2d, dy, mean, inv_std, gamma, beta, relu=relu)
    if m == 0 or c == 0:
        raise ValueError(f"bn_bwd: empty input {tuple(x2d.shape)}")
    plan = bn_bwd_plan(m, c, bwd_vector_width(x2d, dy), _sms(x2d.device.index))
    dx = torch.empty_like(x2d)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    _bwd_launch(x2d, dy, rows, sums, dx, plan, relu)
    build.count(__name__, "BWD_LAUNCHES", x2d)
    dbeta, dgamma = sums.unbind(0)
    if gamma.dtype != torch.float32:  # a bf16 parameter's
        dgamma = dgamma.to(gamma.dtype)
    if beta.dtype != torch.float32:
        dbeta = dbeta.to(beta.dtype)
    return dx, dgamma, dbeta


class _BatchNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, gamma, beta, eps, relu):
        mean, var = _forward(x2d)
        inv_std = torch.rsqrt(var + eps)
        scale = gamma.float() * inv_std
        shift = beta.float() - scale * mean
        y = bn_apply(x2d, scale, shift, relu=relu)
        ctx.relu = relu
        ctx.save_for_backward(x2d, gamma, beta, mean, inv_std)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, gamma, beta, mean, inv_std = ctx.saved_tensors
        dx, dgamma, dbeta = bn_bwd(x2d, dy.contiguous(), mean, inv_std, gamma, beta,
                                   relu=ctx.relu)
        return dx, dgamma, dbeta, None, None


def batch_norm_act(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-7, relu: bool = True):
    """Training-mode BN(+ReLU) of x2d (M, C), fp32 or bf16: (y, mean, var),
    y in x2d's dtype, the batch statistics in fp32 and not differentiated.
    Differentiable in x2d, gamma and beta."""
    return _BatchNormAct.apply(x2d, gamma, beta, eps, relu)


def bn_act_reference(x2d, gamma, beta, eps: float = 1e-7, relu: bool = True):
    """Plain torch ops (bn.py:288-299) in fp32 on the upcast x2d, y rounded
    to its dtype, differentiated by autograd through the statistics too."""
    xf = x2d.float()
    mean = xf.mean(0)
    var = torch.clamp_min((xf * xf).mean(0) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    y = (xf - mean) * inv * gamma.float() + beta.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x2d.dtype), mean, var
