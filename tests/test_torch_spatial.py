"""Spatial partitioning (resnet_tpu_torch.parallel.spatial) on the CPU: K1
and the fused sites with JAX's explicit padding, the row plan and the
tiles of a layer's own padding, the halo exchange, and the data x spatial
step of every engine JAX runs there against JAX's.

K1's plain versions (forward, dx, dW) at a tile's paddings are held to
JAX's ``conv2d_pallas(..., padding=..., interpret=True)`` and its VJP (fp32
within 1e-5 of max, bf16 within one bf16 ulp + 1e-5 of max); a negative
padding, which JAX's Pallas VJP cannot run, to the plain torch conv's
autograd. ``conv_chain`` and K8's plain version at a tile's padding are
held to JAX's ``fused_conv(..., padding=..., interpret=True)`` and its VJP.
The row plan is checked on ResNet-50 at 224 on 2 and 4 ranks, the tiles
of the s2d stem's fold and folded conv on their own paddings.

Two spawns of ``resnet_tpu_torch.tools.distributed_worker`` (gloo ranks on
the CPU, started once for the module each): four ranks run the step on
the 2 x 2 and 1 x 4 data x spatial grids and the partitioned conv, pools
and fused sites at uneven splits; two ranks the 1 x 2 grid, the engines
and modes the spatial step takes (the fused engines and the s2d stem
among them), the partitioned ops at 2 ranks, and the Trainer with
``spatial_devices=2``; the CLI's ``--evaluate`` (float and ``--int8``)
under torchrun with ``--spatial-devices 2`` against one process. Each
step is held to JAX's one-device step and to
JAX's own spatial step (``make_mesh_2d(2, 2, axes=("data", "spatial"))``
with ``spatial_shard_batch``) at tests/test_parallel.py:232-247's
tolerances, or to the port's one-process step at DP_TOL; bf16 within
twice the bf16-vs-fp32 gap (the port's own, and for 'fused' JAX's too).
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.kernels.conv import conv2d_pallas
from resnet_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from resnet_tpu.parallel import replicate as j_replicate
from resnet_tpu.parallel import spatial_shard_batch as j_spatial_shard_batch
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.kernels import checks, conv
from resnet_tpu_torch.ops.conv import conv2d as plain_conv2d
from resnet_tpu_torch.parallel import spatial
from resnet_tpu_torch.parallel.mesh import spatial_batch_specs
from resnet_tpu_torch.train import init_train_state, make_train_step

from test_torch_parallel import BATCH, DP_TOL, KERNELS, SGD, _close, _spawn

JAX_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_parallel.py:243-247
SPAWN_TIMEOUT = 300
PALLAS = dict(KERNELS)
XLA = dict(kernels="xla")
WIDE = dict(input_dim=56)  # 4 ranks: the pool's rows 4, 3, 4, 3, stage 2's 2, 2, 2, 1

# --------------------------------------------------------------- K1's padding

# (H, W, Cin, Cout, k, stride, padding): a tile's rows under JAX's explicit
# padding, the reference's along W
PAD_CASES = [
    (6, 8, 4, 8, 3, 1, ((0, 0), (1, 1))),
    (6, 8, 4, 8, 3, 1, ((1, 0), (1, 1))),
    (7, 8, 4, 8, 3, 2, ((0, 0), (1, 0))),
    (7, 8, 4, 8, 3, 2, ((1, 0), (1, 0))),
    (9, 10, 3, 8, 7, 2, ((3, 0), (3, 2))),
    (9, 10, 3, 8, 7, 2, ((0, 2), (3, 2))),
]


def _pad_inputs(case, dtype=np.float32):
    h, wd, cin, cout, k, s, pad = case
    rng = np.random.default_rng(h * 100 + k * 10 + s + pad[0][0])
    x = rng.normal(0, 1, (2, h, wd, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    (lo, hi), (lo_w, hi_w) = pad
    ho, wo = (h + lo + hi - k) // s + 1, (wd + lo_w + hi_w - k) // s + 1
    g = rng.normal(0, 1, (2, ho, wo, cout)).astype(np.float32)
    return x, w, g


def _jax_conv(x, w, g, s, pad, dtype):
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    y, vjp = jax.vjp(lambda a, b: conv2d_pallas(a, b, s, pad, True), jx, jw)
    dx, dw = vjp(jnp.asarray(g, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dw)]


def _torch_conv(x, w, g, s, pad, dtype):
    tx, tw = (torch.from_numpy(a).to(dtype) for a in (x, w))
    tg = torch.from_numpy(g).to(dtype)
    y = conv.conv2d(tx, tw, s, pad)
    return [t.float().numpy() for t in (
        y, conv.conv2d_dx(tg, tw, tx.shape, s, pad), conv.conv2d_dw(tx, tg, w.shape[0], s, pad))]


@pytest.mark.parametrize("case", PAD_CASES, ids=[f"{c[4]}x{c[4]}s{c[5]} {c[6][0]}" for c in
                                                 PAD_CASES])
def test_k1_padding_matches_jax_conv2d_pallas(case):
    """conv.conv2d with JAX's explicit padding, and its dx and dW, against
    JAX's conv2d_pallas at that padding (interpret mode) and its VJP: fp32
    within 1e-5 of max; the output grid is JAX's (H + lo + hi - k) // s + 1."""
    x, w, g = _pad_inputs(case)
    s, pad = case[5], case[6]
    for name, got, want in zip(("y", "dx", "dw"), _torch_conv(x, w, g, s, pad, torch.float32),
                               _jax_conv(x, w, g, s, pad, jnp.float32)):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", PAD_CASES[::2], ids=[f"{c[4]}x{c[4]}s{c[5]} {c[6][0]}"
                                                      for c in PAD_CASES[::2]])
def test_k1_padding_bf16_matches_jax_within_an_ulp(case):
    """The same in bf16: each element within one bf16 ulp of JAX's plus
    1e-5 of max (JAX's dW is fp32 from the upcast inputs, cast once)."""
    x, w, g = _pad_inputs(case)
    s, pad = case[5], case[6]
    for name, got, want in zip(("y", "dx", "dw"), _torch_conv(x, w, g, s, pad, torch.bfloat16),
                               _jax_conv(x, w, g, s, pad, jnp.bfloat16)):
        want_t = torch.from_numpy(np.array(want))
        slack = checks.bf16_slack(want_t).numpy() + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= slack), name


@pytest.mark.parametrize("pad", [((-1, -1), (0, -1)), ((-1, 0), (0, -1)), ((0, -1), (0, 0))])
def test_k1_negative_padding_matches_autograd(pad):
    """A 1x1/s2 on a tile whose window grid starts or ends inside it
    (negative lo or hi: JAX's Pallas VJP cannot run it) against the plain
    torch conv's autograd, in float64."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(0, 1, (2, 7, 8, 4)), requires_grad=True)
    w = torch.tensor(rng.normal(0, 0.3, (1, 1, 4, 6)), requires_grad=True)
    want = plain_conv2d(x, w, stride=2, padding=pad)
    g = torch.tensor(rng.normal(0, 1, tuple(want.shape)))
    dx, dw = torch.autograd.grad(want, (x, w), g)
    xf, wf = x.detach().float().requires_grad_(True), w.detach().float().requires_grad_(True)
    got = conv.conv2d(xf, wf, 2, pad)
    gx, gw = torch.autograd.grad(got, (xf, wf), g.float())
    for name, a, b in (("y", got, want), ("dx", gx, dx), ("dw", gw, dw)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0,
                                   atol=1e-5 * float(b.detach().abs().max()), err_msg=name)


def test_k1_without_padding_is_the_reference_geometry():
    """padding=None is the reference's centred windows: the explicit
    reference padding gives the same values, and a stride that does not
    divide H is refused only without a padding."""
    from resnet_tpu_torch.ops.padding import reference_padding

    x, w = torch.randn(2, 8, 8, 4), torch.randn(3, 3, 4, 8)
    pad = (reference_padding(8, 3, 2), reference_padding(8, 3, 2))
    assert torch.equal(conv.conv2d(x, w, 2), conv.conv2d(x, w, 2, pad))
    assert conv.geometry(8, 8, 3, 2, None) == (1, 1, 4, 4)
    with pytest.raises(ValueError, match="must divide"):
        conv.conv2d(torch.randn(2, 7, 8, 4), w, 2)
    assert conv.conv2d(torch.randn(2, 7, 8, 4), w, 2, ((1, 0), (1, 0))).shape == (2, 3, 4, 8)


def test_k1_padded_op_passes_opcheck():
    """The padded call through the served custom op conv2d_nhwc: its
    schema, its fake against its CPU implementation, with a padding and
    without one; the padding is optional and defaults to None, so a program
    saved with the three-argument op still binds."""
    from resnet_tpu_torch.kernels import ops

    x, w = torch.randn(2, 7, 8, 4), torch.randn(3, 3, 4, 8)
    torch.library.opcheck(ops.conv2d_nhwc, (x, w, 2, [1, 0, 1, 0]))
    torch.library.opcheck(ops.conv2d_nhwc, (torch.randn(2, 8, 8, 4), w, 2))
    assert ops.conv2d_nhwc(x, w, 2, [1, 0, 1, 0]).shape == (2, 3, 4, 8)
    even = x[:, :6].contiguous()
    assert torch.equal(ops.conv2d_nhwc(even, w, 2), ops.conv2d_nhwc(even, w, 2, None))
    padding = ops.conv2d_nhwc._schema.arguments[3]
    assert padding.name == "padding" and padding.default_value is None


# (H, W, Cin, Cout, k, stride, padding, prologue): a site on a tile's rows
# under JAX's explicit padding, the reference's along W
CHAIN_PAD_CASES = [
    (6, 8, 4, 8, 3, 1, ((1, 0), (1, 1)), True),
    (6, 8, 4, 8, 3, 1, ((0, 1), (1, 1)), True),
    (7, 8, 4, 8, 3, 2, ((0, 0), (1, 0)), True),
    (7, 7, 4, 8, 1, 2, ((0, 0), (0, 0)), False),
]


@pytest.mark.parametrize("fn", ["chain", "fused"])
@pytest.mark.parametrize("case", CHAIN_PAD_CASES, ids=[f"{c[4]}x{c[4]}s{c[5]} {c[6][0]}"
                                                       for c in CHAIN_PAD_CASES])
def test_site_padding_matches_jax_fused_conv(case, fn):
    """``conv_chain`` and K8's plain version (``fused_conv`` on CPU tensors)
    with an explicit padding against JAX's ``fused_conv(..., padding=...,
    interpret=True)`` and its VJP: y and the sums, then dx, dW, dscale and
    dshift at seeded cotangents of both, fp32 within 1e-5 of max."""
    from resnet_tpu.kernels.fused_conv import fused_conv as j_fused_conv
    from resnet_tpu_torch.kernels import fused_conv

    h, wd, cin, cout, k, s, pad, pro = case
    rng = np.random.default_rng(h * 10 + k + s)
    x = rng.normal(0, 1, (2, h, wd, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, cin, cout)).astype(np.float32)
    scale = rng.normal(1, 0.2, cin).astype(np.float32)
    shift = (0.1 + np.abs(rng.normal(0, 0.5, cin))).astype(np.float32)
    (lo, hi), (lo_w, hi_w) = pad
    gy = rng.normal(0, 1, (2, (h + lo + hi - k) // s + 1, (wd + lo_w + hi_w - k) // s + 1,
                           cout)).astype(np.float32)
    gs = rng.normal(0, 1, (2, cout)).astype(np.float32)
    (jy, jsums), vjp = jax.vjp(
        lambda *a: j_fused_conv(*a, s, pad, pro, True, True), *map(jnp.asarray,
                                                                     (x, w, scale, shift)))
    want = [jy, jsums, *vjp((jnp.asarray(gy), jnp.asarray(gs)))]
    leaves_ = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, scale, shift)]
    y, sums = (fused_conv.conv_chain(*leaves_, s, pro, True, None, pad) if fn == "chain"
               else fused_conv.fused_conv(*leaves_, s, pad, pro, True, None))
    ((y * torch.from_numpy(gy)).sum() + (sums * torch.from_numpy(gs)).sum()).backward()
    got = [y, sums] + [t.grad for t in leaves_]
    names = ("y", "sums", "dx", "dw", "dscale", "dshift")
    for name, a, b in zip(names, got, want, strict=True):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30), err_msg=name)


# ----------------------------------------------------------------- the plan


def _resnet50_rows(ranks):
    """The rows at each height of ResNet-50 at 224 on ``ranks``."""
    height, rows = 224, spatial.even_rows(224, ranks)
    out = {224: rows}
    while height > 7:
        height, rows = spatial.next_rows(rows, height, 2)
        out[height] = rows
    return out


def test_row_plan_of_resnet50_at_224():
    """Output row o on the rank of row s*o: on 2 ranks stage 4 is 4 + 3
    rows; on 4 ranks stage 3 is 4, 3, 4, 3 rows from rows 0, 4, 7, 11 and
    stage 4 2, 2, 2, 1."""
    two, four = _resnet50_rows(2), _resnet50_rows(4)
    assert [b - a for a, b in two[7]] == [4, 3]
    assert [b - a for a, b in four[14]] == [4, 3, 4, 3]
    assert [a for a, _ in four[14]] == [0, 4, 7, 11]
    assert [b - a for a, b in four[7]] == [2, 2, 2, 1]
    assert four[112] == ((0, 28), (28, 56), (56, 84), (84, 112))


def test_plan_with_an_empty_rank_raises_naming_the_sizes():
    with pytest.raises(ValueError, match=r"4 ranks over 4 rows at stride 2 leave rank"):
        spatial.next_rows(spatial.even_rows(4, 4), 4, 2)
    with pytest.raises(ValueError, match="do not split evenly"):
        spatial.even_rows(10, 4)


def test_tiles_take_the_reference_padding_at_the_edges_only():
    """The stem's 7x7/s2 on 2 ranks at 224: the top tile pads 3 above and
    takes 2 rows from below, the bottom tile takes 3 from above and pads 2
    below (the reference's (3, 2)); a 1x1/s2 on a tile whose first row is
    odd has padding -1; a halo past the neighbour's rows raises."""
    rows = spatial.even_rows(224, 2)
    top, bottom = spatial.tiles_of(rows, 224, 7, 2)
    assert (top.top, top.bottom, top.lo, top.hi, top.ho) == (0, 2, 3, 0, 56)
    assert (bottom.top, bottom.bottom, bottom.lo, bottom.hi, bottom.ho) == (3, 0, 0, 2, 56)
    t = spatial.tile_of(_resnet50_rows(4)[28], 1, 28, 1, 2)
    assert (t.top, t.bottom, t.lo, t.ho) == (0, 0, -1, 3)
    with pytest.raises(ValueError, match="beyond its neighbours"):
        spatial.tiles_of(((0, 1), (1, 2), (2, 8)), 8, 7, 1)


def test_tiles_of_an_explicit_padding():
    """The tile helpers with a global padding other than the reference's:
    the s2d stem's folded 4x4/s1 conv padded (2, 1) takes 2 halo rows
    above a seam and 1 below, its (2, 1) at the image's edges only; the
    fold's 2x2/s2 padded (0, 0) takes no halo on even rows and, on rows
    [0, 3), [3, 8), rank 0 takes row 3 from below and rank 1 drops it
    (padding -1). The fold's output keeps the 7x7/s2 stem's plan, and a
    padding that does not give H / s rows raises."""
    rows = spatial.even_rows(112, 2)
    top, bottom = spatial.tiles_of(rows, 112, 4, 1, (2, 1))
    assert (top.top, top.bottom, top.lo, top.hi, top.ho) == (0, 1, 2, 0, 56)
    assert (bottom.top, bottom.bottom, bottom.lo, bottom.hi, bottom.ho) == (2, 0, 0, 1, 56)
    a, b = spatial.tiles_of(((0, 3), (3, 8)), 8, 2, 2, (0, 0))
    assert (a.top, a.bottom, a.lo, a.hi, a.ho) == (0, 1, 0, 0, 2)
    assert (b.top, b.bottom, b.lo, b.hi, b.ho) == (0, 0, -1, 0, 2)
    assert all(t.top == t.bottom == t.lo == t.hi == 0
               for t in spatial.tiles_of(spatial.even_rows(224, 4), 224, 2, 2, (0, 0)))
    part = spatial.Partition(_FakeGroup(), {})
    x = torch.zeros(1, 112, 224, 3)
    _, pad = part.tiles(x, 2, 2, "NHWC", ((0, 0), (0, 0)))
    assert pad == ((0, 0), (0, 0))
    _, pad = part.tiles(torch.zeros(1, 56, 112, 12), 4, 1, "NHWC", ((2, 1), (2, 1)))
    assert pad == ((2, 0), (2, 1))
    part.tiles(x, 7, 2, "NHWC")  # the 7x7/s2 stem's plan is the fold's
    assert part.plans[112] == (112, ((0, 56), (56, 112)))
    with pytest.raises(ValueError, match="does not give"):
        spatial.tiles_of(rows, 112, 4, 1, (2, 2))


def test_tile_cases_of_phase_3_are_the_plans_tiles():
    """chip_smoke.py's K1 tile cases (kernels.checks.TILE_CASES) are tiles
    of the plan: each case's padding gives the rank's output rows."""
    assert len(checks.TILE_CASES) == 8
    for label, n, (h, wd), cin, cout, k, s, pad in checks.TILE_CASES:
        lo, hi = pad[0]
        assert label.startswith(checks.TILE)
        assert (h + lo + hi - k) // s + 1 >= 1
        assert conv.geometry(h, wd, k, s, pad)[3] == wd // s


def test_fused_tile_cases_of_phase_3_are_the_plans_tiles():
    """chip_smoke.py's K8 tile cases (kernels.checks.FUSED_TILE_CASES, run
    on K8 and K8-bf16) are tiles of the plan: the interior 3x3/s1 tile,
    rows 7-14 of 28 at 3x3/s2 (padding 0) and 1x1/s2 (padding -1, no
    prologue), stage 4's 4- and 3-row tiles, and the seam, which is exact;
    each case's padding gives the rank's output rows, W / s wide."""
    cases = checks.FUSED_TILE_CASES
    assert len(cases) == 6
    for case in cases:
        n, (h, wd), cin, cout, k, s, prologue, cap, pad, (ho, wo) = checks.fused_conv_case(case)
        assert case[0].startswith(checks.TILE) and cap is None
        assert prologue == (k == 3) and ho >= 1 and wo == wd // s
    pads = [c[-1][0] for c in cases]
    assert pads[1] == (0, 0) and pads[2] == (-1, -1)
    assert [checks.fused_conv_case(c)[-1][0] for c in cases[3:5]] == [4, 3]
    assert [", exact" in c[0] for c in cases] == [False] * 5 + [True]


def test_spatial_batch_specs_are_layout_aware():
    """JAX's specs: H is dim 1 in NHWC, dim 2 in NCHW; another layout
    raises naming it."""
    assert spatial_batch_specs(layout="NHWC")[0] == ("data", "spatial")
    assert spatial_batch_specs(layout="NCHW")[0] == ("data", None, "spatial")
    with pytest.raises(ValueError, match="layout"):
        spatial_batch_specs(layout="CHWN")


# ------------------------------------------------------------ spawned ranks


def _j_cfg(execution=None, model=None):
    return jcfg.TrainConfig(model=jcfg.tiny_model_config(**(model or {})),
                            execution=jcfg.ExecutionConfig(**(execution or {})),
                            optimizer=jcfg.OptimizerConfig(**SGD),
                            data=jcfg.DataConfig(batch_size=BATCH))


def _t_cfg(execution, model=None):
    return tcfg.TrainConfig(model=tcfg.tiny_model_config(**(model or {})),
                            execution=tcfg.ExecutionConfig(**execution),
                            optimizer=tcfg.OptimizerConfig(**SGD),
                            data=tcfg.DataConfig(batch_size=BATCH))


def _batch(dim, seed, layout="NHWC"):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 50, (BATCH, dim, dim, 3)).astype(np.float32)
    if layout == "NCHW":
        images = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
    return {"images": images, "labels": rng.integers(0, 8, BATCH).astype(np.int32)}


def _save_batch(tmp, name, batch):
    path = tmp / f"{name}.pt"
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, path)
    return str(path)


# (the ops of the partitioned-op cases: rows None is the even split)
OPS_2 = [
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=3, s=2),       # 7 + 7: odd first row
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=1, s=2),
    dict(op="conv", n=2, h=28, w=28, cin=3, cout=8, k=7, s=2),       # the stem's (3, 2)
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=3, s=1, engine="pallas"),
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=3, s=2, engine="pallas",
         layout="NCHW"),
    dict(op="max_pool", n=2, h=14, w=14, cin=4, k=3, s=2),
    dict(op="conv", n=2, h=7, w=7, cin=4, cout=4, k=3, s=1, rows=[[0, 4], [4, 7]]),
    dict(op="avg", n=2, h=7, w=7, cin=4, rows=[[0, 4], [4, 7]]),
    # the fused sites: K8's plain version on a 3x3 seam under the prologue
    # (shift > 0 on every channel), the chain at 3x3/s2 on 7 + 7 rows, and
    # the s2d stem on an uneven split (the fold takes row 3 from below)
    dict(op="fused", n=2, h=7, w=7, cin=4, cout=6, k=3, s=1, rows=[[0, 4], [4, 7]]),
    dict(op="fused", fn="chain", n=2, h=14, w=14, cin=4, cout=6, k=3, s=2),
    dict(op="s2d", n=2, h=8, w=8, cin=3, cout=8, k=7, rows=[[0, 3], [3, 8]]),
]
OPS_4 = [
    dict(op="conv", n=2, h=7, w=7, cin=4, cout=6, k=3, s=1,
         rows=[[0, 2], [2, 4], [4, 6], [6, 7]]),
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=3, s=2,
         rows=[[0, 4], [4, 7], [7, 11], [11, 14]]),
    dict(op="conv", n=2, h=14, w=14, cin=4, cout=6, k=1, s=2, engine="pallas",
         rows=[[0, 4], [4, 7], [7, 11], [11, 14]]),
    dict(op="max_pool", n=2, h=14, w=14, cin=4, k=3, s=2,
         rows=[[0, 4], [4, 7], [7, 11], [11, 14]]),
    dict(op="conv", n=2, h=56, w=56, cin=3, cout=8, k=7, s=2, engine="pallas"),
    dict(op="avg", n=2, h=7, w=7, cin=4, rows=[[0, 2], [2, 4], [4, 6], [6, 7]]),
    # K8's plain version at 1x1/s2 under the prologue on tiles whose first
    # row is odd (padding -1), and the chain at 3x3/s1 on 2, 2, 2, 1 rows
    dict(op="fused", n=2, h=14, w=14, cin=4, cout=6, k=1, s=2,
         rows=[[0, 4], [4, 7], [7, 11], [11, 14]]),
    dict(op="fused", fn="chain", n=2, h=7, w=7, cin=4, cout=6, k=3, s=1,
         rows=[[0, 2], [2, 4], [4, 6], [6, 7]]),
]

FUSED = dict(kernels="fused")
S2D = dict(PALLAS, space_to_depth=True)
S2D_MODEL = dict(init_kernel=7)  # the 7x7/s2 stem that s2d folds
# name -> (mesh, execution, extra case fields, model overrides, batch layout)
STEPS_4 = {
    "s22_xla": ([2, 2], XLA, {}, None, "NHWC"),
    "s22_pallas": ([2, 2], PALLAS, {}, None, "NHWC"),
    "s22_zero": ([2, 2], PALLAS, {"zero": True}, None, "NHWC"),
    "s22_nchw": ([2, 2], dict(PALLAS, layout="NCHW"), {}, None, "NCHW"),
    "s14_xla": ([1, 4], XLA, {"audit": True}, WIDE, "NHWC"),
    "s14_pallas": ([1, 4], PALLAS, {}, WIDE, "NHWC"),
    "s22_fused": ([2, 2], FUSED, {}, None, "NHWC"),
    "s14_fused": ([1, 4], FUSED, {}, WIDE, "NHWC"),
    "s22_s2d": ([2, 2], S2D, {}, S2D_MODEL, "NHWC"),
}
STEPS_2 = {
    "s12_xla": ([1, 2], XLA, {}, None, "NHWC"),
    "s12_pallas": ([1, 2], PALLAS, {}, None, "NHWC"),
    "s12_bf16": ([1, 2], dict(PALLAS, compute_dtype="bfloat16"), {}, None, "NHWC"),
    "s12_bf16_params": ([1, 2], dict(PALLAS, compute_dtype="bfloat16",
                                     param_dtype="bfloat16"), {}, None, "NHWC"),
    "s12_ghost": ([1, 2], dict(PALLAS, bn_stats_batch=2), {}, None, "NHWC"),
    "s12_block": ([1, 2], dict(PALLAS, remat="block"), {}, None, "NHWC"),
    "s12_stage": ([1, 2], dict(PALLAS, remat="stage"), {}, None, "NHWC"),
    "s12_elementwise": ([1, 2], dict(PALLAS, remat="elementwise"), {}, None, "NHWC"),
    "s12_frozen": ([1, 2], dict(PALLAS, bn_mode="frozen"), {}, None, "NHWC"),
    "s12_grouped": ([1, 2], XLA, {"fresh": True}, dict(groups=2, width_multiplier=2.0),
                    "NHWC"),
    "s12_fused": ([1, 2], FUSED, {}, None, "NHWC"),
    "s12_hybrid": ([1, 2], dict(kernels="hybrid"), {}, None, "NHWC"),
    "s12_fusedxla": ([1, 2], dict(kernels="fusedxla"), {}, None, "NHWC"),
    "s12_fused_bf16": ([1, 2], dict(FUSED, compute_dtype="bfloat16"), {}, None, "NHWC"),
    "s12_s2d": ([1, 2], S2D, {}, S2D_MODEL, "NHWC"),
}
TABLES = {"4": STEPS_4, "2": STEPS_2}


def _spec(tmp, world, steps, ops, numpy_state):
    init = {"params": bridge.params_from_numpy(numpy_state.params, device="cpu"),
            "bn_state": bridge.params_from_numpy(numpy_state.bn_state, device="cpu")}
    torch.save(init, tmp / "state.pt")
    base = {"model": dataclasses.asdict(tcfg.tiny_model_config()), "execution": PALLAS,
            "optimizer": SGD, "data": {"batch_size": BATCH}}
    cases = [{"name": "ops", "kind": "spatial_ops", "mesh": [1, world], "ops": ops}]
    for name, (mesh, execution, extra, model, layout) in steps.items():
        config = {"execution": execution}
        if model:
            config["model"] = dataclasses.asdict(tcfg.tiny_model_config(**model))
            if "init_kernel" in model and not extra.get("fresh"):
                # JAX's init of that model: the stem's weight has its shape
                extra = dict(extra, state=_save_state(tmp, name, _np_state(model)))
        dim = (model or {}).get("input_dim", 16)
        cases.append(dict({"name": name, "mesh": mesh, "axes": ["data", "spatial"],
                           "config": config,
                           "batch": _save_batch(tmp, name, _batch(dim, 7, layout))}, **extra))
    return {"config": base, "state": str(tmp / "state.pt"),
            "batch": _save_batch(tmp, "batch", _batch(16, 7)), "cases": cases}


def _save_state(tmp, name, numpy_state):
    path = tmp / f"{name}_state.pt"
    torch.save({"params": bridge.params_from_numpy(numpy_state.params, device="cpu"),
                "bn_state": bridge.params_from_numpy(numpy_state.bn_state, device="cpu")}, path)
    return str(path)


_NP = {}


def _np_state(model=None):
    """JAX's init of the tiny model (with ``model``'s overrides), as numpy
    (made once a model)."""
    key = tuple(sorted((model or {}).items()))
    if key not in _NP:
        _NP[key] = jax.tree.map(np.asarray, j_init_train_state(_j_cfg(model=model)))
    return _NP[key]


@pytest.fixture(scope="module")
def numpy_state():
    return _np_state()


@pytest.fixture(scope="module")
def four(tmp_path_factory, numpy_state):
    """One spawn of four ranks: the 2 x 2 and 1 x 4 grids, the ops at 4."""
    tmp = tmp_path_factory.mktemp("spatial4")
    return _spawn(tmp, _spec(tmp, 4, STEPS_4, OPS_4, numpy_state), "run", world=4,
                  timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def two(tmp_path_factory, numpy_state):
    """One spawn of two ranks: the 1 x 2 grid's modes, the ops at 2, and the
    Trainer with spatial_devices=2."""
    tmp = tmp_path_factory.mktemp("spatial2")
    spec = _spec(tmp, 2, STEPS_2, OPS_2, numpy_state)
    spec["trainer"] = {"config": dict(_trainer_config(2), checkpoint_dir=str(tmp / "dumps")),
                       "steps": 2, "eval": 2}
    return _spawn(tmp, spec, "run", world=2, timeout=SPAWN_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _one_process(name, table_name):
    """The port's one-process step of a case (from JAX's init, or the
    seeded init for a fresh case) on the case's batch."""
    mesh, execution, extra, model, layout = TABLES[table_name][name]
    numpy_state = _np_state(model if model and "init_kernel" in model else None)
    cfg = _t_cfg(execution, model)
    if extra.get("fresh"):
        state = init_train_state(cfg, device="cpu")
    else:
        state = bridge.train_state_from_numpy(numpy_state, device="cpu")
        if cfg.execution.param_dtype != "float32":
            state = init_train_state(cfg, device="cpu")
            with torch.no_grad():
                for (_, t), (_, v) in zip(bridge.flatten(state.params), bridge.flatten(
                        bridge.params_from_numpy(numpy_state.params, device="cpu"))):
                    t.copy_(v.to(t.dtype))
    dim = (model or {}).get("input_dim", 16)
    return make_train_step(cfg)(state, _batch(dim, 7, layout))


@functools.lru_cache(maxsize=None)
def _jax_one_device(execution, model=None, dim=16):
    """JAX's one-device step of the config (items of the execution and
    model fields) on the batch of that image size."""
    cfg = _j_cfg(dict(execution), dict(model or ()))
    return j_make_train_step(cfg, donate=False)(j_init_train_state(cfg), _batch(dim, 7))


def _check_jax(rank, js, jm):
    m = rank["metrics"]
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    _close(rank["params"], js.params, "params vs JAX", **JAX_TOL)


def _check_port(rank, ts, tm, tol=DP_TOL):
    for k in ("loss", "loss_sum", "accuracy", "grad_norm"):
        np.testing.assert_allclose(rank["metrics"][k], tm[k].item(), rtol=2e-4, err_msg=k)
    _close(rank["params"], bridge.to_numpy(ts.params), "params vs one process", **tol)
    _close(rank["bn_state"], bridge.to_numpy(ts.bn_state), "running stats vs one process", **tol)


def _same_on_every_rank(ranks, name):
    m = ranks[0][name]["metrics"]
    assert all(r[name]["metrics"] == m for r in ranks), name


@pytest.mark.parametrize("name", ["s22_xla", "s14_xla"])
def test_spatial_step_matches_jax_one_device(four, name):
    """The port's spatial step on the 2 x 2 grid, and on 1 x 4 at input 56
    (the pool's rows 4, 3, 4, 3 from odd first rows, stage 2's 2, 2, 2, 1),
    'xla', against JAX's one-device step at JAX's tolerances; every rank
    reports the same metrics."""
    mesh, execution, _, model, _ = STEPS_4[name]
    dim = (model or {}).get("input_dim", 16)
    js, jm = _jax_one_device(tuple(execution.items()), tuple((model or {}).items()), dim)
    _same_on_every_rank(four, name)
    _check_jax(four[0][name], js, jm)


def test_spatial_step_matches_jax_spatial_step(four):
    """The same 2 x 2 step against JAX's own spatial step on
    make_mesh_2d(2, 2, axes=("data", "spatial")) with spatial_shard_batch,
    at tests/test_parallel.py:232-247's tolerances."""
    cfg = _j_cfg(XLA)
    mesh = j_make_mesh_2d(2, 2, axes=("data", "spatial"))
    placed = j_spatial_shard_batch(_batch(16, 7), mesh)
    step = j_make_train_step(cfg, mesh, donate=False, batch_shardings={
        "images": placed["images"].sharding, "labels": placed["labels"].sharding})
    js, jm = step(j_replicate(j_init_train_state(cfg), mesh), placed)
    _check_jax(four[0]["s22_xla"], js, jm)


@pytest.mark.parametrize("name", ["s22_pallas", "s12_pallas"])
def test_spatial_pallas_step_matches_jax_and_one_process(four, two, name):
    """kernels='pallas' with conv_kernels='pallas' (K1 with the tiles'
    padding, K4's raw sums over data x spatial, K2, K3) on the 2 x 2 and
    1 x 2 grids: against JAX's one-device step of that config (Pallas
    interpreted) and the port's one-process step at DP_TOL."""
    ranks, table = (four, "4") if name in STEPS_4 else (two, "2")
    js, jm = _jax_one_device(tuple(dict(PALLAS, pallas_interpret=True).items()))
    _same_on_every_rank(ranks, name)
    _check_jax(ranks[0][name], js, jm)
    _check_port(ranks[0][name], *_one_process(name, table))


@pytest.mark.parametrize("name", ["s14_pallas", "s22_nchw"])
def test_spatial_step_on_four_ranks_matches_one_process(four, name):
    """The 1 x 4 grid at 56 on the hand kernels, and the 2 x 2 grid in NCHW
    (H at dim 2; K1 through its NHWC transpose), against the port's
    one-process step at DP_TOL."""
    _same_on_every_rank(four, name)
    _check_port(four[0][name], *_one_process(name, "4"))


def test_zero_over_data_equals_the_replicated_spatial_step(four):
    """ZeRO on the 2 x 2 grid shards over the data group and replicates over
    spatial: the same step as the replicated one, within fp32 rounding of
    the gathers, and less state a rank."""
    z, r = four[0]["s22_zero"], four[0]["s22_pallas"]
    _close(z["params"], bridge.to_numpy(r["params"]), "zero vs replicated", rtol=1e-6, atol=1e-7)
    assert z["state_bytes"] < r["state_bytes"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(z["metrics"][k], r["metrics"][k], rtol=1e-6)


@pytest.mark.parametrize("name", ["s12_xla", "s12_ghost", "s12_block", "s12_stage",
                                  "s12_elementwise", "s12_frozen", "s12_grouped"])
def test_spatial_step_modes_match_one_process(two, name):
    """The 1 x 2 grid under 'xla', ghost BN (its sample by the data index:
    the first 2 images, both halves of each), remat block, stage and
    elementwise (the reruns' halo exchanges in the same order on each
    rank), BN frozen, and ResNeXt's grouped convs: the port's one-process
    step at DP_TOL."""
    _same_on_every_rank(two, name)
    _check_port(two[0][name], *_one_process(name, "2"))


@pytest.mark.parametrize("name", ["s12_bf16", "s12_bf16_params"])
def test_spatial_bf16_step_within_the_bf16_gap(two, name):
    """bf16 compute (and bf16 parameters) on the 1 x 2 grid: each parameter
    within twice the port's own bf16-vs-fp32 gap of the one-process bf16
    step, the loss within 1e-2."""
    ts, tm = _one_process(name, "2")
    fs, _ = _one_process("s12_pallas", "2")
    got = bridge.flatten(bridge.to_numpy(two[0][name]["params"]))
    want, fp32 = bridge.flatten(bridge.to_numpy(ts.params)), bridge.flatten(
        bridge.to_numpy(fs.params))
    for (path, a), (_, b), (_, c) in zip(got, want, fp32, strict=True):
        gap = np.abs(b.astype(np.float32) - c.astype(np.float32)).max()
        err = np.abs(a.astype(np.float32) - b.astype(np.float32)).max()
        assert err <= 2 * gap + 1e-6, (path, err, gap)
    np.testing.assert_allclose(two[0][name]["metrics"]["loss"], tm["loss"].item(), rtol=1e-2)


FUSED_STEPS = ["s12_fused", "s22_fused", "s14_fused", "s12_hybrid", "s12_fusedxla",
               "s12_s2d", "s22_s2d"]


@pytest.mark.parametrize("name", FUSED_STEPS)
def test_spatial_fused_and_s2d_steps_match_jax_and_one_process(four, two, name):
    """The fused engines ('fused' on the 1 x 2, 2 x 2 and, at input 56, 1 x 4
    grids; 'hybrid' and 'fusedxla' on 1 x 2: every site on the rank's haloed
    tile of its raw input, K8's prologue on the neighbours' rows) and the
    s2d stem (kernels='pallas' with K1, the tiny model's 7x7/s2 stem folded
    on the rank's rows) against JAX's one-device step of the same config
    (Pallas interpreted): loss rtol 1e-5, grad_norm 1e-4, parameters at
    JAX's tolerances; and against the port's one-process step at DP_TOL.
    Every rank reports the same metrics."""
    ranks, table = (four, "4") if name in STEPS_4 else (two, "2")
    _, execution, _, model, _ = TABLES[table][name]
    dim = (model or {}).get("input_dim", 16)
    js, jm = _jax_one_device(tuple(dict(execution, pallas_interpret=True).items()),
                             tuple((model or {}).items()), dim)
    _same_on_every_rank(ranks, name)
    _check_jax(ranks[0][name], js, jm)
    _check_port(ranks[0][name], *_one_process(name, table))


def _within_gap(got, want, ref, what):
    """Each leaf of ``got`` within twice the bf16-vs-fp32 gap of ``want``
    (the bf16 step) to ``ref`` (the fp32 step), + 1e-6."""
    for (path, a), (_, b), (_, c) in zip(got, want, ref, strict=True):
        a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
        gap, err = np.abs(b - c).max(), np.abs(a - b).max()
        assert err <= 2 * gap + 1e-6, (what, path, err, gap)


def test_spatial_fused_bf16_step_within_the_bf16_gaps(two):
    """'fused' in bf16 on the 1 x 2 grid (K8-bf16's plain version on the
    tiles): each parameter within twice JAX's own bf16-vs-fp32 gap of JAX's
    one-device bf16 step, and within twice the port's of the port's
    one-process bf16 step; the loss within 1e-2 of both."""
    rank = two[0]["s12_fused_bf16"]
    got = bridge.flatten(bridge.to_numpy(rank["params"]))
    jb, jbm = _jax_one_device(tuple(dict(FUSED, compute_dtype="bfloat16",
                                         pallas_interpret=True).items()))
    jf, _ = _jax_one_device(tuple(dict(FUSED, pallas_interpret=True).items()))
    _within_gap(got, *(bridge.flatten(jax.tree.map(np.asarray, t.params)) for t in (jb, jf)),
                "params vs JAX")
    ts, tm = _one_process("s12_fused_bf16", "2")
    fs, _ = _one_process("s12_fused", "2")
    _within_gap(got, *(bridge.flatten(bridge.to_numpy(t.params)) for t in (ts, fs)),
                "params vs one process")
    for want in (float(jbm["loss"]), tm["loss"].item()):
        np.testing.assert_allclose(rank["metrics"]["loss"], want, rtol=1e-2)


def _whole_site(op):
    """A fused site (K8's plain version ``fused_conv_reference``, fp32) or
    the s2d stem (the 7x7/s2 conv it folds, float64) on the whole image:
    (y, dx, dW, and for a site its sums, dscale and dshift) against the
    ranks' seeded cotangents."""
    from resnet_tpu_torch.kernels.fused_conv import fused_conv_reference
    from resnet_tpu_torch.tools.distributed_worker import spatial_op_inputs

    x, weight, scale, shift, gen = spatial_op_inputs(op)
    site = op["op"] == "fused"
    s = op.get("s", 1 if site else 2)
    leaves_ = [t if site else t.double() for t in (x, weight, scale, shift)]
    for t in leaves_:
        t.requires_grad_(True)
    x, weight, scale, shift = leaves_
    if site:
        y, sums = fused_conv_reference(x, weight, scale, shift, s, None,
                                       op.get("prologue", True), True, None)
    else:
        y, sums = plain_conv2d(x, weight, stride=s), None
    loss = (y * torch.randn(*y.shape, generator=gen).to(y.dtype)).sum()
    if site:
        loss = loss + (sums * torch.randn(sums.shape, generator=gen)).sum()
    loss.backward()
    rest = dict(sums=sums.detach(), dscale=scale.grad, dshift=shift.grad) if site else {}
    return y.detach(), x.grad, weight.grad, rest


def _whole_op(op):
    """The plain op on the whole image (float64), its input and weight
    gradients against the seeded cotangent the ranks use."""
    from resnet_tpu_torch.ops import global_avg_pool, max_pool
    from resnet_tpu_torch.tools.distributed_worker import spatial_op_inputs

    if op["op"] in ("fused", "s2d"):
        return _whole_site(op)
    x, weight, _, _, gen = spatial_op_inputs(op)
    x, weight = x.double().requires_grad_(True), weight.double().requires_grad_(True)
    k, s = op.get("k", 1), op.get("s", 1)
    if op["op"] == "conv":
        y = plain_conv2d(x, weight, stride=s)
    elif op["op"] == "max_pool":
        y = max_pool(x, kernel=k, stride=s)
    else:
        y = global_avg_pool(x)
    g = (torch.randn(op["n"], y.shape[-1], generator=gen) if op["op"] == "avg"
         else torch.randn(*y.shape, generator=gen)).double()
    (y * g).sum().backward()
    return y.detach(), x.grad, weight.grad if op["op"] == "conv" else None


def _check_ops(ranks, ops):
    for i, op in enumerate(ops):
        y, dx, dw, *rest = _whole_op(op)
        recs = [r["ops"][i] for r in ranks]
        # a fused site: its sums over each rank's own rows add up to the
        # image's, and so do the prologue rows' gradients
        for key, want in (rest[0] if rest else {}).items():
            got = sum(r[key].double() for r in recs)
            np.testing.assert_allclose(got, want.double(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()), err_msg=f"{key} {op}")
        if op["op"] == "avg":
            for r in recs:
                np.testing.assert_allclose(r["y"], y, rtol=0, atol=1e-6, err_msg=str(op))
        else:
            got = torch.cat([r["y"] for r in recs], 1)
            np.testing.assert_allclose(got, y, rtol=0, atol=1e-5 * float(y.abs().max()),
                                       err_msg=f"forward {op}")
        got_dx = torch.cat([r["dx"] for r in recs], 1)
        np.testing.assert_allclose(got_dx, dx, rtol=0, atol=1e-5 * float(dx.abs().max()),
                                   err_msg=f"dx {op}")
        if dw is not None:
            got_dw = sum(r["dw"].double() for r in recs)
            np.testing.assert_allclose(got_dw, dw, rtol=0, atol=1e-5 * float(dw.abs().max()),
                                       err_msg=f"dw {op}")
        # no collective carries more than the halo's rows of an activation
        for r in recs:
            for kind, shape in r["collectives"]:
                if kind == "all_gather":
                    assert shape[1] <= 2 * (op.get("k", 1) // 2 + 1) and shape[1] < op["h"]


def test_partitioned_ops_on_two_ranks_match_the_whole_image(two):
    """Conv (3x3/s1, 3x3/s2 and 1x1/s2 on 7 + 7 rows, the stem's 7x7/s2,
    K1's plain version with the tiles' padding, NCHW), the max pool, the
    global average pool on 4 + 3 rows, K8's plain version under the
    prologue on a 3x3 seam of 4 + 3 rows (act(shift) > 0: a halo row that
    is not the neighbour's raw row shows), the chain at 3x3/s2 on 7 + 7
    rows, and the s2d stem on rows [0, 3), [3, 8) (the fold takes one row
    from below): the ranks' outputs, input gradients (halo cotangents
    returned to their owner) and summed weight gradients (and a site's
    sums, dscale and dshift) equal the plain op on the whole image."""
    _check_ops(two, OPS_2)


def test_partitioned_ops_on_four_ranks_match_the_whole_image(four):
    """The same on 4 ranks at uneven splits: 7 rows as 2, 2, 2, 1, 14 rows as
    4, 3, 4, 3 (odd first rows at stride 2), the stem on 56 rows, K8's
    plain version at 1x1/s2 under the prologue on tiles whose first row is
    odd (padding -1), and the chain at 3x3/s1 on 2, 2, 2, 1 rows."""
    _check_ops(four, OPS_4)


def test_no_collective_moves_a_whole_activation(four):
    """Every collective of the 1 x 4 step at input 56: each all-gather a
    rank's edge rows (at most 2 of a layer's height, which is its width),
    each sum a BN layer's sums, the pooled features, the statistics'
    cotangents, or the gradient bucket; none an activation."""
    rec = four[0]["s14_xla"]
    n, c_max = BATCH, 4 * tcfg.tiny_model_config().init_filters * 2
    gathers = [s for k, s in rec["collectives"] if k == "all_gather"]
    sums = [s for k, s in rec["collectives"] if k == "sum"]
    assert gathers and sums
    for shape in gathers:
        assert shape[1] <= 2 and 2 * shape[1] < shape[2], shape
    bucket = rec["param_elements"] + 2
    for shape in sums:
        numel = int(np.prod(shape))
        assert numel == bucket or numel <= n * c_max, shape


def _trainer_config(spatial_devices):
    model = dataclasses.asdict(tcfg.tiny_model_config())
    return {"model": model, "execution": XLA, "optimizer": SGD,
            "data": {"batch_size": BATCH, "synthetic": True},
            "parallel": {"spatial_devices": spatial_devices}, "log_every": 0}


def test_trainer_spatial_two_matches_one(two, tmp_path):
    """ParallelConfig(spatial_devices=2) through the Trainer (the grid, each
    rank's rows and height slice, the step, eval) against the Trainer
    without it on the same stream, in JAX's recipe
    (tests/test_parallel.py:249-300): train loss and eval loss rtol 1e-4,
    eval accuracy 1e-6."""
    from resnet_tpu_torch.tools.distributed_worker import train_config
    from resnet_tpu_torch.train import Trainer

    rec = two[0]["trainer"]
    cfg = dataclasses.replace(train_config(_trainer_config(1)), checkpoint_dir="")
    tr = Trainer(cfg, device="cpu", use_mesh=False)
    m = tr.run(2)
    ev = tr.evaluate(iter([_batch(16, 7)] * 2), 2)
    tr.finalize()
    np.testing.assert_allclose(rec["metrics"]["loss"], m["loss"], rtol=1e-4)
    np.testing.assert_allclose(rec["eval"]["loss"], ev["loss"], rtol=1e-4)
    np.testing.assert_allclose(rec["eval"]["accuracy"], ev["accuracy"], rtol=1e-6)
    assert two[1]["trainer"]["metrics"] == rec["metrics"]


def _eval_line(out: str, tag: str):
    """(loss, top1, top5) of the CLI's eval line."""
    line = next(l for l in out.splitlines() if l.startswith(f"{tag} over 2 batches"))
    return [float(part.split("=")[1]) for part in line.split(": ")[1].split()]


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_cli_spatial_evaluate_matches_one_process(int8, tmp_path, capsys):
    """``--evaluate --spatial-devices 2`` on two ranks under torchrun against
    one process: the float eval on each rank's height slice, the int8 eval
    on whole host batches on every rank (JAX's evaluate_quantized takes
    whole images; the int8 forward has no partition). Loss rtol 1e-4, top1
    and top5 equal."""
    from resnet_tpu_torch.train.cli import main

    from test_torch_parallel import REPO, _env, _free_port

    args = ["--model", "tiny", "--synthetic", "--batch-size", "8", "--evaluate",
            "--eval-batches", "2", "--device", "cpu", "--log-every", "0",
            "--checkpoint-dir", ""] + (["--int8"] if int8 else [])
    tag = "int8 eval" if int8 else "eval"
    main(args + ["--no-mesh"])
    want = _eval_line(capsys.readouterr().out, tag)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--rdzv-backend", "c10d",
           "--rdzv-endpoint", f"localhost:{_free_port()}",
           "-m", "resnet_tpu_torch.train.cli"] + args + ["--spatial-devices", "2"]
    done = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    got = _eval_line(done.stdout, tag)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert got[1:] == want[1:]


# ----------------------------------------------------------- the refusals


def _cfg(**kw):
    return tcfg.TrainConfig(
        model=tcfg.tiny_model_config(),
        execution=tcfg.ExecutionConfig(**kw.pop("execution", {})),
        data=tcfg.DataConfig(batch_size=kw.pop("batch", 8), synthetic=True),
        parallel=tcfg.ParallelConfig(**kw.pop("parallel", {})), checkpoint_dir="", **kw)


@pytest.mark.parametrize("kw,use_mesh,match", [
    (dict(parallel=dict(spatial_devices=2)), False, "mesh"),
    (dict(parallel=dict(spatial_devices=2, mode="shard_map")), True, "shard_map|auto"),
    (dict(parallel=dict(spatial_devices=2), execution=dict(grad_accum=2)), True,
     "grad_accum"),
    (dict(parallel=dict(spatial_devices=2, num_devices=8), batch=6), True, "batch_size"),
    (dict(parallel=dict(spatial_devices=3, num_devices=8)), True, "spatial_devices"),
    (dict(parallel=dict(spatial_devices=3, num_devices=6)), True, "input_dim"),
    (dict(parallel=dict(spatial_devices=2), execution=dict(kernels="blockfused")), True,
     "blockfused"),
])
def test_trainer_spatial_refusals_carry_jax_messages(kw, use_mesh, match):
    """JAX's refusals (resnet_tpu/train/trainer.py:65-138,
    tests/test_parallel.py:303-345, :492-539) with its messages, before any
    group is needed."""
    from resnet_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match=match):
        Trainer(_cfg(**kw), use_mesh=use_mesh, device="cpu")


def test_trainer_spatial_refuses_hosts_split_by_a_spatial_group(monkeypatch):
    """Several hosts where spatial does not divide a host's ranks: JAX's
    message (an H-shard group would straddle hosts)."""
    from resnet_tpu_torch.parallel import distributed
    from resnet_tpu_torch.train import Trainer

    monkeypatch.setattr(distributed, "host_count", lambda: 2)
    monkeypatch.setattr(distributed, "local_device_count", lambda: 3)
    with pytest.raises(ValueError, match="per-host device count"):
        Trainer(_cfg(parallel=dict(spatial_devices=2, num_devices=6), batch=6),
                use_mesh=True, device="cpu")


def test_spatial_step_refuses_shard_map_and_grad_accum():
    """make_train_step on a data x spatial grid: 'shard_map' and
    grad_accum > 1 raise with JAX's messages."""
    from resnet_tpu_torch.parallel.mesh import Mesh, Mesh2D

    grid = Mesh2D(Mesh(1, 0), Mesh(2, 0, "spatial"), 0, ("data", "spatial"), "spatial")
    with pytest.raises(ValueError, match="mode='auto'"):
        make_train_step(_cfg(parallel=dict(mode="shard_map")), grid)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(_cfg(execution=dict(grad_accum=2)), grid)


def same_as_jax(cfg, jc):
    """The port's TrainConfig equals JAX's field for field (the execution
    fields the port keeps)."""
    ours, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jc)
    ex = ours.pop("execution")
    assert ex == {k: theirs["execution"][k] for k in ex}
    theirs.pop("execution")
    assert ours == theirs


@pytest.mark.parametrize("execution", [dict(kernels="fused"), dict(kernels="hybrid"),
                                       dict(kernels="fusedxla"),
                                       dict(space_to_depth=True)])
def test_fused_engines_and_s2d_run_on_a_rank_s_rows(execution):
    """The fused engines and the s2d stem under spatial_devices=2: the
    config builds, equal to JAX's field for field, and one training forward
    inside a partition (rank 0 of two, the tiny model; its 7x7/s2 stem for
    s2d) gives finite logits and every BN layer's batch statistics."""
    from resnet_tpu_torch.models import forward

    cfg = _cfg(parallel=dict(spatial_devices=2), execution=execution)
    same_as_jax(cfg, jcfg.TrainConfig(
        model=jcfg.tiny_model_config(), execution=jcfg.ExecutionConfig(**execution),
        data=jcfg.DataConfig(batch_size=8, synthetic=True),
        parallel=jcfg.ParallelConfig(spatial_devices=2), checkpoint_dir=""))
    tc = _t_cfg(execution, S2D_MODEL if execution.get("space_to_depth") else None)
    state = init_train_state(tc, device="cpu")
    with spatial.partition(_FakeGroup()):
        logits, aux = forward(state.params, torch.randn(2, 8, 16, 3), tc.model, tc.execution,
                              bn_state=state.bn_state)
    assert logits.shape == (2, 8) and torch.isfinite(logits).all()
    stats = bridge.leaves(aux["bn_stats"])
    assert len(stats) == len(bridge.leaves(state.bn_state))
    assert all(torch.isfinite(t).all() for t in stats)


def test_blockfused_refused_on_a_rank_s_rows_with_jax_message():
    """kernels='blockfused' under spatial_devices > 1: JAX's ValueError and
    text, from the config and from the forward inside a partition (one
    owner, config.check_spatial); ZeRO with it keeps the Trainer's."""
    from resnet_tpu_torch.models import forward

    with pytest.raises(ValueError, match=r"kernels='blockfused' \(Pallas calls"):
        _cfg(parallel=dict(spatial_devices=2), execution=dict(kernels="blockfused"))
    cfg = _t_cfg(dict(kernels="blockfused"))
    state = init_train_state(cfg, device="cpu")
    with spatial.partition(_FakeGroup()), pytest.raises(ValueError, match="blockfused"):
        forward(state.params, torch.zeros(2, 8, 16, 3), cfg.model, cfg.execution,
                bn_state=state.bn_state)


class _FakeGroup:
    """A spatial group of two seen from rank 0, in one process: the
    neighbour's edges are this rank's own, sums the identity."""

    rank, size = 0, 2

    def all_gather(self, t):
        return [t, t.clone()]

    def sum_(self, t):
        pass


def test_partition_outside_a_grid_is_off():
    """A group of one (or none) partitions nothing: the ops run whole."""
    from resnet_tpu_torch.parallel.mesh import Mesh

    with spatial.partition(None) as part:
        assert part is None and spatial.active() is None
    with spatial.partition(Mesh(1, 0)) as part:
        assert part is None
