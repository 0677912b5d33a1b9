"""The whole-block kernel's module against the JAX package's.

``resnet_tpu_torch.kernels.block_fused`` on the CPU, where ``block_fused``
runs its plain version ``block_fused_reference``, against
``resnet_tpu.kernels.block_fused.block_fused(..., 'highest', True)`` (interpret
mode, which is the jnp mirror ``_block_fused_fwd_jnp`` and the hand-written
closed-form VJP). Inputs from a numpy seed as in tests/test_block_fused.py,
at (4, 8, 8, 32) with C = 8 and at (2, 8, 8, 256) with C = 64; out, r, s, e
and the three sums within 1e-4 of max|JAX| per tensor, with no cap, a cap of
10 and a cap of 2 that clips in both prologues and in the join; the
gradients of all ten inputs within 1e-4 of each one's max|JAX|, with a loss
on out alone and with the three sums in the loss too. The CUDA kernel is
held against this plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.kernels import block_fused as jbf
from resnet_tpu_torch.kernels import block_fused as tbf
from resnet_tpu_torch.kernels.fused_conv import bn_affine_from_sums

TOL = 1e-4
EPS = 1e-7
# (x shape (N, H, W, 4C), C)
SHAPES = [((4, 8, 8, 32), 8), ((2, 8, 8, 256), 64)]
SHAPE_IDS = ["C8", "C64"]


@pytest.fixture
def no_launch():
    """The CPU path must leave the launch counter at 0."""
    tbf.LAUNCHES = 0
    yield
    assert tbf.LAUNCHES == 0


def _make(seed, shape, c):
    """x, w1, w2, w3, g1, b1, g2, b2, g3, b3 as numpy arrays, as
    tests/test_block_fused.py::_make draws them (x a ReLU's output)."""
    rng = np.random.default_rng(seed)
    c4 = shape[-1]
    t = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    x = np.maximum(rng.normal(0, 1, shape), 0).astype(np.float32)
    return [x, t(c4, c), t(3, 3, c, c), t(c, c4),
            1 + 0.1 * t(c), 0.1 * t(c), 1 + 0.1 * t(c), 0.1 * t(c),
            1 + 0.1 * t(c4), 0.1 * t(c4)]


def close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _torch(args, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in args]


@pytest.mark.parametrize("cap", [None, 10.0, 2.0])
@pytest.mark.parametrize("shape,c", SHAPES, ids=SHAPE_IDS)
def test_block_fused_matches_jax(no_launch, shape, c, cap):
    args = _make(0, shape, c)
    want = jbf.block_fused(*map(jnp.asarray, args), EPS, cap, "highest", True)
    got = tbf.block_fused(*_torch(args), EPS, cap)
    for name, g, w in zip(("out", "sums_r", "sums_s", "sums_e"), got, want):
        close(g, w, name)
    if cap == 2.0:  # the cap really clips, in the join at least
        assert (got[0] == 2.0).any()


@pytest.mark.parametrize("cap", [None, 2.0])
@pytest.mark.parametrize("shape,c", SHAPES, ids=SHAPE_IDS)
def test_intermediates_and_rows_match_jax(no_launch, shape, c, cap):
    """r, s, e of the plain version against the JAX package's jnp mirror,
    and the six (scale, shift) rows it returns are the ones it applied:
    the affine of its own sums, and out rebuilt from e and the last pair."""
    args = _make(1, shape, c)
    _, jr, js, je, *_ = jbf._block_fused_fwd_jnp(*map(jnp.asarray, args), eps=EPS, cap=cap,
                                                 prec=jax.lax.Precision.HIGHEST)
    out, r, s, e, sums_r, sums_s, sums_e, rows = tbf.block_fused_forward(
        *_torch(args), EPS, cap)
    for name, g, w in (("r", r, jr), ("s", s, js), ("e", e, je)):
        close(g, w, name)
    m = shape[0] * shape[1] * shape[2]
    g1, b1, g2, b2, g3, b3 = _torch(args[4:])
    want_rows = (*bn_affine_from_sums(sums_r, g1, b1, m, EPS),
                 *bn_affine_from_sums(sums_s, g2, b2, m, EPS),
                 *bn_affine_from_sums(sums_e, g3, b3, m, EPS))
    for got_row, want_row in zip(rows, want_rows, strict=True):
        assert torch.equal(got_row, want_row)
    rebuilt = torch.clamp_min(e * rows[4] + rows[5] + _torch(args[:1])[0], 0.0)
    if cap is not None:
        rebuilt = torch.clamp_max(rebuilt, cap)
    assert torch.equal(out, rebuilt)


# (shape index, cap, the sums in the loss)
GRAD_CASES = [(0, None, False), (0, 2.0, True), (1, None, True), (1, 10.0, False)]


@pytest.mark.parametrize("which,cap,with_sums", GRAD_CASES,
                         ids=[f"{SHAPE_IDS[i]}-cap{cap}-{'sums' if s else 'out'}"
                              for i, cap, s in GRAD_CASES])
def test_block_fused_grads_match_jax(no_launch, which, cap, with_sums):
    """The gradients of all ten inputs against jax.grad through the JAX
    package's custom VJP, at one numpy cotangent per output; with the sums
    in the loss the backward folds their cotangents into the BN backward."""
    shape, c = SHAPES[which]
    args = _make(2, shape, c)
    n_out = 4 if with_sums else 1
    outs = jbf.block_fused(*map(jnp.asarray, args), EPS, cap, "highest", True)
    rng = np.random.default_rng(3)
    cts = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs[:n_out]]

    def loss(*a):
        o = jbf.block_fused(*a, EPS, cap, "highest", True)
        return sum(jnp.vdot(oo, jnp.asarray(ct)) for oo, ct in zip(o, cts))

    want = jax.grad(loss, argnums=tuple(range(10)))(*map(jnp.asarray, args))
    xs = _torch(args, grad=True)
    got = torch.autograd.grad(tbf.block_fused(*xs, EPS, cap)[:n_out], xs,
                              [torch.from_numpy(ct) for ct in cts])
    names = ("dx", "dw1", "dw2", "dw3", "dg1", "db1", "dg2", "db2", "dg3", "db3")
    for name, g, w in zip(names, got, want, strict=True):
        close(g, w, name)


def test_sums_alone_are_differentiable(no_launch):
    """A loss on the sums only (no cotangent reaches out) still gives every
    input its gradient, as jax.grad does."""
    shape, c = SHAPES[0]
    args = _make(4, shape, c)

    def jloss(*a):
        _, sr, ss, se = jbf.block_fused(*a, EPS, None, "highest", True)
        return sr.sum() + ss[1].sum() + se[0].sum()

    want = jax.grad(jloss, argnums=tuple(range(10)))(*map(jnp.asarray, args))
    xs = _torch(args, grad=True)
    _, sr, ss, se = tbf.block_fused(*xs, EPS, None)
    got = torch.autograd.grad(sr.sum() + ss[1].sum() + se[0].sum(), xs)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        close(g, w, f"input {i}")


def _bad(device="cpu", **change):
    args = dict(zip(("x", "w1", "w2", "w3", "g1", "b1", "g2", "b2", "g3", "b3"),
                    (t.to(device) for t in _torch(_make(5, (1, 4, 4, 16), 4)))))
    args.update({k: v(args) for k, v in change.items()})
    return lambda: tbf.block_fused(*args.values(), EPS, None)


@pytest.mark.parametrize("call", [
    _bad(w1=lambda a: a["w1"][:8]),
    _bad(w2=lambda a: a["w2"][:1]),
    _bad(w3=lambda a: a["w3"].t().contiguous()),
    _bad(g3=lambda a: a["g1"]),
    _bad(x=lambda a: a["x"].double()),
    _bad(x=lambda a: a["x"].permute(0, 2, 1, 3)),
    _bad(x=lambda a: a["x"].to("meta")),
    _bad(device="meta"),
], ids=["w1-rows", "w2-taps", "w3-shape", "g3-width", "f64", "strided", "mixed-devices",
        "meta-device"])
def test_block_fused_rejects_what_the_kernel_does_not_take(no_launch, call):
    """Anything the CUDA kernel does not take raises; only a CPU tensor runs
    the plain version."""
    with pytest.raises((TypeError, ValueError)):
        call()


# --- K10's weight split: the K-major tf32 hi and lo of the wgmma core ---

def _rna_numpy(v):
    """tf32 of fp32 values, round to nearest with ties away from zero (PTX
    cvt.rna.tf32.f32), on the bits: keep the top 19, and add one unit of
    the kept last place to the magnitude where the 13 dropped bits are at
    least half of it."""
    bits = np.asarray(v, dtype=np.float32).view(np.uint32)
    kept = bits & np.uint32(0xFFFFE000)
    up = (bits & np.uint32(0x1FFF)) >= np.uint32(0x1000)
    return np.where(up, kept + np.uint32(0x2000), kept).astype(np.uint32).view(np.float32)


def test_tf32_rna_rounds_ties_away_from_zero():
    """The dropped 13 bits at exactly half (0x1000) round away from zero,
    where ties-to-even would keep an even last place; below half rounds
    down, above half up, a carry reaches the exponent (up to inf), and the
    plain version agrees with the numpy bit-level reference bit for bit."""
    one = 0x3F800000
    cases = {  # input bits -> tf32 bits
        one | 0x1000: one | 0x2000,            # 1 + 2^-11, a tie on an even place: away
        one | 0x3000: one | 0x4000,            # a tie on an odd place: away (and even)
        one | 0x0FFF: one,                     # just below half: down
        one | 0x1001: one | 0x2000,            # just above half: up
        0x80000000 | one | 0x1000: 0x80000000 | one | 0x2000,  # negative: away from 0
        0x3FFFF000: 0x40000000,                # 2 - 2^-11: the carry reaches the exponent
        0x7F7FFFFF: 0x7F800000,                # the largest float rounds to inf
        0x00001000: 0x00002000,                # a subnormal tie
        0: 0,
    }
    v = np.array(list(cases), dtype=np.uint32).view(np.float32)
    want = np.array(list(cases.values()), dtype=np.uint32)
    assert np.array_equal(_rna_numpy(v).view(np.uint32), want)
    got = tbf._tf32_rna(torch.from_numpy(v.copy())).numpy().view(np.uint32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k,n", [(256, 64), (576, 64), (64, 256), (81, 9), (9, 36), (37, 5)])
def test_split_tf32_reference_matches_numpy_bits(no_launch, k, n):
    """split_tf32 on the CPU (its plain version): (2, N, kp) with kp = K
    rounded up to a multiple of 4, [0] = rna(bᵀ), [1] = rna(bᵀ - [0]), zeros
    past K, bit for bit against the numpy reference on seeded weights with
    every eighth element an exact tie; and hi + lo recovers b within 2^-22
    of |b|."""
    rng = np.random.default_rng(k * 1000 + n)
    b = rng.normal(0, (2.0 / k) ** 0.5, (k, n)).astype(np.float32)
    flat = b.reshape(-1).view(np.uint32)
    flat[::8] = (flat[::8] & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    got = tbf.split_tf32(torch.from_numpy(b.copy())).numpy()
    kp = -(-k // 4) * 4
    assert got.shape == (2, n, kp)
    hi = _rna_numpy(b.T)
    lo = _rna_numpy(b.T - hi)
    assert np.array_equal(got[0, :, :k].view(np.uint32), hi.view(np.uint32))
    assert np.array_equal(got[1, :, :k].view(np.uint32), lo.view(np.uint32))
    assert not got[:, :, k:].any()
    # each a tf32 value, and the pair recovers b
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(got[0, :, :k].astype(np.float64) + got[1, :, :k] - b.T)
    assert (err <= 2.0 ** -22 * np.abs(b.T)).all()
    # the ties really rounded away from zero
    ties = b.reshape(-1)[::8]
    assert (np.abs(_rna_numpy(ties)) > np.abs(ties)).all()


def test_split_tf32_rejects_what_the_kernel_does_not_take(no_launch):
    tbf.SPLIT_LAUNCHES = 0
    for bad in (torch.zeros(3, 4, 5), torch.zeros(0, 4), torch.zeros(3, 4, dtype=torch.float64),
                torch.zeros(4, 3).t()):
        with pytest.raises((TypeError, ValueError)):
            tbf.split_tf32(bad)
    assert tbf.SPLIT_LAUNCHES == 0
