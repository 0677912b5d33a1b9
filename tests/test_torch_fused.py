"""The fused engine's kernel modules against the JAX package's.

``resnet_tpu_torch.kernels.fused_conv`` (K8 ``fused_conv``, K9
``fused_join``, ``conv_chain``, ``bn_affine_from_sums``), ``fused.bias_act``
(K5) and ``bn.batch_norm_act`` (K4 and K5 forward, K6 backward) on the CPU,
where each wrapper runs its plain version, against the JAX functions with
Pallas in interpret mode (``conv_chain_xla`` and ``bn_affine_from_sums``
are plain jnp there). Same numpy inputs; outputs and VJPs, at one numpy
cotangent per output, within 1e-4 of max|JAX| per tensor. The CUDA kernels
are held against these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu_torch.kernels import bn, fused, fused_conv

TOL = 1e-4
COUNTERS = [(fused_conv, "LAUNCHES"), (fused_conv, "JOIN_LAUNCHES"), (bn, "LAUNCHES"),
            (bn, "APPLY_LAUNCHES"), (bn, "BWD_LAUNCHES")]


@pytest.fixture
def no_launch():
    """Reset the counters; the CPU path must leave them at 0."""
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    yield
    assert [getattr(mod, name) for mod, name in COUNTERS] == [0] * len(COUNTERS)


def close(got, want, tol=TOL, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _cotangents(outs, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]


def _both(jfn, tfn, arrays, n_out):
    """(JAX outputs, JAX VJP, port outputs, port VJP) of two functions of the
    same numpy arrays, at the same cotangents on every output."""
    jouts, pull = jax.vjp(jfn, *map(jnp.asarray, arrays))
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    cts = _cotangents(jouts)
    jgrads = pull(tuple(map(jnp.asarray, cts)) if n_out > 1 else jnp.asarray(cts[0]))
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    touts = tfn(*xs)
    touts = touts if isinstance(touts, tuple) else (touts,)
    tgrads = torch.autograd.grad(touts, xs, [torch.from_numpy(c) for c in cts])
    return jouts, jgrads, touts, tgrads


def _rows(rng, c):
    return (rng.normal(1, 0.2, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))  # shift > 0 on about half


# tests/test_kernels.py TestPallasConv.CASES: (h, cin, cout, k, stride)
CONV_CASES = [(16, 3, 8, 7, 2), (8, 8, 16, 1, 1), (8, 16, 16, 3, 1), (8, 16, 16, 3, 2),
              (8, 8, 32, 3, 2)]
# (mode, cap): prologue with ReLU, no prologue ((1,) placeholder rows), and
# the capped prologue on the two 3x3 spatial shapes
FUSED_CONV_CASES = ([(c, "prologue", None) for c in CONV_CASES]
                    + [(c, "none", None) for c in CONV_CASES]
                    + [(c, "prologue", 1.0) for c in CONV_CASES[2:4]])


@pytest.mark.parametrize("shape,mode,cap", FUSED_CONV_CASES,
                         ids=[f"{'x'.join(map(str, c))}-{m}-cap{cap}"
                              for c, m, cap in FUSED_CONV_CASES])
def test_fused_conv_matches_pallas(rng, no_launch, shape, mode, cap):
    """y, sums and the VJP (dx, dW, dscale, dshift) with cotangents on both
    y and sums, against the Pallas fused conv in interpret mode."""
    from resnet_tpu.kernels.fused_conv import fused_conv as j_fused_conv

    h, cin, cout, k, s = shape
    pro = mode == "prologue"
    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    scale, shift = _rows(rng, cin) if pro else (np.ones(1, np.float32),
                                                np.zeros(1, np.float32))
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_fused_conv(*a, s, None, pro, pro, True, cap),
        lambda *a: fused_conv.fused_conv(*a, s, None, pro, pro, cap),
        [x, w, scale, shift], 2)
    for name, g, want in zip(("y", "sums"), touts, jouts):
        close(g, want, what=name)
    for name, g, want in zip(("dx", "dW", "dscale", "dshift"), tgrads, jgrads):
        if pro or name in ("dx", "dW"):
            close(g, want, what=name)
        else:  # the placeholders get a zero gradient, as in JAX
            assert g.shape == (1,) and not g.any() and not np.asarray(want).any()


@pytest.mark.parametrize("stride,cap", [(1, None), (2, 1.0)])
def test_conv_chain_matches_jax(rng, no_launch, stride, cap):
    """The fusedxla contract: (y, sums) and the closed-form VJP over the
    saved u against conv_chain_xla."""
    from resnet_tpu.kernels.fused_conv import conv_chain_xla

    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 12)) * 0.1).astype(np.float32)
    scale, shift = _rows(rng, 16)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: conv_chain_xla(*a, stride, True, True, cap, "highest"),
        lambda *a: fused_conv.conv_chain(*a, stride, True, True, cap),
        [x, w, scale, shift], 2)
    for g, want in zip(touts, jouts):
        close(g, want)
    for g, want in zip(tgrads, jgrads):
        close(g, want)


def test_fused_conv_and_conv_chain_take_explicit_padding(rng, no_launch):
    """An explicit, asymmetric padding: the same windows as lax's conv, with
    the prologue's zero halo (the JAX package's direct kernel path)."""
    from resnet_tpu.kernels.fused_conv import fused_conv as j_fused_conv

    x = rng.normal(size=(2, 7, 7, 5)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 5, 6)) * 0.1).astype(np.float32)
    scale, shift = _rows(rng, 5)
    pad = ((2, 0), (1, 1))
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_fused_conv(*a, 1, pad, True, True, True, None),
        lambda *a: fused_conv.fused_conv(*a, 1, pad, True, True, None),
        [x, w, scale, shift], 2)
    assert touts[0].shape == (2, 7, 7, 6)
    for g, want in zip((*touts, *tgrads), (*jouts, *jgrads)):
        close(g, want)


@pytest.mark.parametrize("stride", [1, 2])
def test_prologue_keeps_the_padding_at_zero(no_launch, stride):
    """With scale 0 and shift 1 the prologue makes every in-image element 1,
    so an all-ones 3x3 filter counts the in-image taps of each window: 9 in
    the interior, 6 on an edge, 4 in a corner (times Cin). relu(shift) in the
    padding would make every count 9."""
    from resnet_tpu.kernels.fused_conv import fused_conv as j_fused_conv

    cin = 3
    x = np.random.default_rng(0).normal(size=(1, 6, 6, cin)).astype(np.float32)
    w = np.ones((3, 3, cin, 1), np.float32)
    scale, shift = np.zeros(cin, np.float32), np.ones(cin, np.float32)
    y, sums = fused_conv.fused_conv(*map(torch.from_numpy, (x, w, scale, shift)), stride)
    taps = np.array([2, 3, 3, 3, 3, 2], np.float32)  # in-image rows per window row
    # at stride 2 the windows are those centred on rows 0, 2 and 4
    want = np.outer(taps, taps)[::stride, ::stride] * cin
    np.testing.assert_array_equal(y[0, :, :, 0].numpy(), want)
    np.testing.assert_allclose(sums[:, 0].numpy(), [want.sum(), (want ** 2).sum()])
    jy, _ = j_fused_conv(*map(jnp.asarray, (x, w, scale, shift)), stride, None, True,
                         True, True, None)
    np.testing.assert_array_equal(np.asarray(jy)[0, :, :, 0], want)


@pytest.mark.parametrize("shape,cap", [((2, 4, 4, 16), None), ((3, 7, 7, 9), 0.5)])
def test_fused_join_matches_pallas(rng, no_launch, shape, cap):
    """K9's plain version and its VJP (six gradients) against the Pallas
    join in interpret mode; the cap 0.5 clips about a third of the values."""
    from resnet_tpu.kernels.fused_conv import fused_join as j_fused_join

    c = shape[-1]
    e = rng.normal(size=shape).astype(np.float32)
    r = rng.normal(size=shape).astype(np.float32)
    se, te = _rows(rng, c)
    sr, tr = _rows(rng, c)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_fused_join(*a, True, cap),
        lambda *a: fused_conv.fused_join(*a, cap),
        [e, se, te, r, sr, tr], 1)
    close(touts[0], jouts[0])
    for name, g, want in zip(("de", "dse", "dte", "dr", "dsr", "dtr"), tgrads, jgrads):
        close(g, want, what=name)


@pytest.mark.parametrize("relu,cap", [(True, None), (False, None), (True, 1.0)])
def test_bias_act_matches_pallas(rng, no_launch, relu, cap):
    """K5 through bias_act: forward and the torch-ops backward against the
    JAX bias_act (the BN apply kernel in interpret mode)."""
    from resnet_tpu.kernels.fused import bias_act as j_bias_act

    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    scale, shift = _rows(rng, 16)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_bias_act(*a, relu, True, cap),
        lambda *a: fused.bias_act(*a, relu, cap), [x, scale, shift], 1)
    close(touts[0], jouts[0])
    for g, want in zip(tgrads, jgrads):
        close(g, want)


@pytest.mark.parametrize("relu", [True, False])
def test_batch_norm_act_matches_pallas(rng, no_launch, relu):
    """The batch_norm_act entry point: (y, mean, var) forward (K4, K5) and
    the K6 backward's (dx, dgamma, dbeta) against the Pallas kernels in
    interpret mode; the plain torch ops of bn_act_reference agree too."""
    from resnet_tpu.kernels.bn import batch_norm_act as j_bna
    from resnet_tpu.kernels.bn import bn_act_reference as j_ref

    m, c = 1000, 33
    x = (rng.normal(2.0, 3.0, size=(m, c))).astype(np.float32)
    gamma, beta = _rows(rng, c)
    dy = np.random.default_rng(9).normal(size=(m, c)).astype(np.float32)
    (y, mean, var), pull = jax.vjp(lambda *a: j_bna(*a, 1e-7, relu, True),
                                   *map(jnp.asarray, (x, gamma, beta)))
    jgrads = pull((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))
    xs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, gamma, beta)]
    ty, tmean, tvar = bn.batch_norm_act(*xs, 1e-7, relu)
    assert not tmean.requires_grad and not tvar.requires_grad
    tgrads = torch.autograd.grad(ty, xs, torch.from_numpy(dy))
    for name, g, want in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                             (ty, tmean, tvar, *tgrads), (y, mean, var, *jgrads)):
        close(g, want, what=name)
    ry, rmean, rvar = bn.bn_act_reference(*map(torch.from_numpy, (x, gamma, beta)),
                                          1e-7, relu)
    for g, want in zip((ry, rmean, rvar), j_ref(*map(jnp.asarray, (x, gamma, beta)),
                                                1e-7, relu)):
        close(g, want)


# (M, C, storage offset): ragged channels, M below one K6 row chunk, and a
# view one element off a 16-byte boundary (K6's one-value path)
ODD_BN_SHAPES = [(200, 9, 0), (50, 64, 0), (64, 16, 1)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,c,offset", ODD_BN_SHAPES, ids=["C9", "below-a-chunk", "offset"])
def test_batch_norm_act_odd_shapes_match_pallas(rng, no_launch, m, c, offset, relu):
    """batch_norm_act's forward and K6 backward, and the backward's plain
    version ``bn_bwd_reference`` called alone at the saved statistics,
    against the Pallas kernels in interpret mode at the shapes that take
    K6's one-value lanes and single chunk on the card."""
    from resnet_tpu.kernels.bn import batch_norm_act as j_bna

    x = (rng.normal(2.0, 3.0, size=(m, c))).astype(np.float32)
    gamma, beta = _rows(rng, c)
    dy = np.random.default_rng(9).normal(size=(m, c)).astype(np.float32)
    (y, mean, var), pull = jax.vjp(lambda *a: j_bna(*a, 1e-7, relu, True),
                                   *map(jnp.asarray, (x, gamma, beta)))
    jgrads = pull((jnp.asarray(dy), jnp.zeros(c), jnp.zeros(c)))
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), x.ravel()]))
    xs = [flat.requires_grad_(True), *(torch.from_numpy(a.copy()).requires_grad_(True)
                                       for a in (gamma, beta))]
    x2d = flat[offset:].view(m, c)
    assert x2d.is_contiguous() and x2d.storage_offset() == offset
    ty, tmean, tvar = bn.batch_norm_act(x2d, xs[1], xs[2], 1e-7, relu)
    dflat, dgamma, dbeta = torch.autograd.grad(ty, xs, torch.from_numpy(dy))
    for name, g, want in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                             (ty, tmean, tvar, dflat[offset:].view(m, c), dgamma, dbeta),
                             (y, mean, var, *jgrads)):
        close(g, want, what=name)
    plain = bn.bn_bwd_reference(x2d.detach(), torch.from_numpy(dy), tmean,
                                torch.rsqrt(tvar + 1e-7), *map(torch.from_numpy, (gamma, beta)),
                                relu=relu)
    for name, g, want in zip(("dx", "dgamma", "dbeta"), plain, jgrads):
        close(g, want, what=f"bn_bwd_reference {name}")


def test_bn_affine_from_sums_matches_jax(rng):
    """scale and shift from [Σy, Σy²] and their autograd VJP against jnp's."""
    from resnet_tpu.kernels.fused_conv import bn_affine_from_sums as j_affine

    y = rng.normal(1.0, 2.0, size=(50, 8)).astype(np.float32)
    sums = np.stack([y.sum(0), (y * y).sum(0)]).astype(np.float32)
    gamma, beta = _rows(rng, 8)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_affine(*a, 50, 1e-7),
        lambda *a: fused_conv.bn_affine_from_sums(*a, 50, 1e-7), [sums, gamma, beta], 2)
    for g, want in zip((*touts, *tgrads), (*jouts, *jgrads)):
        close(g, want)


@pytest.mark.parametrize("call", [
    lambda: fused_conv.fused_conv(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 2),
                                  torch.ones(1), torch.zeros(1)),
    lambda: fused_conv.fused_conv(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 4, 2),
                                  torch.ones(3), torch.zeros(3)),
    lambda: fused_conv.fused_conv(torch.zeros(1, 4, 4, 3, dtype=torch.float64),
                                  torch.zeros(1, 1, 3, 2, dtype=torch.float64),
                                  torch.ones(3), torch.zeros(3)),
    lambda: fused_conv.fused_join(torch.zeros(2, 3), torch.ones(3), torch.zeros(3),
                                  torch.zeros(2, 4), torch.ones(4), torch.zeros(4)),
    lambda: fused_conv.fused_join(torch.zeros(2, 3), torch.ones(2), torch.zeros(3),
                                  torch.zeros(2, 3), torch.ones(3), torch.zeros(3)),
    lambda: bn.bn_apply(torch.zeros(4, 3), torch.ones(4), torch.zeros(4), relu=True),
    lambda: bn.bn_apply(torch.zeros(4, 3).t(), torch.ones(4), torch.zeros(4), relu=True),
    lambda: bn.bn_bwd(torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(3), torch.ones(3),
                      torch.ones(3), torch.zeros(3), relu=True),
], ids=["prologue-placeholders", "cin", "f64", "join-shapes", "join-rows", "apply-rows",
        "apply-strided", "bwd-shapes"])
def test_wrappers_reject_what_the_kernels_do_not_take(no_launch, call):
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        call()
