"""The bf16 fused and whole-block engines against the JAX package on the CPU.

* Kernel modules: the plain versions the bf16 wrappers of K5
  (``fused.bias_act``), K6 (``bn.batch_norm_act``'s backward), K8
  (``fused_conv.fused_conv``), K9 (``fused_conv.fused_join``) and K10
  (``block_fused.block_fused``) run on CPU tensors, forward and VJP,
  against JAX's Pallas kernels in interpret mode (K10 through
  ``block_fused`` and its jnp mirror ``_block_fused_fwd_jnp``) on the same
  bf16 inputs, made with numpy from a seed: every bf16 element within one
  bf16 ulp of JAX's value plus 1e-5 of max|JAX| (an fp32 sum taken in
  another order may round to the neighbouring bf16 value), every fp32
  result (the statistics, the (scale, shift) rows, the gradients of fp32
  rows) within 1e-5 of max.
* The torch-ops chain (``conv_chain``) against ``conv_chain_xla`` in bf16.
* K8's statistics are its fp32 accumulator's, not the rounded y's: the
  plain K8's sums differ from ``channel_sums`` of its bf16 y and agree with
  an fp32 conv of the rounded inputs within 1e-6 of max.
* K10's VJP returns fp32 gradients for γ₁, β₁, γ₂ and β₂ in JAX whatever
  their dtype (block_fused.py:511-516); the autograd engine casts a
  Function's gradient to its input's dtype, so with bf16 parameters those
  four leaves are held to JAX's value rounded to bf16.
* The tiny model's training step under 'fused', 'hybrid', 'fusedxla' and
  'blockfused' with bf16 compute, with fp32 and with bf16 parameters: the
  summed loss, logits, batch statistics and every gradient leaf within 2x
  JAX's own gap between its bf16 and fp32 runs plus 1e-5 of max
  (tests/test_torch_nchw.py's rule: the gap pooled over the forward's
  results and over the gradient tree). 'blockfused' runs a model whose
  identity blocks JAX sends to its kernel too (4C a multiple of 128), so
  both compute the same function.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.kernels import block_fused as tbf
from resnet_tpu_torch.kernels import bn, fused, fused_conv

REL = 1e-5  # beside one bf16 ulp per element
FLOOR = 1e-5  # beside 2x the bf16-vs-fp32 gap
EPS = 1e-7
BF = torch.bfloat16
COUNTERS = [(fused_conv, "LAUNCHES_BF16"), (fused_conv, "JOIN_LAUNCHES_BF16"),
            (bn, "APPLY_LAUNCHES_BF16"), (bn, "BWD_LAUNCHES_BF16"), (bn, "LAUNCHES_BF16"),
            (tbf, "LAUNCHES_BF16")]


@pytest.fixture
def no_launch():
    """Reset the bf16 counters; the CPU path must leave them at 0."""
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    yield
    assert [getattr(mod, name) for mod, name in COUNTERS] == [0] * len(COUNTERS)


def _ulp(w):
    """One bf16 ulp of each |w| (0 at 0)."""
    _, e = np.frexp(np.abs(w))
    return np.where(w != 0, np.ldexp(1.0, e - 8), 0.0)


def _np(a):
    """A JAX array or torch tensor as float64 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def close(got, want, what=""):
    """got (torch) within one bf16 ulp of want (JAX) plus 1e-5 of max|want|
    where got is bf16, within 1e-5 of max|want| where it is fp32; the dtypes
    must agree."""
    want_dtype = {jnp.dtype(jnp.bfloat16): BF, jnp.dtype(jnp.float32): torch.float32}[
        jnp.asarray(want).dtype]
    assert got.dtype == want_dtype, (what, got.dtype, want_dtype)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    slack = (_ulp(w) if got.dtype is BF else 0.0) + REL * np.abs(w).max()
    over = np.abs(g - w) - slack
    assert np.all(over <= 0), f"{what}: worst {float(over.max())} beyond the limit"


def _bf(a):
    """numpy fp32 values rounded to bf16."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _both(jfn, tfn, arrays, dtypes, n_out, seed=7):
    """(JAX outputs, JAX VJP, port outputs, port VJP) of two functions of the
    same numpy arrays, each given in its dtype ('bf16' or 'f32'), at the same
    cotangents (in each output's dtype) on every output."""
    jd = {"bf16": jnp.bfloat16, "f32": jnp.float32}
    td = {"bf16": BF, "f32": torch.float32}
    jx = [jnp.asarray(a, jd[d]) for a, d in zip(arrays, dtypes)]
    jouts, pull = jax.vjp(jfn, *jx)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    rng = np.random.default_rng(seed)
    cts = [_bf(rng.normal(size=o.shape)) if o.dtype == jnp.bfloat16
           else rng.normal(size=o.shape).astype(np.float32) for o in jouts]
    jcts = tuple(jnp.asarray(c, o.dtype) for c, o in zip(cts, jouts))
    jgrads = pull(jcts if n_out > 1 else jcts[0])
    xs = [torch.from_numpy(np.asarray(a, np.float32)).to(td[d]).requires_grad_(True)
          for a, d in zip(arrays, dtypes)]
    touts = tfn(*xs)
    touts = touts if isinstance(touts, tuple) else (touts,)
    tcts = [torch.from_numpy(c).to(t.dtype) for c, t in zip(cts, touts)]
    tgrads = torch.autograd.grad(touts, xs, tcts)
    return jouts, jgrads, touts, tgrads


def _rows(rng, c):
    return (rng.normal(1, 0.2, c).astype(np.float32),
            rng.normal(0, 0.5, c).astype(np.float32))  # shift > 0 on about half


# ------------------------------------------------------------------ K5, K6


@pytest.mark.parametrize("relu,cap", [(True, None), (False, None), (True, 1.0)])
def test_bias_act_bf16_matches_pallas(rng, no_launch, relu, cap):
    """K5 through bias_act on bf16 x with fp32 rows: y and the VJP (dx bf16,
    dscale and dshift fp32) against JAX's bias_act in interpret mode."""
    from resnet_tpu.kernels.fused import bias_act as j_bias_act

    x = rng.normal(size=(2, 4, 4, 16))
    scale, shift = _rows(rng, 16)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_bias_act(*a, relu, True, cap), lambda *a: fused.bias_act(*a, relu, cap),
        [x, scale, shift], ["bf16", "f32", "f32"], 1)
    close(touts[0], jouts[0], "y")
    for name, g, want in zip(("dx", "dscale", "dshift"), tgrads, jgrads):
        close(g, want, name)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("param", ["f32", "bf16"])
def test_batch_norm_act_bf16_matches_pallas(rng, no_launch, relu, param):
    """batch_norm_act on bf16 rows, γ and β fp32 or bf16 (a bf16 parameter):
    y (bf16), mean and var (fp32) forward (K4, K5); dx (bf16) and dγ, dβ in
    γ's dtype from the K6 backward, against the Pallas kernels in interpret
    mode."""
    from resnet_tpu.kernels.bn import batch_norm_act as j_bna

    m, c = 1000, 33
    x = rng.normal(2.0, 3.0, size=(m, c))
    gamma, beta = _rows(rng, c)
    jd = {"bf16": jnp.bfloat16, "f32": jnp.float32}[param]
    td = {"bf16": BF, "f32": torch.float32}[param]
    dy = _bf(np.random.default_rng(9).normal(size=(m, c)))
    jx = jnp.asarray(x, jnp.bfloat16)
    (y, mean, var), pull = jax.vjp(lambda *a: j_bna(*a, EPS, relu, True), jx,
                                   jnp.asarray(gamma, jd), jnp.asarray(beta, jd))
    jgrads = pull((jnp.asarray(dy, jnp.bfloat16), jnp.zeros(c), jnp.zeros(c)))
    xs = [torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(BF).requires_grad_(True),
          torch.from_numpy(gamma).to(td).requires_grad_(True),
          torch.from_numpy(beta).to(td).requires_grad_(True)]
    ty, tmean, tvar = bn.batch_norm_act(*xs, EPS, relu)
    tgrads = torch.autograd.grad(ty, xs, torch.from_numpy(dy).to(BF))
    for name, g, want in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                             (ty, tmean, tvar, *tgrads), (y, mean, var, *jgrads)):
        close(g, want, name)


# (M, C, storage offset): ragged channels, M below one K6 row chunk, and a
# view one element off a 16-byte boundary (K6's one-value path)
ODD_BN_SHAPES = [(200, 9, 0), (50, 64, 0), (64, 16, 1)]


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,c,offset", ODD_BN_SHAPES, ids=["C9", "below-a-chunk", "offset"])
def test_batch_norm_act_bf16_odd_shapes_match_pallas(rng, no_launch, m, c, offset, relu):
    """batch_norm_act on bf16 rows with fp32 γ and β, and the backward's
    plain version ``bn_bwd_reference`` called alone at the saved statistics,
    against the Pallas kernels in interpret mode at the shapes that take
    K6's one-value lanes and single chunk on the card."""
    from resnet_tpu.kernels.bn import batch_norm_act as j_bna

    x = rng.normal(2.0, 3.0, size=(m, c))
    gamma, beta = _rows(rng, c)
    dy = _bf(np.random.default_rng(9).normal(size=(m, c)))
    jx = jnp.asarray(x, jnp.bfloat16)
    (y, mean, var), pull = jax.vjp(lambda *a: j_bna(*a, EPS, relu, True), jx,
                                   jnp.asarray(gamma), jnp.asarray(beta))
    jgrads = pull((jnp.asarray(dy, jnp.bfloat16), jnp.zeros(c), jnp.zeros(c)))
    xb = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(BF).reshape(-1)
    flat = torch.cat([torch.zeros(offset, dtype=BF), xb]).requires_grad_(True)
    xs = [flat, torch.from_numpy(gamma).requires_grad_(True),
          torch.from_numpy(beta).requires_grad_(True)]
    x2d = flat[offset:].view(m, c)
    assert x2d.is_contiguous() and x2d.storage_offset() == offset
    ty, tmean, tvar = bn.batch_norm_act(x2d, xs[1], xs[2], EPS, relu)
    dflat, dgamma, dbeta = torch.autograd.grad(ty, xs, torch.from_numpy(dy).to(BF))
    for name, g, want in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"),
                             (ty, tmean, tvar, dflat[offset:].view(m, c), dgamma, dbeta),
                             (y, mean, var, *jgrads)):
        close(g, want, name)
    plain = bn.bn_bwd_reference(x2d.detach(), torch.from_numpy(dy).to(BF), tmean,
                                torch.rsqrt(tvar + EPS), *map(torch.from_numpy, (gamma, beta)),
                                relu=relu)
    for name, g, want in zip(("dx", "dgamma", "dbeta"), plain, jgrads):
        close(g, want, f"bn_bwd_reference {name}")


# ---------------------------------------------------------------------- K8


# (H=W, Cin, Cout, k, stride, prologue, cap): k 1 and 3, stride 1 and 2, the
# prologue on and off, with and without the cap
FUSED_CONV_CASES = [
    (8, 16, 16, 3, 1, True, None), (8, 16, 16, 3, 2, True, None),
    (8, 8, 32, 1, 1, True, None), (8, 8, 32, 1, 2, False, None),
    (8, 16, 16, 3, 1, False, None), (8, 16, 16, 3, 1, True, 1.0),
    (8, 8, 16, 3, 2, True, 1.0),
]


@pytest.mark.parametrize("h,cin,cout,k,s,pro,cap", FUSED_CONV_CASES,
                         ids=[f"{k}x{k}s{s}-{'pro' if p else 'none'}-cap{c}"
                              for _, _, _, k, s, p, c in FUSED_CONV_CASES])
@pytest.mark.parametrize("param", ["bf16", "f32"])
def test_fused_conv_bf16_matches_pallas(rng, no_launch, h, cin, cout, k, s, pro, cap, param):
    """K8 on bf16 x, w bf16 or fp32 (cast to x's dtype in both packages):
    y (bf16) and sums (fp32) against the Pallas fused conv in interpret mode,
    and the VJP with cotangents on both: dx (bf16), dW (w's dtype), dscale
    and dshift (fp32)."""
    from resnet_tpu.kernels.fused_conv import fused_conv as j_fused_conv

    x = rng.normal(size=(2, h, h, cin))
    w = rng.normal(size=(k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5
    scale, shift = _rows(rng, cin) if pro else (np.ones(1, np.float32),
                                                np.zeros(1, np.float32))
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_fused_conv(*a, s, None, pro, pro, True, cap),
        lambda *a: fused_conv.fused_conv(*a, s, None, pro, pro, cap),
        [x, w, scale, shift], ["bf16", param, "f32", "f32"], 2)
    close(touts[0], jouts[0], "y")
    close(touts[1], jouts[1], "sums")
    close(tgrads[0], jgrads[0], "dx")
    close(tgrads[1], jgrads[1], "dW")
    if pro:
        close(tgrads[2], jgrads[2], "dscale")
        close(tgrads[3], jgrads[3], "dshift")
    else:  # the placeholders get a zero gradient, as in JAX
        assert not tgrads[2].any() and not np.asarray(jgrads[2]).any()


def test_fused_conv_bf16_sums_are_the_accumulators(rng, no_launch):
    """K8's [Σy, Σy²] come from the fp32 accumulator (fused_conv.py:109-110):
    they agree with an fp32 conv (JAX's, at 'highest') of the rounded u and
    w within 1e-6 of max, and differ from the sums of the rounded y, the
    chain's, by far more. A plain K8 that took its sums from the rounded y
    fails here."""
    from jax import lax

    x = _bf(rng.normal(size=(4, 8, 8, 16)))
    w = _bf(rng.normal(size=(3, 3, 16, 32)) * 0.1)
    scale, shift = _rows(rng, 16)
    args = [torch.from_numpy(x).to(BF), torch.from_numpy(w).to(BF),
            torch.from_numpy(scale), torch.from_numpy(shift)]
    y, sums = fused_conv.fused_conv(*args, 1)
    assert y.dtype is BF and sums.dtype is torch.float32
    u = _bf(np.maximum(x * scale + shift, 0.0))  # the prologue, rounded
    yf = lax.conv_general_dilated(jnp.asarray(u), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                  precision=lax.Precision.HIGHEST)
    want = np.stack([np.asarray(yf).sum((0, 1, 2)), (np.asarray(yf) ** 2).sum((0, 1, 2))])
    err = np.abs(_np(sums) - want).max(axis=1) / np.abs(want).max(axis=1)
    assert (err <= 1e-6).all(), err
    rounded = _np(fused_conv.channel_sums(y))
    apart = np.abs(rounded - want).max(axis=1) / np.abs(want).max(axis=1)
    assert (apart > 1e-5).all(), apart


@pytest.mark.parametrize("stride,cap", [(1, None), (2, 1.0)])
def test_conv_chain_bf16_matches_jax(rng, no_launch, stride, cap):
    """The fusedxla contract in bf16: u rounded to bf16, the conv in bf16,
    the sums of the rounded y, and the closed-form VJP over the saved u,
    against conv_chain_xla."""
    from resnet_tpu.kernels.fused_conv import conv_chain_xla

    x = rng.normal(size=(2, 8, 8, 16))
    w = rng.normal(size=(3, 3, 16, 12)) * 0.1
    scale, shift = _rows(rng, 16)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: conv_chain_xla(*a, stride, True, True, cap, "highest"),
        lambda *a: fused_conv.conv_chain(*a, stride, True, True, cap),
        [x, w, scale, shift], ["bf16", "bf16", "f32", "f32"], 2)
    for name, g, want in zip(("y", "sums"), touts, jouts):
        close(g, want, name)
    for name, g, want in zip(("dx", "dW", "dscale", "dshift"), tgrads, jgrads):
        close(g, want, name)


# ---------------------------------------------------------------------- K9


@pytest.mark.parametrize("shape,cap", [((2, 4, 4, 16), None), ((3, 7, 7, 9), 0.5)])
def test_fused_join_bf16_matches_pallas(rng, no_launch, shape, cap):
    """K9 on bf16 e and r with fp32 rows, and its VJP (de, dr bf16; the four
    rows' gradients fp32) against the Pallas join in interpret mode."""
    from resnet_tpu.kernels.fused_conv import fused_join as j_fused_join

    c = shape[-1]
    e, r = rng.normal(size=shape), rng.normal(size=shape)
    se, te = _rows(rng, c)
    sr, tr = _rows(rng, c)
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: j_fused_join(*a, True, cap), lambda *a: fused_conv.fused_join(*a, cap),
        [e, se, te, r, sr, tr], ["bf16", "f32", "f32", "bf16", "f32", "f32"], 1)
    close(touts[0], jouts[0], "out")
    for name, g, want in zip(("de", "dse", "dte", "dr", "dsr", "dtr"), tgrads, jgrads):
        close(g, want, name)


# (label, shape, storage offset in elements, cap): the widths where K9's
# kernel parts its paths (C a multiple of 8 with C / 8 dividing its block or
# not, C not a multiple of 8, an odd element count, a start off a 16-byte
# boundary), the plain version's on the CPU
JOIN_WIDTHS = [("C=8", (2, 3, 3, 8), 0, None), ("C=9", (2, 3, 3, 9), 0, None),
               ("C=72", (2, 3, 3, 72), 0, 0.5), ("C=2048", (2, 2, 2, 2048), 0, None),
               ("odd count (1,3,5,9)", (1, 3, 5, 9), 0, None),
               ("storage offset 1", (2, 3, 3, 72), 1, None)]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("label,shape,offset,cap", JOIN_WIDTHS, ids=[w[0] for w in JOIN_WIDTHS])
def test_fused_join_widths_match_pallas(rng, no_launch, dtype, label, shape, offset, cap):
    """K9's plain version (the wrapper on CPU tensors) against the Pallas
    join in interpret mode at each width, e and r bf16 or fp32 (bf16: one
    ulp + 1e-5 of max; fp32: 1e-5 of max), the rows fp32."""
    from resnet_tpu.kernels.fused_conv import fused_join as j_fused_join

    c, numel = shape[-1], int(np.prod(shape))
    e, r = (rng.normal(size=numel + offset).astype(np.float32) for _ in range(2))
    if dtype == "bf16":
        e, r = _bf(e), _bf(r)
    se, te = _rows(rng, c)
    sr, tr = _rows(rng, c)
    td, jd = (BF, jnp.bfloat16) if dtype == "bf16" else (torch.float32, jnp.float32)
    te_, tr_ = (torch.from_numpy(a).to(td)[offset:].view(shape) for a in (e, r))
    assert te_.storage_offset() == offset and te_.is_contiguous()
    got = fused_conv.fused_join(te_, *map(torch.from_numpy, (se, te)), tr_,
                                *map(torch.from_numpy, (sr, tr)), cap)
    want = j_fused_join(jnp.asarray(e[offset:].reshape(shape), jd), se, te,
                        jnp.asarray(r[offset:].reshape(shape), jd), sr, tr, True, cap)
    close(got, want, label)


# --------------------------------------------------------------------- K10


def _block_args(rng, n, h, c, param):
    """x (a ReLU's output, bf16 values) and the weights and rows of a block
    of width C, each rounded to bf16 where ``param`` is 'bf16'."""
    c4 = 4 * c
    rnd = _bf if param == "bf16" else (lambda a: np.asarray(a, np.float32))
    x = _bf(np.maximum(rng.normal(size=(n, h, h, c4)), 0.0))
    ws = [rnd(rng.normal(size=s) * (2.0 / f) ** 0.5)
          for s, f in (((c4, c), c4), ((3, 3, c, c), 9 * c), ((c, c4), c))]
    rows = [rnd(t) for width in (c, c, c4) for t in _rows(rng, width)]
    return [x, *ws, *rows]


@pytest.mark.parametrize("cap", [None, 2.0])
def test_block_fused_bf16_forward_matches_the_jnp_mirror(rng, no_launch, cap):
    """K10's plain version on bf16 against _block_fused_fwd_jnp (the jnp
    mirror of the Pallas kernel, its rounding points exactly): out, r, s, e
    (bf16) and the three sums (fp32); and JAX's block_fused (interpret
    mode) returns the same out and sums."""
    from resnet_tpu.kernels.block_fused import _block_fused_fwd_jnp, block_fused

    args = _block_args(rng, 2, 6, 8, "bf16")
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want = _block_fused_fwd_jnp(*jargs, eps=EPS, cap=cap, prec=jax.lax.Precision.HIGHEST)
    got = tbf.block_fused_reference(*(torch.from_numpy(a).to(BF) for a in args), EPS, cap)
    for name, g, w in zip(("out", "r", "s", "e", "sums_r", "sums_s", "sums_e"), got, want):
        close(g, w, name)
    jout = block_fused(*jargs, EPS, cap, "highest", True)
    for name, g, w in zip(("out", "sums_r", "sums_s", "sums_e"),
                          tbf.block_fused(*(torch.from_numpy(a).to(BF) for a in args), EPS,
                                          cap), jout):
        close(g, w, name)


@pytest.mark.parametrize("param", ["bf16", "f32"])
def test_block_fused_bf16_vjp_matches_jax(rng, no_launch, param):
    """K10's closed-form backward on bf16 x with bf16 or fp32 parameters,
    cotangents on out and all three sums, against jax.vjp of block_fused:
    dx (bf16), the weights' gradients in their dtype, dγ₃ and dβ₃ in theirs.
    dγ₁, dβ₁, dγ₂ and dβ₂ leave JAX in fp32 whatever their dtype
    (block_fused.py:511-516); the autograd engine casts them to the
    parameter's, so with bf16 parameters they are held to JAX's value
    rounded to bf16, and that rounding's size (at most 2⁻⁹ of a value) is
    checked to be all that separates the two."""
    from resnet_tpu.kernels.block_fused import block_fused

    args = _block_args(rng, 2, 6, 8, param)
    dtypes = ["bf16"] + [param] * 9
    jouts, jgrads, touts, tgrads = _both(
        lambda *a: block_fused(*a, EPS, None, "highest", True),
        lambda *a: tbf.block_fused(*a, EPS, None), args, dtypes, 4)
    for name, g, w in zip(("out", "sums_r", "sums_s", "sums_e"), touts, jouts):
        close(g, w, name)
    names = ("dx", "dw1", "dw2", "dw3", "dg1", "db1", "dg2", "db2", "dg3", "db3")
    quirk = ("dg1", "db1", "dg2", "db2")
    for name, g, w in zip(names, tgrads, jgrads):
        if name in quirk:
            assert jnp.asarray(w).dtype == jnp.float32, name  # JAX's quirk
            if param == "bf16":
                rounded = jnp.asarray(w).astype(jnp.bfloat16)
                step = np.abs(_np(rounded) - _np(w)).max() / np.abs(_np(w)).max()
                assert step <= 2.0 ** -9, (name, step)
                w = rounded
        close(g, w, name)


# ------------------------------------------------------------- the model


def _perturbed(jm, seed):
    """JAX params with BN affines moved off (1, 0), rounded to bf16 values
    (so that fp32 and bf16 parameters hold the same numbers), and running
    statistics, as numpy trees."""
    from resnet_tpu.models import init_bn_state as j_init_bn_state
    from resnet_tpu.models import init_params as j_init_params

    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), jm))

    def move(path, a):
        if path[-1].key in ("gamma", "beta"):
            a = a + rng.normal(0, 0.1, a.shape)
        return _bf(a)

    return (jax.tree_util.tree_map_with_path(move, params),
            jax.tree.map(np.asarray, j_init_bn_state(jm)))


ENGINES = {"fused": {}, "hybrid": {}, "fusedxla": {},
           # identity blocks of 4C = 128 and 256, which JAX routes to its kernel
           "blockfused": dict(init_filters=32, block_sizes=(2, 2))}


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's summed loss, logits, batch statistics and gradients of the tiny
    model under each engine, per (engine, compute dtype, param dtype), from
    one jitted function per configuration, computed once for the module."""
    from resnet_tpu.train.step import _loss_fn

    cache = {}

    def run(engine, compute, param):
        key = (engine, compute, param)
        if key not in cache:
            jm = jcfg.tiny_model_config(**ENGINES[engine])
            params, state = _perturbed(jm, 3)
            params = jax.tree.map(lambda a: jnp.asarray(a, param), params)
            rng = np.random.default_rng(3)
            batch = {"images": rng.normal(0, 50, (4, 16, 16, 3)).astype(np.float32),
                     "labels": rng.integers(0, 8, 4).astype(np.int32)}
            cfg = jcfg.TrainConfig(model=jm, execution=jcfg.ExecutionConfig(
                kernels=engine, compute_dtype=compute, param_dtype=param,
                pallas_interpret=True))
            fn = jax.jit(jax.value_and_grad(lambda p, b, s: _loss_fn(p, b, s, cfg),
                                            has_aux=True))
            (loss, (logits, aux)), grads = fn(params, batch, state)
            cache[key] = dict(loss=loss, logits=logits, stats=aux["bn_stats"], grads=grads,
                              params=params, state=state, batch=batch)
        return cache[key]

    return run


def _pairs(tree):
    """(path, leaf) of a tree of tensors or arrays, or of one leaf."""
    return bridge.flatten(tree) if isinstance(tree, dict) else [("", tree)]


@pytest.mark.parametrize("param", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_bf16_engine_train_step_matches_jax(jax_runs, no_launch, engine, param):
    """One training forward and backward of the tiny model in bf16 compute
    under the engine, from one bridged state, against JAX's: each leaf
    within 2x JAX's own gap between its bf16 run and its fp32 run (fp32
    compute and parameters, the same parameter values) plus 1e-5, of the
    leaf's max; the gap is each leaf's max|bf16 - fp32| / max|bf16|, its
    largest over the forward's results (summed loss, logits and every
    batch statistic: the loss alone is one number, whose gap may be near 0
    by chance) and over the gradient tree. The gradients keep their
    parameters' dtype."""
    from resnet_tpu_torch.train import loss_and_grads

    want = jax_runs(engine, "bfloat16", param)
    ref = jax_runs(engine, "float32", "float32")
    tm = tcfg.tiny_model_config(**ENGINES[engine])
    cfg = tcfg.TrainConfig(model=tm, execution=tcfg.ExecutionConfig(
        kernels=engine, compute_dtype="bfloat16", param_dtype=param))
    params = bridge.params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                   want["params"]), device="cpu")
    params = bridge.unflatten((p, t.to(tcfg.resolve_dtype(param)))
                              for p, t in bridge.flatten(params))
    batch = {k: torch.from_numpy(v) for k, v in want["batch"].items()}
    loss, logits, aux, grads = loss_and_grads(
        params, batch, bridge.bn_state_from_numpy(want["state"], device="cpu"), cfg)
    assert all(g.dtype == p.dtype for g, p in zip(bridge.leaves(grads),
                                                   bridge.leaves(params)))
    for what, keys, got in (("forward", ("loss", "logits", "stats"), (loss, logits,
                                                                     aux["bn_stats"])),
                            ("grads", ("grads",), (grads,))):
        a = [pair for t in got for pair in _pairs(t)]
        b = [pair for k in keys for pair in _pairs(want[k])]
        b32 = [pair for k in keys for pair in _pairs(ref[k])]
        assert [p for p, _ in a] == [p for p, _ in b] == [p for p, _ in b32], what
        gap = max(float(np.abs(_np(x) - _np(y)).max()) / max(float(np.abs(_np(x)).max()),
                                                             1e-30)
                  for (_, x), (_, y) in zip(b, b32))
        for (path, g), (_, w) in zip(a, b):
            scale = max(float(np.abs(_np(w)).max()), 1e-30)
            err = float(np.abs(_np(g) - _np(w)).max())
            assert err <= (2 * gap + FLOOR) * scale, (what, path, err, gap, scale)
