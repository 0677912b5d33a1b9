"""The port's W8A8 quantization (resnet_tpu_torch.quantize and the plain
versions of its two int8 kernels, kernels/quant.py) against
resnet_tpu.quantize on the CPU, and its entry points: the export, the saved
file, the HTTP server, ``Trainer.evaluate_quantized`` and the CLI's
``--int8``.

Both packages start from one parameter tree (JAX's init, bridged) and
running statistics made non-trivial as tests/test_quantize.py makes them;
inputs are numpy arrays from a seed. Tolerances, each with its reason:

* fold: each leaf within 1e-6 of its max|.| (the same fp32 ops; XLA may
  rewrite a / sqrt(b) as a * rsqrt(b), an ulp or two);
* folded forward: within 1e-4 of max|logit| of JAX's and of the port's own
  eval forward (fp32 convs summed in other orders);
* calibration: the same sites, each scale within 1e-5 relative (absmax of
  activations that carry those orders' differences);
* weights, quantized from one folded tree: wq equal except where |w / s|
  lies within 1e-6 of a .5 tie (at most 1 apart there), ws within 1e-6
  relative, every channel reaching |wq| >= 126;
* Q2's and Q1's plain versions: bit for bit (int8, int32, bf16 and fp32);
  XLA's CPU backend does not contract the dequantization's multiply and
  add here, so no ulp is allowed;
* the whole forward from JAX's (qparams, scales): logits within 1e-2 of
  max|logit| and the same argmax wherever JAX's top-2 gap exceeds that;
* the port's own quantize_model: JAX's own criteria (correlation with its
  folded forward above 0.98, argmax agreement at least 0.75).
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from resnet_tpu import quantize as jq
from resnet_tpu.config import tiny_model_config as j_tiny
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu_torch import quantize as tq
from resnet_tpu_torch import serve as serve_mod
from resnet_tpu_torch.bridge import flatten, params_from_numpy, qparams_from_numpy
from resnet_tpu_torch.config import ExecutionConfig, tiny_model_config
from resnet_tpu_torch.export import (
    QuantizedInferenceModel,
    export_inference,
    export_quantized_inference,
    load_inference,
    save_inference,
)
from resnet_tpu_torch.kernels import bn, build, checks, quant
from resnet_tpu_torch.models import forward

FOLD_TOL = 1e-6
FOLDED_TOL = 1e-4
SCALE_TOL = 1e-5
WS_TOL = 1e-6
TIE_BAND = 1e-6
LOGIT_TOL = 1e-2


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


MODELS = {"bottleneck": {}, "basic": dict(bottleneck=False, expansion=1),
          "grouped": dict(groups=2, width_multiplier=2.0)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(JAX config, port config, JAX params, JAX bn_state, port params, port
    bn_state): one init, running statistics made non-trivial as
    tests/test_quantize.py does (a fresh init folds to an identity affine).
    'grouped' is the tiny ResNeXt: its spatial sites are grouped convs."""
    over = MODELS[request.param]
    jm, mcfg = j_tiny(**over), tiny_model_config(**over)
    jp = j_init_params(jax.random.PRNGKey(1234), jm)
    js = jax.tree.map(lambda a: a + 0.15 * (1.0 + jnp.arange(a.shape[0]) % 3),
                      j_init_bn_state(jm))
    return (jm, mcfg, jp, js, params_from_numpy(_np(jp), "cpu"),
            params_from_numpy(_np(js), "cpu"))


def _images(seed, n, d=16):
    return np.random.default_rng(seed).normal(0, 50, (n, d, d, 3)).astype(np.float32)


def test_fold_matches_jax(model):
    jm, mcfg, jp, js, tp, ts = model
    want = dict(flatten(_np(jq.fold_bn_inference(jp, js, jm))))
    got = dict(flatten(tq.fold_bn_inference(tp, ts, mcfg)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=FOLD_TOL * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("relu_cap", [None, 10.0])
def test_folded_forward_matches_jax_and_the_eval_forward(model, relu_cap):
    jm, mcfg, jp, js, tp, ts = model
    x = _images(1, 4)
    want = np.asarray(jq.folded_forward(jq.fold_bn_inference(jp, js, jm), jnp.asarray(x), jm,
                                        relu_cap=relu_cap))
    got = tq.folded_forward(tq.fold_bn_inference(tp, ts, mcfg), torch.from_numpy(x), mcfg,
                            relu_cap=relu_cap).numpy()
    tol = FOLDED_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ev, _ = forward(tp, torch.from_numpy(x), mcfg, ExecutionConfig(relu_cap=relu_cap),
                    train=False, bn_state=ts)
    np.testing.assert_allclose(got, ev.numpy(), rtol=0, atol=tol)


def test_calibrate_matches_jax(model):
    jm, mcfg, jp, js, tp, ts = model
    x = _images(2, 8)
    want = jq.calibrate(jq.fold_bn_inference(jp, js, jm), jnp.asarray(x), jm, batch_size=4)
    got = tq.calibrate(tq.fold_bn_inference(tp, ts, mcfg), x, mcfg, batch_size=4)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k] == float(np.float32(got[k])) and got[k] > 0
        assert abs(got[k] - float(w)) <= SCALE_TOL * float(w), k


def test_quantize_weights_matches_jax(model):
    """Both quantize JAX's folded tree, so w and s are the same values and
    the rounding alone is held."""
    jm, mcfg, jp, js, _, _ = model
    ji = jq.fold_bn_inference(jp, js, jm)
    want = dict(flatten(_np(jq.quantize_weights(ji, jm))))
    got = dict(flatten(tq.quantize_weights(params_from_numpy(_np(ji), "cpu"), mcfg)))
    assert sorted(got) == sorted(want)
    leaves = dict(flatten(_np(ji)))
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        if k.endswith("/ws"):
            np.testing.assert_allclose(g, w, rtol=WS_TOL, atol=0, err_msg=k)
        elif k.endswith("/wq"):
            ratio = leaves[k[:-2] + "w"] / want[k[:-2] + "ws"]
            near_tie = np.abs(np.abs(ratio) % 1.0 - 0.5) < TIE_BAND
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert (diff[~near_tie] == 0).all() and (diff <= 1).all(), k
            reach = np.abs(g.astype(np.int32)).reshape(-1, g.shape[-1]).max(axis=0)
            assert (reach >= 126).all(), k


def _quant_act_cases():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 50, (2, 16, 16, 3)).astype(np.float32)
    ties = ((np.arange(-140, 140) + 0.5) / 4.0).astype(np.float32)  # x * 4 = k + 0.5
    wide = rng.normal(0, 400, (1000,)).astype(np.float32)  # beyond +-127 * scale
    return {
        "fp32": (x, float(np.abs(x).max() / np.float32(127.0))),
        "bf16": (x, float(np.abs(x).max() / np.float32(127.0))),
        "ties": (ties, 0.25),
        "clipped": (wide, 1.0),
    }


@pytest.mark.parametrize("case", ["fp32", "bf16", "ties", "clipped"])
def test_quant_act_plain_is_jax_bit_for_bit(case):
    x, scale = _quant_act_cases()[case]
    scale = np.float32(scale)
    tx, jx = torch.from_numpy(x.copy()), jnp.asarray(x)
    if case == "bf16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
        assert np.array_equal(tx.float().numpy(), np.asarray(jx.astype(jnp.float32)))
    want = np.asarray(jq._quant_act(jx, scale))
    got = quant.quant_act(tx, tq.inverse_scale(scale))  # on the CPU: the plain version
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    if case in ("ties", "clipped"):
        assert np.abs(want.astype(np.int32)).max() == 127
    if case == "ties":  # half to even
        for k, q in ((0.5, 0), (1.5, 2), (2.5, 2), (-0.5, 0), (-1.5, -2), (125.5, 126)):
            assert (want[x * 4 == k] == q).all(), k


# (label, H, Cin, Cout, k, stride, groups)
QCONV_CASES = [
    ("stem 7x7/s2 Cin 3", 16, 3, 8, 7, 2, 1),
    ("3x3/s1", 8, 16, 12, 3, 1, 1),
    ("3x3/s2", 8, 16, 12, 3, 2, 1),
    ("1x1/s1", 8, 32, 24, 1, 1, 1),
    ("1x1/s2", 8, 32, 24, 1, 2, 1),
    ("grouped 3x3/s1 g2", 8, 16, 12, 3, 1, 2),
    # Q3's: ResNeXt's 4 channels a group, a stride-2 site, 8 a group, and a
    # ragged group (Cin / g 3, Cout / g 5) on the kernel's byte path
    ("grouped 3x3/s1 g8 Cin/g 4", 8, 32, 32, 3, 1, 8),
    ("grouped 3x3/s2 g4 Cin/g 8", 8, 32, 16, 3, 2, 4),
    ("grouped 3x3/s1 g2 Cin/g 3 Cout/g 5", 6, 6, 10, 3, 1, 2),
]


@pytest.mark.parametrize("label,h,cin,cout,k,stride,groups", QCONV_CASES,
                         ids=[c[0] for c in QCONV_CASES])
@pytest.mark.parametrize("act", ["none", "relu", "relu cap 3"])
def test_qconv_plain_is_jax_bit_for_bit(label, h, cin, cout, k, stride, groups, act):
    """Q1's plain version on JAX's int8 inputs: the int32 accumulator equals
    _qconv's, and the site's bf16 output (quantize, conv, dequantize with
    bias, then ReLU and the cap where the site has them) equals _qsite's,
    followed by _relu where the site has one."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 3, (2, h, h, cin)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, k, cin // groups, cout)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-2, cout).astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    scale = np.float32(np.abs(x).max() / np.float32(127.0))
    xq = np.asarray(jq._quant_act(jnp.asarray(x), scale))
    want_acc = np.asarray(jq._qconv(jnp.asarray(xq), jnp.asarray(wq), stride, groups))
    got_acc = quant.qconv_acc_reference(torch.from_numpy(xq.copy()), torch.from_numpy(wq.copy()),
                                        stride, groups)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)

    q = {"wq": jnp.asarray(wq), "ws": jnp.asarray(ws), "b": jnp.asarray(b)}
    relu, relu_cap = act != "none", 3.0 if act.endswith("cap 3") else None
    want = jq._qsite(jnp.asarray(x), q, scale, stride, groups)
    want = np.asarray((jq._relu(want, relu_cap) if relu else want).astype(jnp.float32))
    tw = torch.from_numpy(wq.copy())
    dq = torch.from_numpy(ws.copy()) * float(scale)
    xt = quant.quant_act(torch.from_numpy(x.copy()), tq.inverse_scale(scale))
    got = quant.qconv(xt, tw, dq, torch.from_numpy(b.copy()), stride=stride, groups=groups,
                      relu=relu, cap=relu_cap)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_fc_plain_is_jax_bit_for_bit():
    """The FC: the pooled features quantized, (N, K) @ (K, N') in int32 as a
    1x1 conv over an (N, 1, 1, K) view, dequantized to fp32 logits
    (quantize.py:279-287), with and without a bias."""
    rng = np.random.default_rng(11)
    pooled = rng.normal(0, 1, (3, 64)).astype(np.float32)
    wq = rng.integers(-127, 128, (64, 10)).astype(np.int8)
    ws = rng.uniform(1e-3, 1e-2, 10).astype(np.float32)
    b = rng.normal(0, 0.5, 10).astype(np.float32)
    scale = np.float32(np.abs(pooled).max() / np.float32(127.0))
    y = lax.dot_general(jq._quant_act(jnp.asarray(pooled), scale), jnp.asarray(wq),
                        (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    logits = y.astype(jnp.float32) * (jnp.asarray(ws) * scale)
    xt = quant.quant_act(torch.from_numpy(pooled), tq.inverse_scale(scale)).view(3, 1, 1, 64)
    dq = torch.from_numpy(ws) * float(scale)
    w4 = torch.from_numpy(wq).view(1, 1, 64, 10)
    for bias in (None, b):
        want = np.asarray(logits if bias is None else logits + jnp.asarray(bias))
        got = quant.qconv(xt, w4, dq, None if bias is None else torch.from_numpy(bias),
                          out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.view(3, 10).numpy(), want)


@pytest.mark.parametrize("relu_cap", [None, 10.0])
def test_quantized_forward_from_jax_qparams(model, relu_cap):
    """JAX's (qparams, scales) carried across by qparams_from_numpy: the
    port's int8 forward gives JAX's logits."""
    jm, mcfg, jp, js, _, _ = model
    qparams, scales = jq.quantize_model(jp, js, jm, jnp.asarray(_images(4, 8)),
                                        relu_cap=relu_cap)
    x = _images(5, 6)
    want = np.asarray(jq.quantized_forward(qparams, scales, jnp.asarray(x), jm,
                                           relu_cap=relu_cap))
    tqp, tsc = qparams_from_numpy(_np(qparams), scales, device="cpu")
    assert tqp["init"]["wq"].dtype == torch.int8 and set(tsc) == set(scales)
    got = tq.quantized_forward(tqp, tsc, torch.from_numpy(x), mcfg, relu_cap=relu_cap).numpy()
    tol = LOGIT_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > tol
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_grouped_sites_give_jax_accumulators_and_logits():
    """The tiny grouped model quantized by JAX and carried across: at each
    grouped (spatial) site, on one bf16 activation, the port's int32
    accumulator (Q3's plain version on the unpacked weight) equals
    _qconv's; the port's logits equal JAX's quantized_forward bit for
    bit."""
    over = MODELS["grouped"]
    jm, mcfg = j_tiny(**over), tiny_model_config(**over)
    jp = j_init_params(jax.random.PRNGKey(7), jm)
    js = jax.tree.map(lambda a: a + 0.15 * (1.0 + jnp.arange(a.shape[0]) % 3),
                      j_init_bn_state(jm))
    qparams, scales = jq.quantize_model(jp, js, jm, jnp.asarray(_images(8, 8)))
    tqp, tsc = qparams_from_numpy(_np(qparams), scales, device="cpu")
    sites = tq.prepare_sites(tqp, tsc, mcfg)
    rng = np.random.default_rng(9)
    grouped = [name for name, site in sites.items() if site["groups"] > 1]
    assert grouped == [f"b{i}.spatial" for i in range(mcfg.num_blocks)]
    for name in grouped:
        site, q = sites[name], qparams["blocks"][int(name[1])]["spatial"]
        cin = site["kshape"][2] * mcfg.groups
        x = jnp.asarray(rng.normal(0, 2, (2, 8, 8, cin)), jnp.bfloat16)
        xq = jq._quant_act(x, np.float32(scales[name]))
        stride = 2 if mcfg.is_reduction_block(int(name[1])) else 1
        want = np.asarray(jq._qconv(xq, q["wq"], stride, mcfg.groups))
        w = quant.unpack_weight(site["wk"], site["kshape"], site["groups"])
        np.testing.assert_array_equal(w.numpy(), np.asarray(q["wq"]))
        got = quant.qconv_acc_reference(torch.from_numpy(np.array(xq)), w, stride,
                                        site["groups"])
        np.testing.assert_array_equal(got.numpy(), want)
    x = _images(10, 6)
    want = np.asarray(jq.quantized_forward(qparams, scales, jnp.asarray(x), jm))
    got = tq.forward_sites(sites, torch.from_numpy(x), mcfg).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_model_tracks_its_folded_forward(model):
    """The port's quantize_model end to end, by JAX's own criteria
    (tests/test_quantize.py:72-88)."""
    _, mcfg, _, _, tp, ts = model
    qparams, scales = tq.quantize_model(tp, ts, mcfg, _images(6, 8))
    x = torch.from_numpy(_images(7, 16))
    fp = tq.folded_forward(tq.fold_bn_inference(tp, ts, mcfg), x, mcfg).numpy()
    q = tq.quantized_forward(qparams, scales, x, mcfg).numpy()
    assert q.shape == fp.shape and np.isfinite(q).all()
    assert np.corrcoef(fp.ravel(), q.ravel())[0, 1] > 0.98
    assert np.mean(fp.argmax(-1) == q.argmax(-1)) >= 0.75


def test_pack_weight_is_k_major_and_zero_padded():
    """The stem's weight packed as Q1 reads it: each of its 7 kernel rows'
    21 bytes ((dj, ci) order) padded to 32, so K = 224, then zero up to
    Kp = 256; unpack_weight gives the HWIO weight back as a view."""
    w = torch.arange(7 * 7 * 3 * 5, dtype=torch.int32).remainder(255).sub(127)
    w = w.to(torch.int8).view(7, 7, 3, 5)
    wk = quant.pack_weight(w)
    assert quant.row_bytes(7, 3) == 32 and quant.packed_k((7, 7, 3)) == 224
    assert wk.shape == (5, 256) and wk.dtype == torch.int8  # 224 -> 4 multiples of 64
    for co in range(5):
        for di in range(7):
            assert torch.equal(wk[co, 32 * di:32 * di + 21], w[di, ..., co].reshape(-1))
            assert not wk[co, 32 * di + 21:32 * di + 32].any()
    assert not wk[:, 224:].any()
    # unpack_weight is its inverse, a view of wk
    back = quant.unpack_weight(wk, (7, 7, 3))
    assert torch.equal(back, w) and back.untyped_storage().data_ptr() == wk.data_ptr()


@pytest.mark.parametrize("kshape", [(1, 1, 64), (3, 3, 64), (1, 1, 2048), (3, 3, 512),
                                    (1, 1, 3), (3, 3, 3), (2, 3, 5)])
def test_pack_weight_rows(kshape):
    """Where Cin % 16 == 0 the packed K is the plain (di, dj, ci) order with
    no padding (ResNet-50's every site but the stem); otherwise each kernel
    row is padded to 16 bytes. Either way unpack_weight inverts it."""
    kh, kw, cin = kshape
    w = torch.randint(-127, 128, (*kshape, 24), generator=torch.Generator().manual_seed(1),
                      dtype=torch.int8)
    wk = quant.pack_weight(w)
    k = kh * kw * cin
    assert wk.shape == (24, quant.padded_k(kshape)) and wk.shape[1] % quant.BK == 0
    assert quant.packed_k(kshape) == kh * -(-kw * cin // 16) * 16
    if cin % 16 == 0:
        assert quant.packed_k(kshape) == k
        assert torch.equal(wk[:, :k], w.reshape(k, 24).t())
    assert int(wk.ne(0).sum()) == int(w.ne(0).sum())  # the padding is zero
    assert torch.equal(quant.unpack_weight(wk, kshape), w)


@pytest.mark.parametrize("kshape,groups", [((3, 3, 4), 32), ((3, 3, 3), 2), ((1, 1, 8), 4)])
def test_grouped_pack_weight(kshape, groups):
    """Q3's packed weight: (kh * kw, Cout, Cgp), row (tap, co) the tap's
    Cin / g bytes of w[..., co] zero-padded to a multiple of 4;
    unpack_weight views it as HWIO again."""
    kh, kw, cin_g = kshape
    cout = 2 * groups
    w = torch.randint(-127, 128, (*kshape, cout), generator=torch.Generator().manual_seed(2),
                      dtype=torch.int8)
    wk = quant.pack_weight(w, groups)
    cgp = quant.group_row_bytes(cin_g)
    assert wk.shape == (kh * kw, cout, cgp) and cgp % 4 == 0 and cgp - cin_g < 4
    for di in range(kh):
        for dj in range(kw):
            assert torch.equal(wk[di * kw + dj, :, :cin_g], w[di, dj].t())
    assert not wk[..., cin_g:].any()
    back = quant.unpack_weight(wk, kshape, groups)
    assert torch.equal(back, w) and back.untyped_storage().data_ptr() == wk.data_ptr()


def test_grouped_qconv_hands_q3_its_arguments(monkeypatch):
    """groups > 1 on a card launches Q3 (rt_qconv_grouped_s8) with
    build.SIGNATURES' arguments and moves GROUPED_LAUNCHES, not Q1's
    counter: ResNeXt-50's first stage-2 3x3 (256 -> 256 in 32 groups, s2)
    at batch 2. Recorded here with the launch replaced, through the op's
    CUDA implementation (``quant._qconv``), which the dispatcher runs for
    CUDA tensors."""
    calls = []
    monkeypatch.setattr(quant, "_on_card", lambda *a: True)
    monkeypatch.setattr(build, "launch", lambda name, *args, device: calls.append((name, args)))
    xq = torch.zeros(2, 56, 56, 256, dtype=torch.int8)
    w = torch.zeros(3, 3, 8, 256, dtype=torch.int8)
    dq, b = torch.ones(256), torch.zeros(256)
    before = quant.LAUNCHES, quant.GROUPED_LAUNCHES
    out = quant._qconv(xq, w, dq, b, stride=2, groups=32, relu=True, cap=6.0)
    assert out.shape == (2, 28, 28, 256) and out.dtype == torch.bfloat16
    assert (quant.LAUNCHES, quant.GROUPED_LAUNCHES) == (before[0], before[1] + 1)
    name, args = calls[-1]
    assert name == "rt_qconv_grouped_s8" and len(args) + 1 == len(build.SIGNATURES[name])
    assert args[5:21] == (2, 56, 56, 256, 256, 32, 3, 3, 2, 1, 1, 28, 28, 1, True, 6.0)
    # the plan: 4 column blocks (a group each) a span, tiles of 2 output rows
    assert args[21:] == build.q3_plan(2, 256, 256, 32, 3, 3, 2, 28, 28, False,
                                      True) == (4, 1, 2)
    with pytest.raises(ValueError, match="pack_weight"):  # a Q1 packing is refused
        quant._qconv(xq, w, dq, stride=2, groups=32, wk=quant.pack_weight(w))
    with pytest.raises(ValueError):  # 256 input channels are not 32 groups of 4
        quant._qconv(xq, w[:, :, :4], dq, stride=2, groups=32)


Q3_SITES = sorted({case[1:] for preset in ("resnext50_32x4d", "resnext101_32x8d")
                   for batch in (1, 8, 128) for case in checks.qconv_grouped_sites(preset, batch)})


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", Q3_SITES, ids=[f"b{c[0]} {c[1]}^2 {c[2]}->{c[3]} s{c[5]}"
                                                for c in Q3_SITES])
def test_q3_plan_fits_and_covers_every_output_once(site, f32):
    """Every grouped site of both ResNeXt presets at batches 1, 8 and 128
    gets a plan (build.q3_plan) whose layout (build.q3_geometry, qconv.cu's
    q3_geometry) fits a block's shared memory, two blocks a SM, and on the
    16-byte halo path with at most Q3_CHUNKS copies a thread. Walked as the
    kernel walks it (block b: span b % spans, tiles b // spans + P i, for
    any P), every output pixel and channel is stored exactly once."""
    n, h, cin, cout, k, s, _, _, _, g = site
    ho = h // s
    plan = build.q3_plan(n, cin, cout, g, k, k, s, ho, ho, f32, True)
    geo = build.q3_geometry(n, cin, cout, g, k, k, s, ho, ho, f32, True, *plan)
    assert geo is not None and geo["smem"] <= build.Q3_SMEM
    assert 2 * (build.Q3_SMEM + 1024) <= 233472  # two blocks and their reserve a SM
    assert geo["dense"] and geo["halo_pixels"] * geo["span_bytes"] // 16 <= (
        build.Q3_THREADS * build.Q3_CHUNKS)
    sb, ti, tr = plan
    stored = torch.zeros(n * ho * ho, cout, dtype=torch.int32)
    ncb = -(-cout // 8)
    for per in (1, 3, max(1, 2 * 132 // geo["spans"])):
        stored.zero_()
        for b in range(geo["spans"] * min(per, geo["tiles"])):
            span, step = b % geo["spans"], min(per, geo["tiles"])
            cb0 = span * geo["cbs"]
            cols = slice(8 * cb0, min(8 * (cb0 + geo["cbs"]), 8 * ncb, cout))
            for tile in range(b // geo["spans"], geo["tiles"], step):
                if ti > 1:
                    m0, tpv = tile * ti * ho * ho, min(ti, n - tile * ti) * ho * ho
                else:
                    img, oy0 = divmod(tile, geo["row_tiles"])
                    oy0 *= tr
                    m0, tpv = (img * ho + oy0) * ho, min(tr, ho - oy0) * ho
                assert 0 < tpv <= geo["tile_pixels"] <= 16 * geo["m_tiles"]
                stored[m0:m0 + tpv, cols] += 1
        assert bool((stored == 1).all()), (per, plan)


def test_q3_refuses_an_odd_height_at_stride_2(monkeypatch):
    """The reference geometry needs the stride to divide H (reference_padding):
    Q3's wrapper refuses an odd H at stride 2 with the plain version's
    ValueError, before any launch."""
    monkeypatch.setattr(quant, "_on_card", lambda *a: True)
    monkeypatch.setattr(build, "launch", lambda *a, **k: pytest.fail("launched"))
    xq = torch.zeros(2, 7, 7, 64, dtype=torch.int8)
    w = torch.zeros(3, 3, 4, 64, dtype=torch.int8)
    for run in (quant._qconv, quant.qconv_reference):
        with pytest.raises(ValueError, match="stride"):
            run(xq, w, torch.ones(64), stride=2, groups=16)


def test_q3_refuses_rows_too_wide_for_its_tiles(monkeypatch):
    """No Q3 tile of 2000 output columns (a halo row of one span alone
    passes a block's shared memory): the wrapper raises before any launch
    rather than run another path."""
    monkeypatch.setattr(quant, "_on_card", lambda *a: True)
    monkeypatch.setattr(build, "launch", lambda *a, **k: pytest.fail("launched"))
    xq = torch.zeros(1, 2, 2000, 64, dtype=torch.int8)
    w = torch.zeros(3, 3, 4, 64, dtype=torch.int8)
    assert build.q3_plan(1, 64, 64, 16, 3, 3, 1, 2, 2000, False, True) is None
    with pytest.raises(ValueError, match="fits shared memory"):
        quant._qconv(xq, w, torch.ones(64), groups=16)


def test_qconv_constants_mirror_the_source():
    """The wrapper's and the planner's view of qconv.cu: a kernel row's
    padding, the packed row's multiple, the slice depth and tile height."""
    src = (build.CSRC / "qconv.cu").read_text()
    assert f"constexpr int RUN = {quant.RUN};" in src
    assert f"constexpr int KP_ALIGN = {quant.BK};" in src
    assert "constexpr int SK = 2 * wgb::BK;" in src and build.QC_SLICE == 2 * build.WGB_BK
    assert "constexpr int BM = wgb::BM;" in src and build.QC_BM == build.WGB_BM
    for name in ("Q3_THREADS", "Q3_CHUNKS", "Q3_SMEM", "Q3_BUFS", "Q3_NB_MAX"):
        assert f"constexpr int {name} = {getattr(build, name)};" in src


def test_qconv_refuses_a_packed_weight_of_the_old_layout(monkeypatch):
    """A packed stem weight of the layout before kernel rows were padded
    ((Cout, 192): K = 147 in the plain order, zero up to 192) is refused,
    with a message saying to re-pack it or export the model again; files
    written by save_inference hold the HWIO weight and pack it at load."""
    monkeypatch.setattr(quant, "_on_card", lambda *a: True)
    monkeypatch.setattr(build, "launch", lambda *a, **k: pytest.fail("launched"))
    xq = torch.zeros(1, 32, 32, 3, dtype=torch.int8)
    w = torch.ones(7, 7, 3, 8, dtype=torch.int8)
    old = torch.zeros(8, 192, dtype=torch.int8)
    old[:, :147] = w.reshape(147, 8).t()
    with pytest.raises(ValueError, match="export the model"):
        quant._qconv(xq, w, torch.ones(8), stride=2, wk=old)


def test_qconv_hands_the_kernel_its_arguments(monkeypatch):
    """On a card the wrappers call their C entries with build.SIGNATURES'
    arguments: the stem's reference padding (3, 2) as pad_top/left 3, the
    packed weight's row length, the mode and the cap, build.qconv_plan's
    tile width and K splits, and for a split launch the partials and
    zeroed tickets of the stream's scratch (``bn._workspace``); Q2 its
    inverse scale. Recorded here with the launch replaced, through the ops'
    CUDA implementations (``quant._qconv``, ``quant._quant_act``), which
    the dispatcher runs for CUDA tensors."""
    calls = []
    monkeypatch.setattr(quant, "_on_card", lambda *a: True)
    monkeypatch.setattr(build, "on_card", lambda *a, **k: True)
    monkeypatch.setattr(build, "launch", lambda name, *args, device: calls.append((name, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    xq = torch.zeros(2, 224, 224, 3, dtype=torch.int8)
    w = torch.zeros(7, 7, 3, 64, dtype=torch.int8)
    dq, b = torch.ones(64), torch.zeros(64)
    before = quant.LAUNCHES
    out = quant._qconv(xq, w, dq, b, stride=2, relu=True, cap=6.0)
    assert out.shape == (2, 112, 112, 64) and out.dtype == torch.bfloat16
    name, args = calls[-1]
    assert name == "rt_qconv_s8" and len(args) + 1 == len(build.SIGNATURES[name])
    # 2 x 112^2 rows on 196 tiles of 128 x 64 fill the card: no split, no scratch
    assert args[5:7] == (None, None)
    assert args[7:] == (2, 224, 224, 3, 64, 7, 7, 2, 3, 3, 112, 112, 256, 1, True, 6.0,
                        *build.qconv_plan(25088, 64, 224)) and args[-2:] == (64, 1)
    assert quant.LAUNCHES == before + 1
    quant._qconv(xq[:, :1, :1, :].contiguous().view(2, 1, 1, 3), w[:1, :1].contiguous(), dq,
                None, out_dtype=torch.float32)
    assert calls[-1][1][3] is None and calls[-1][1][-5:] == (2, False, 0.0, 64, 1)
    # the FC at batch 8: 16 tiles of 128 x 64, its 16 slices in 8 splits
    part, tickets = torch.empty(16 * 8 * 128 * 64), torch.zeros(16, dtype=torch.int32)
    monkeypatch.setitem(bn._WORKSPACES, (None, 7), [part, tickets])
    xf = torch.zeros(8, 1, 1, 2048, dtype=torch.int8)
    wf = torch.zeros(1, 1, 2048, 1000, dtype=torch.int8)
    quant._qconv(xf, wf, torch.ones(1000), torch.zeros(1000), out_dtype=torch.float32)
    args = calls[-1][1]
    assert args[5:7] == (part.data_ptr(), tickets.data_ptr()) and args[-2:] == (64, 8)
    assert all(a is b for a, b in zip(bn._WORKSPACES[(None, 7)], (part, tickets)))
    before = quant.ACT_LAUNCHES
    quant._quant_act(torch.zeros(4, 8, dtype=torch.bfloat16), 0.5)
    name, args = calls[-1]
    assert name == "rt_quant_act_bf16" and args[2:] == (0.5, 32)
    assert len(args) + 1 == len(build.SIGNATURES[name]) and quant.ACT_LAUNCHES == before + 1


def test_qconv_rejects_what_the_kernel_does_not_take():
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8)
    w = torch.zeros(3, 3, 8, 4, dtype=torch.int8)
    dq = torch.ones(4)
    for kw in (dict(cap=2.0), dict(relu=True, out_dtype=torch.float32),
               dict(out_dtype=torch.float16)):
        with pytest.raises((TypeError, ValueError)):
            quant.qconv(xq, w, dq, **kw)
    with pytest.raises(TypeError):
        quant.qconv(xq.float(), w, dq)
    with pytest.raises(ValueError):
        quant.qconv(xq, w, dq.double())


# (label, m, n, k, split): ResNet-50 sites (m pixels, n = Cout, k =
# quant.packed_k) whose tiles alone leave most of the card idle, where the
# plan must split K (split True), and others
PLAN_SHAPES = [
    ("stage 4 3x3 batch 8", 392, 512, 4608, True), ("stage 4 3x3 batch 1", 49, 512, 4608, True),
    ("stage 4 proj batch 8", 392, 2048, 9216, True),
    ("stage 4 proj batch 1", 49, 2048, 9216, True),
    ("stage 4 reduce batch 8", 392, 512, 2048, True), ("fc batch 8", 8, 1000, 2048, True),
    ("fc batch 1", 1, 1000, 2048, True), ("stage 4 expand batch 1", 49, 2048, 512, None),
    ("stem batch 8", 100352, 64, 224, None), ("stem batch 1", 12544, 64, 224, None),
    ("stage 1 expand batch 128", 401408, 256, 64, False), ("one slice", 300, 64, 128, False),
]


@pytest.mark.parametrize("label,m,n,k,split", PLAN_SHAPES, ids=[s[0] for s in PLAN_SHAPES])
def test_qconv_plan(label, m, n, k, split):
    """build.qconv_plan: a tile width of 64, 128 or 256 and K splits of whole
    128-deep slices, none empty, the least of its documented cost over
    every such candidate (the wider tile, then fewer splits, on a tie), a
    function of the shapes alone (cached); on the stage-4 sites and the FC
    at batches 8 and 1 it splits K, so they run on more SMs than their
    tiles (one slice cannot split)."""
    tile_n, splits = build.qconv_plan(m, n, k)
    slices = -(-k // build.QC_SLICE)
    chunk = -(-slices // splits)
    assert tile_n in (64, 128, 256) and 1 <= splits <= slices and -(-slices // chunk) == splits
    assert build.qconv_plan(m, n, k) == (tile_n, splits) and build.qconv_plan.cache_info().hits

    def cost(tile_n, splits):
        tiles = -(-m // build.QC_BM) * -(-n // tile_n)
        c = -(-tiles * splits // build._SMS) * (
            -(-slices // splits) * build.QC_SLICE_COST[tile_n] + build.QC_UNIT_COST[tile_n])
        return c + (splits * m * n * build.QC_PARTIAL_COST if splits > 1 else 0)
    every = [(cost(b, s), -b, s) for b in (64, 128, 256)
             for s in {-(-slices // c) for c in range(1, slices + 1)}]
    assert min(every) == (cost(tile_n, splits), -tile_n, splits)
    if split is not None:
        assert (splits > 1) == split
    if slices == 1:
        assert splits == 1


@pytest.fixture(scope="module")
def int8_file(tmp_path_factory):
    mcfg = tiny_model_config()
    gen = torch.Generator().manual_seed(1234)
    from resnet_tpu_torch.models import init_bn_state, init_params

    params, bn_state = init_params(gen, mcfg, device="cpu"), init_bn_state(mcfg, device="cpu")
    for layer in [bn_state["init_bn"], *[b for bb in bn_state["blocks"] for b in bb.values()]]:
        layer["mean"] += 0.1
        layer["var"] += 0.1
    model = export_quantized_inference(params, mcfg, _images(8, 8), bn_state=bn_state,
                                       relu_cap=10.0)
    path = save_inference(str(tmp_path_factory.mktemp("int8") / "m.pt"), model)
    return path, model, (params, bn_state, mcfg)


def test_int8_file_round_trip(int8_file):
    """The int8 artifact is a program whose record says 'int8' and holds
    the scales and the cap; its logits are the eager model's, which are the
    plain int8 forward's."""
    path, model, (params, bn_state, mcfg) = int8_file
    served = load_inference(path, device="cpu")
    assert served.kind == "int8" and isinstance(model, QuantizedInferenceModel)
    assert served.meta["scales"] == model.scales and served.meta["relu_cap"] == 10.0
    assert served.image_dims == (16, 16, 3) and served.device.type == "cpu"
    logits = served.call(np.zeros((3, 16, 16, 3), np.float32))
    assert tuple(logits.shape) == (3, 8) and np.isfinite(logits.numpy()).all()
    x = _images(9, 3)
    assert torch.equal(served.call(x), model.call(x))
    plain = tq.forward_sites(model.sites(), torch.from_numpy(x), model.mcfg,
                             relu_cap=model.relu_cap, plain=True)
    assert torch.equal(plain, model.call(x))
    # each site keeps its int8 weight once, in the layout Q1 reads
    names = list(served.program.state_dict)
    assert any(n.endswith("__wk") for n in names) and not any(n.endswith("__wq") for n in names)
    with pytest.raises(ValueError, match="shape"):
        served.call(np.zeros((1, 3, 16, 16), np.float32))
    # an fp artifact says so
    fp = save_inference(path + ".fp", export_inference(params, mcfg, bn_state=bn_state))
    assert load_inference(fp, device="cpu").kind == "fp"


def test_int8_file_serves_over_http(int8_file):
    path, model, _ = int8_file
    httpd = serve_mod.serve(path, port=0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        x = _images(10, 3)
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
        conn.request("POST", "/predict", body=x.tobytes(), headers={"X-Shape": "3,16,16,3"})
        r = conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 200 and out["logits_shape"] == [3, 8]
        assert out["top1"] == model.call(x).argmax(-1).tolist()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def test_quantized_forward_takes_nhwc_only(int8_file):
    _, model, _ = int8_file
    with pytest.raises(ValueError, match="NHWC"):
        tq.forward_sites(model.sites(), torch.zeros(2, 3, 16, 16), model.mcfg)


def test_trainer_evaluate_quantized_on_nchw_raises():
    from resnet_tpu_torch.config import DataConfig, TrainConfig
    from resnet_tpu_torch.train import Trainer

    cfg = TrainConfig(model=tiny_model_config(), execution=ExecutionConfig(layout="NCHW"),
                      data=DataConfig(synthetic=True, batch_size=4), checkpoint_dir="",
                      log_every=0)
    t = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="NHWC"):
        t.evaluate_quantized(t._build_data(), 1)


def test_cli_int8_evaluate(tmp_path, capsys):
    """--evaluate --int8 through the port's CLI (tests/test_quantize.py's
    JAX test): calibration on the first eval batch, metrics printed."""
    from resnet_tpu_torch.train.cli import main

    main(["--model", "tiny", "--synthetic", "--evaluate", "--int8", "--eval-batches", "2",
          "--batch-size", "8", "--no-mesh", "--log-every", "0", "--checkpoint-dir",
          str(tmp_path / "dumps"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "int8 eval over 2 batches" in out
    assert "loss=" in out and "top1=" in out and "top5=" in out


def test_cli_int8_export(tmp_path, capsys):
    from resnet_tpu_torch.train.cli import main

    art = str(tmp_path / "model_int8.pt")
    main(["--model", "tiny", "--synthetic", "--batch-size", "8", "--no-mesh", "--log-every",
          "0", "--checkpoint-dir", str(tmp_path / "dumps"), "--export", art, "--int8",
          "--device", "cpu"])
    assert "exported int8 serving artifact" in capsys.readouterr().out
    served = load_inference(art, device="cpu")
    assert served.kind == "int8" and served.meta["model_config"]["name"] == "resnet-tiny"
    logits = served.call(np.zeros((3, 16, 16, 3), np.float32))
    assert tuple(logits.shape) == (3, 8) and np.isfinite(logits.numpy()).all()
