"""The activation tape, the analysis harness and the utils of the port
against the JAX package on the CPU.

``forward(..., capture=True)``: the same keys as JAX's tape and values
within rtol 1e-4 / atol 1e-4 (logits 1e-5), in training and eval mode and
with the naive softmax; against tests/golden/tiny_forward_golden.npz as
tests/test_golden.py holds JAX's; the tape turns off the fused route, the
whole-block kernel and remat. ``dump_activations`` -> ``load_activation_dump``
-> ``crosscheck_dump`` as tests/test_analysis.py runs JAX's, and the dump
files equal JAX's. ``check_state_finite``, ``nonfinite_report``,
``MetricsLogger`` and ``inspect_input`` against JAX's; the profiling
helpers run on the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.analysis import dump_activations as j_dump_activations
from resnet_tpu.analysis.inspect_input import unnormalize as j_unnormalize
from resnet_tpu.models import forward as j_forward
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu.utils import MetricsLogger as JMetricsLogger
from resnet_tpu.utils import nonfinite_report as j_nonfinite_report
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.analysis import (
    activation_ranges,
    crosscheck_dump,
    dump_activations,
    load_activation_dump,
    scan_divergence,
)
from resnet_tpu_torch.analysis.reference_numpy import forward_reference_numpy
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.utils import (
    MetricsLogger,
    check_state_finite,
    debug_print_tensor,
    nonfinite_report,
    trace_context,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_forward_golden.npz")


def _flat(tape, pre=""):
    out = {}
    for k, v in tape.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _tiny(seed=0, **kw):
    jm = jcfg.tiny_model_config(**kw)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), jm))
    state = jax.tree.map(np.asarray, j_init_bn_state(jm))
    x = np.random.default_rng(seed).normal(0, 50, (2, 16, 16, 3)).astype(np.float32)
    return jm, tcfg.tiny_model_config(**kw), params, state, x


@pytest.mark.parametrize("train,stable", [(True, True), (False, True), (True, False)],
                         ids=["train", "eval", "naive-softmax"])
def test_capture_tape_matches_jax(train, stable):
    jm, tm, params, state, x = _tiny()
    want_logits, jaux = j_forward(params, x, jm, jcfg.ExecutionConfig(stable_softmax=stable),
                                  train=train, bn_state=state, capture=True)
    logits, aux = forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x),
                          tm, tcfg.ExecutionConfig(stable_softmax=stable), train=train,
                          bn_state=bridge.bn_state_from_numpy(state, device="cpu"),
                          capture=True)
    want, got = _flat(jaux["activations"]), _flat(aux["activations"])
    assert set(got) == set(want)
    assert "block_00/transformed_residual" in got and "pred" in got
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


def test_capture_matches_golden():
    """The port's tape from the JAX init at seed 1234 against the committed
    golden file, as tests/test_golden.py holds the JAX package's."""
    with np.load(GOLDEN) as g:
        golden = {k: g[k] for k in g.files}
    mcfg = tcfg.tiny_model_config()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1234),
                                                    jcfg.tiny_model_config()))
    logits, aux = forward(bridge.params_from_numpy(params, device="cpu"),
                          torch.from_numpy(golden["input"]), mcfg, tcfg.ExecutionConfig(),
                          train=True, capture=True)
    np.testing.assert_allclose(logits.numpy(), golden["logits"], rtol=1e-5, atol=1e-5)
    flat = {"act/" + k: v for k, v in _flat(aux["activations"]).items()}
    assert set(flat) == {k for k in golden if k.startswith("act/")}
    for k, v in flat.items():
        np.testing.assert_allclose(v, golden[k], rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("ex", [dict(kernels="fused"), dict(remat="block"),
                                dict(kernels="blockfused")],
                         ids=["fused", "remat", "blockfused"])
def test_capture_takes_the_taped_path(ex):
    """With the tape the fused route, the whole-block kernel and remat are
    off (JAX models/resnet.py:126, :278, :331): the tape and logits equal
    kernels='xla' exactly."""
    kw = dict(init_filters=32, block_sizes=(2, 2)) if ex.get("kernels") == "blockfused" else {}
    _, tm, params, _, x = _tiny(1, **kw)
    tp = bridge.params_from_numpy(params, device="cpu")
    got, gaux = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(**ex), capture=True)
    want, waux = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(), capture=True)
    assert torch.equal(got, want)
    g, w = _flat(gaux["activations"]), _flat(waux["activations"])
    assert set(g) == set(w) and len(g) > 10
    assert all(np.array_equal(g[k], w[k]) for k in w)


def test_capture_matches_the_numpy_oracle():
    """The tape's head against the copied numpy transliteration of the
    reference (analysis/reference_numpy.py) in the reference's fp32 with the
    naive softmax."""
    jm, tm, params, _, x = _tiny(2)
    tp = bridge.params_from_numpy(params, device="cpu")
    logits, aux = forward(tp, torch.from_numpy(x), tm,
                          tcfg.ExecutionConfig(stable_softmax=False), capture=True)
    want_logits, _, oracle = forward_reference_numpy(params, x, tm, capture=True)
    got = _flat(aux["activations"])
    pairs = [("init_conv_activated", "init_conv_activated"),
             ("init_convblock_input", "max_pooled"),
             ("block_01/output_activated", "block_1_output_activated"),
             ("final_avg_pool", "final_avg_pool"), ("linear_output", "linear_output"),
             ("pred", "pred")]
    for ours, theirs in pairs:
        np.testing.assert_allclose(got[ours], oracle[theirs], rtol=1e-4, atol=1e-4,
                                   err_msg=ours)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """The tiny model's dump from the port and from JAX, same params and
    images (tests/test_analysis.py's fixture)."""
    rng = np.random.default_rng(0)
    jm = jcfg.tiny_model_config()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jm))
    images = rng.normal(0, 50, (2, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 8, (2,)).astype(np.int32)
    d = str(tmp_path_factory.mktemp("dump"))
    jd = str(tmp_path_factory.mktemp("jax_dump"))
    tape = dump_activations(d, bridge.params_from_numpy(params, device="cpu"), images,
                            tcfg.tiny_model_config(), tcfg.ExecutionConfig())
    j_dump_activations(jd, params, images, jm, jcfg.ExecutionConfig())
    return d, jd, params, tape, labels


def test_dump_roundtrip_and_crosscheck(dumped):
    d, _, params, tape, labels = dumped
    loaded = load_activation_dump(d)
    assert set(loaded) == set(tape)
    for k in tape:
        np.testing.assert_array_equal(loaded[k], tape[k].astype(np.float32), err_msg=k)
    assert loaded["init_conv_applied"].shape[1] == 8 and loaded["init_convblock_input"].shape[1] == 4
    errs = crosscheck_dump(d, params["fc"]["w"], labels)
    assert errs["fc_forward"] < 1e-4 and errs["softmax"] < 1e-5
    assert errs["global_avg_pool"] < 1e-4
    assert [r[0] for r in activation_ranges(d)] == sorted(tape)
    assert scan_divergence([d], threshold=1e9) == []


def test_dump_files_match_jax(dumped):
    """The same manifest (names, files, shapes) as the JAX package's dump
    and every buffer within rtol 1e-4 / atol 1e-4."""
    d, jd, *_ = dumped
    with open(os.path.join(d, "manifest.json")) as f, open(os.path.join(jd, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    ours, theirs = load_activation_dump(d), load_activation_dump(jd)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, atol=1e-4, err_msg=k)


def _bad_tree():
    tree = {"params": {"w": np.array([1.0, np.nan, np.inf], np.float32),
                       "b": [np.zeros(3, np.float32), np.array([-np.inf], np.float32)]},
            "step": np.array(3, np.int32)}
    return tree


def test_state_checks_match_jax():
    tree = _bad_tree()
    ttree = bridge.params_from_numpy(tree, device="cpu")
    assert not bool(check_state_finite(ttree))
    assert nonfinite_report(ttree) == j_nonfinite_report(tree)
    assert nonfinite_report(ttree) == ["params/b/1: 0 NaN, 1 Inf of 1",
                                       "params/w: 1 NaN, 1 Inf of 3"]
    clean = bridge.params_from_numpy({"a": np.ones(2, np.float32), "n": np.array(1)},
                                     device="cpu")
    assert bool(check_state_finite(clean)) and nonfinite_report(clean) == []
    # a training state: NamedTuple fields as JAX names them
    from resnet_tpu_torch.train import init_train_state

    state = init_train_state(tcfg.TrainConfig(model=tcfg.tiny_model_config()), device="cpu")
    assert bool(check_state_finite(state))
    state.params["fc"]["w"][0, 0] = float("nan")
    n = state.params["fc"]["w"].numel()
    assert nonfinite_report(state) == [f".params/fc/w: 1 NaN, 0 Inf of {n}"]
    assert nonfinite_report(state) == j_nonfinite_report(bridge.to_numpy(state))


def test_debug_print_tensor(monkeypatch, capsys):
    from resnet_tpu_torch.utils import debug

    debug_print_tensor("x", torch.arange(4.0))
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(debug, "DEBUG_PRINT", True)
    debug_print_tensor("x", torch.arange(12.0).reshape(3, 4), n=3)
    assert capsys.readouterr().out == "x shape=(3, 4) min=0.0 max=11.0 head=[0.0, 1.0, 2.0]\n"


def test_metrics_logger_writes_jaxs_lines(tmp_path, capsys):
    """The same loss log, the same JSONL records (but the clock's) and the
    same printed lines as the JAX package's logger, fed tensors here and
    numpy there."""
    steps = [{"loss": 2.5, "accuracy": 0.25, "grad_norm": 1.5},
             {"loss": 2.25, "accuracy": 0.5, "grad_norm": 1.25}]
    outs = {}
    for name, cls, conv in (("torch", MetricsLogger, torch.tensor),
                            ("jax", JMetricsLogger, np.float32)):
        log = cls(str(tmp_path / name), print_every=1)
        for i, m in enumerate(steps):
            log.log_step(i, {k: conv(v) for k, v in m.items()}, epoch=0)
        summary = log.epoch_summary(0, 2)
        log.close()
        with open(tmp_path / name / "avg_loss_log.txt") as f:
            losses = f.read()
        with open(tmp_path / name / "metrics.jsonl") as f:
            recs = [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]
        outs[name] = (losses, recs, summary, capsys.readouterr().out)
    assert outs["torch"] == outs["jax"]


def test_profiling_helpers_run_on_the_cpu(tmp_path):
    from resnet_tpu_torch.utils.profiling import build_op_table, time_fn, time_grad_fn

    x = torch.ones(64, 64)
    assert time_fn(torch.mm, (x, x), iters=4, repeats=1) > 0
    assert time_grad_fn(lambda a, b: a @ b, (x, x), iters=4, repeats=1) > 0
    table = build_op_table(batch=1, device="cpu", ops_filter="fc_|softmax|avgpool", iters=4)
    assert set(table) == {"fc_2048x1000", "softmax_ce", "avgpool_7x2048"}
    assert all(v["ms_fwd"] > 0 and v["ms_fwd_bwd"] > 0 for v in table.values())
    with trace_context(str(tmp_path / "trace")) as prof:
        torch.ones(3) + 1
    assert prof is not None and os.path.isfile(tmp_path / "trace" / "trace.json")
    with trace_context() as prof:
        assert prof is None


def test_inspect_input_matches_jax_and_names_the_shard_item(tmp_path, capsys):
    from resnet_tpu_torch.analysis import inspect_input
    from resnet_tpu_torch.data import write_shard

    images = np.random.default_rng(0).normal(0, 80, (2, 3, 4, 4)).astype(np.float32)
    for layout, x in (("NCHW", images), ("NHWC", images.transpose(0, 2, 3, 1))):
        np.testing.assert_array_equal(inspect_input.unnormalize(x, layout),
                                      j_unnormalize(x, layout))
    # the shard reader is ported: main reads a write_shard shard (224^2, NCHW)
    shards = np.random.default_rng(1).normal(0, 60, (2, 3, 224, 224)).astype(np.float32)
    write_shard(str(tmp_path), 0, shards, np.array([3, 5], np.int32))
    out = str(tmp_path / "batch.png")
    inspect_input.main(["--shard-dir", str(tmp_path), "--n", "2", "--out", out])
    assert os.path.getsize(out) > 0
    assert f"wrote {out}" in capsys.readouterr().out
