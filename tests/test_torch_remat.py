"""Remat (``ExecutionConfig.remat``) in the port against its no-remat path
and the JAX package on the CPU.

Gradients of the summed CE under 'block', 'stage' and 'elementwise' on the
tiny model with every hand kernel's plain version (``kernels='pallas'``,
``conv_kernels='pallas'``) and on ``tiny_model_config(init_filters=32,
block_sizes=(2, 2))`` under ``kernels='blockfused'``: against the port's
no-remat gradients within rtol 1e-5 / atol 1e-6 (tests/test_model.py:121-136),
and against JAX's gradients under the same remat within 1e-4 of each leaf's
max|JAX| (the repo's training-parity tolerance, tests/test_torch_model.py).
The fused engines ignore remat as JAX's do. The plain versions' calls show
what the backward reruns; the rerun keeps the config's precision; the
``clean`` and ``lowmem`` training steps equal their no-remat steps and
match JAX's, with and without grad_accum=2.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_train import _compare

from resnet_tpu import config as jcfg
from resnet_tpu.data.synthetic import SyntheticDataset as JSynthetic
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import _loss_fn
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import SyntheticDataset
from resnet_tpu_torch.kernels import block_fused, bn, conv, fused
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.train import loss_and_grads, make_train_step

REMATS = ("block", "stage", "elementwise")
# name -> (tiny-model overrides, execution fields)
MODELS = {
    "pallas": ({}, dict(kernels="pallas", conv_kernels="pallas")),
    "blockfused": (dict(init_filters=32, block_sizes=(2, 2)), dict(kernels="blockfused")),
}


def _setup(model, seed=3):
    kw, ex = MODELS[model]
    jm = jcfg.tiny_model_config(**kw)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), jm))
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 50, (4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 8, 4).astype(np.int32)
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    return jm, tcfg.tiny_model_config(**kw), ex, params, batch


def _port(tm, ex, params, batch, remat):
    cfg = tcfg.TrainConfig(model=tm, execution=tcfg.ExecutionConfig(remat=remat, **ex))
    return loss_and_grads(bridge.params_from_numpy(params, device="cpu"), batch, None, cfg)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_gradients_match_no_remat_and_jax(model, remat):
    jm, tm, ex, params, batch = _setup(model)
    loss, logits, aux, grads = _port(tm, ex, params, batch, remat)
    loss0, logits0, aux0, grads0 = _port(tm, ex, params, batch, "none")
    assert loss.item() == loss0.item() and torch.equal(logits, logits0)
    # the statistics once each, as the no-remat forward gives them
    for (p, a), (_, b) in zip(bridge.flatten(aux["bn_stats"]),
                              bridge.flatten(aux0["bn_stats"]), strict=True):
        assert torch.equal(a, b), p
    for (p, a), (_, b) in zip(bridge.flatten(grads), bridge.flatten(grads0), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=p)

    jc = jcfg.TrainConfig(model=jm, execution=jcfg.ExecutionConfig(remat=remat, **ex))
    jbatch = {k: v.numpy() for k, v in batch.items()}
    fn = jax.jit(jax.value_and_grad(lambda p: _loss_fn(p, jbatch, None, jc), has_aux=True))
    (jloss, _), jgrads = fn(params)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    a, b = bridge.flatten(grads), bridge.flatten(jgrads)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, g), (_, w) in zip(a, b):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (path, err)


@pytest.mark.parametrize("kernels", ["fused", "hybrid", "fusedxla"])
def test_fused_engines_ignore_remat(kernels):
    """JAX's fused engines return before remat is applied
    (models/resnet.py:275-288); so do the port's: every remat gives the
    no-remat logits and gradients bit for bit."""
    _, tm, _, params, batch = _setup("pallas")
    ex = dict(kernels=kernels)
    _, logits0, _, grads0 = _port(tm, ex, params, batch, "none")
    for remat in REMATS:
        _, logits, _, grads = _port(tm, ex, params, batch, remat)
        assert torch.equal(logits, logits0), remat
        for (p, a), (_, b) in zip(bridge.flatten(grads), bridge.flatten(grads0)):
            assert torch.equal(a, b), (remat, p)


def _count(monkeypatch, module, name, counts):
    real = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


# per remat: calls of each plain version in one forward and backward of the
# tiny model (stem + 2 blocks: 9 convs, the first a projection) under
# 'pallas', and of K10's on the width-32 model (two identity blocks)
RERUNS = {
    "none": {"conv2d_reference": 9, "conv2d_dx_reference": 8, "conv2d_dw_reference": 9,
             "moments_reference": 9, "add_relu_reference": 2,
             "add_relu_mask_reference": 2, "block_fused_reference": 2},
    # the backward reruns each block: 8 convs, 8 statistics, 2 joins, K10
    "block": {"conv2d_reference": 17, "conv2d_dx_reference": 8, "conv2d_dw_reference": 9,
              "moments_reference": 17, "add_relu_reference": 4,
              "add_relu_mask_reference": 2, "block_fused_reference": 4},
    # the convs and statistics are kept; the joins and K10 rerun
    "elementwise": {"conv2d_reference": 9, "conv2d_dx_reference": 8,
                    "conv2d_dw_reference": 9, "moments_reference": 9,
                    "add_relu_reference": 4, "add_relu_mask_reference": 2,
                    "block_fused_reference": 4},
}
RERUNS["stage"] = RERUNS["block"]


@pytest.mark.parametrize("remat", ["none", *REMATS])
def test_remat_reruns_what_its_policy_drops(monkeypatch, remat):
    """The kernels' plain versions stand for the kernels on the CPU: a rerun
    in the backward calls them again, as it launches the kernels on the
    card (chip_smoke.py's remat_train phase holds the counters to the same
    design at ResNet-50)."""
    counts = {}
    for module, name in ((conv, "conv2d_reference"), (conv, "conv2d_dx_reference"),
                         (conv, "conv2d_dw_reference"), (bn, "moments_reference"),
                         (fused, "add_relu_reference"), (fused, "add_relu_mask_reference"),
                         (block_fused, "block_fused_reference")):
        _count(monkeypatch, module, name, counts)
    _port(*_setup("pallas")[1:], remat)
    blockfused = counts.pop("block_fused_reference", 0)
    pallas = dict(counts)
    counts.clear()
    _port(*_setup("blockfused")[1:], remat)
    want = dict(RERUNS[remat])
    assert blockfused == 0 and counts["block_fused_reference"] == want.pop(
        "block_fused_reference")
    assert pallas == want


@pytest.mark.parametrize("remat", REMATS)
def test_recompute_keeps_the_configs_precision(monkeypatch, remat):
    """A backward run outside forward's precision scope, with the caller's
    TF32 flags on: the rerun's plain convs still see them off
    (matmul_precision='highest'), and the caller's flags are back after."""
    seen = []
    real = conv.conv2d_reference

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(conv, "conv2d_reference", spy)
    _, tm, ex, params, batch = _setup("pallas")
    tp = bridge.params_from_numpy(params, device="cpu")
    w = tp["blocks"][0]["reduce"]["w"].requires_grad_(True)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        logits, _ = forward(tp, batch["images"], tm, tcfg.ExecutionConfig(remat=remat, **ex))
        n_forward = len(seen)
        logits.sum().backward()
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert w.grad is not None and flags == (True, True)
    assert len(seen) == n_forward + (0 if remat == "elementwise" else 8)
    assert not any(seen)


def _variant(pkg, variant, accum, remat=None):
    cfg = pkg.variant_config(variant)
    return dataclasses.replace(
        cfg, model=pkg.tiny_model_config(),
        execution=dataclasses.replace(cfg.execution, grad_accum=accum,
                                      remat=remat or cfg.execution.remat))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("variant", ["clean", "lowmem"])
def test_clean_and_lowmem_steps_match_jax(variant, accum):
    """train_step of the tiny model under the clean (kernels='pallas', block
    remat, Adam lr 1e-4) and lowmem (plain, block remat, Adam lr 1e-3)
    presets, one bridged state and one batch, three steps: every state the
    remat step makes equals the no-remat step's bit for bit, and everything
    the step produces is held to JAX's by test_torch_train's rules after
    steps 1 and 3 (lowmem after step 1 only: at lr 1e-3 the Adam updates
    that flip with a gradient's last bits, within the rule's 2 * lr per
    step, move the third step's running statistics past its 1e-4 in both
    packages, with remat or without: 1.24e-4 of max at blocks/0/bn_reduce/
    mean)."""
    jc, tc = _variant(jcfg, variant, accum), _variant(tcfg, variant, accum)
    assert tc.execution.remat == jc.execution.remat == "block"
    js = j_init_train_state(jc, jax.random.PRNGKey(11))
    ts = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    plain_state = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    p0 = jax.tree.map(np.asarray, js.params)
    batch = next(SyntheticDataset(4, image_dim=16, num_classes=8, seed=5))
    jbatch = next(JSynthetic(4, image_dim=16, num_classes=8, seed=5))
    jstep, tstep = j_make_train_step(jc, donate=False), make_train_step(tc)
    plain_step = make_train_step(_variant(tcfg, variant, accum, remat="none"))
    for step in range(1, 4):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, batch)
        plain_state, pm = plain_step(plain_state, batch)
        for (p, a), (_, b) in zip(bridge.flatten(bridge.to_numpy(ts)._asdict()),
                                  bridge.flatten(bridge.to_numpy(plain_state)._asdict()),
                                  strict=True):
            np.testing.assert_array_equal(a, b, err_msg=p)
        assert all(tm[k].item() == pm[k].item() for k in tm)
        if step == 1 or (step == 3 and variant == "clean"):
            _compare(ts, tm, js, jm, tc, step, p0)
