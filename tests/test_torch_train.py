"""The port's training step against resnet_tpu.train.step on the CPU.

One bridged state (the JAX init through ``bridge.train_state_from_numpy``),
one synthetic batch from the same seed, then three train steps in each
package; everything the step produces is compared after the first and after
the third: metrics, parameters, optimizer state, BN running statistics and
the step. Tiny model, batch 4, each JAX step jitted once.

Tolerances, per leaf, of that leaf's max|JAX|: 1e-4 for gradients' images
(Adam m and v, the SGD momentum, running statistics), 1e-5 for the metrics.
Adam parameters are held to 2 * lr per step instead: the first steps move
each weight by about lr * sign(g), so a gradient near 0 whose sign differs
in the last bits flips its update by 2 * lr (measured 6e-5 after three
steps at lr 1e-4, at the stem BN's beta); SGD parameters to 1e-4. As that
bound is as large as the update itself, the Adam updates p - p0 are also
held element by element to lr / 100 plus 4 ulp of p0: at most
UPDATE_SHARE of all elements may differ by more (a kernel that never
wrote p would miss nearly all of them).
"""

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.data.synthetic import SyntheticDataset as JSynthetic
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_eval_step as j_make_eval_step
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import SyntheticDataset
from resnet_tpu_torch.train import eval_step, init_train_state, make_train_step

TOL = 1e-4
METRIC_TOL = 1e-5
UPDATE_SHARE = 1e-3  # measured at most 2.0e-4: 5 of 24,648 elements
KERNELS = dict(kernels="pallas", conv_kernels="pallas")

# name -> (JAX execution, port execution, optimizer fields[, tiny-model fields])
CASES = {
    "adam-no_bn-cosine": (dict(), KERNELS, dict(
        weight_decay=1e-3, wd_mask="no_bn", schedule="cosine", total_steps=10)),
    "fused-adam": (dict(KERNELS, pallas_interpret=True), KERNELS, dict(
        fused=True, weight_decay=1e-3)),
    "sgd-step": (dict(), KERNELS, dict(
        name="sgd", learning_rate=0.05, weight_decay=1e-3, schedule="step",
        total_steps=4)),
    "grad_accum-2": (dict(grad_accum=2), dict(KERNELS, grad_accum=2), dict()),
    # the fused engine, with fused Adam as chip_smoke.py runs it, and with
    # grad_accum: its bn_stats merge into the running statistics per
    # microbatch
    "fused-engine": (dict(kernels="fused", pallas_interpret=True), dict(kernels="fused"),
                     dict(fused=True)),
    "fused-engine-grad_accum-2": (dict(kernels="fused", pallas_interpret=True, grad_accum=2),
                                  dict(kernels="fused", grad_accum=2), dict()),
    # the whole-block engine with fused Adam, as chip_smoke.py runs it, on a
    # model whose blocks 1 and 3 are identity blocks 128 and 256 wide, so
    # that the JAX package routes them to its kernel too
    "blockfused-engine": (dict(kernels="blockfused", pallas_interpret=True),
                          dict(kernels="blockfused"), dict(fused=True),
                          dict(init_filters=32, block_sizes=(2, 2))),
}


def _configs(name):
    jex, tex, opt, *model = CASES[name]
    model = model[0] if model else {}
    jc = jcfg.TrainConfig(model=jcfg.tiny_model_config(**model),
                          execution=jcfg.ExecutionConfig(**jex),
                          optimizer=jcfg.OptimizerConfig(**opt))
    tc = tcfg.TrainConfig(model=tcfg.tiny_model_config(**model),
                          execution=tcfg.ExecutionConfig(**tex),
                          optimizer=tcfg.OptimizerConfig(**opt))
    return jc, tc


def _close_trees(got, want, what, tol):
    a, b = bridge.flatten(bridge.to_numpy(got)), bridge.flatten(
        jax.tree.map(np.asarray, want))
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        scale = max(float(np.abs(y).max()), 1e-30)
        err = float(np.abs(x - y).max())
        limit = tol(scale) if callable(tol) else tol * scale
        assert err <= limit, f"{what} {path}: {err} > {limit}"


def _update_share(got, want, p0, lr):
    """The share of all parameter elements whose update from p0 differs
    from the JAX package's by more than lr / 100 + 4 ulp of p0."""
    a, b = bridge.leaves(bridge.to_numpy(got)), bridge.leaves(jax.tree.map(np.asarray, want))
    bad = total = 0
    for x, y, z in zip(a, b, bridge.leaves(p0), strict=True):
        limit = lr / 100 + 4 * np.finfo(np.float32).eps * np.abs(z)
        bad += int(np.count_nonzero(np.abs((x - z) - (y - z)) > limit))
        total += z.size
    return bad / total


def _compare(ts, tm, js, jm, cfg, steps, p0):
    for k in ("loss", "loss_sum", "accuracy", "learning_rate", "grad_norm"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=METRIC_TOL,
                                   atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == steps
    ocfg = cfg.optimizer
    if ocfg.name == "adam":
        lr = ocfg.learning_rate
        _close_trees(ts.params, js.params, "params",
                     lambda s: TOL * s + 2 * lr * steps)
        share = _update_share(ts.params, js.params, p0, lr)
        assert share <= UPDATE_SHARE, f"{share} of the Adam updates differ"
        _close_trees(ts.opt_state.means, js.opt_state.means, "m", TOL)
        _close_trees(ts.opt_state.vars, js.opt_state.vars, "v", TOL)
        for k in ("mean_decay_prod", "var_decay_prod"):
            assert getattr(ts.opt_state, k).item() == float(getattr(js.opt_state, k))
    else:
        _close_trees(ts.params, js.params, "params", TOL)
        _close_trees(ts.opt_state.momentum_buf, js.opt_state.momentum_buf, "momentum",
                     TOL)
    assert int(ts.opt_state.step) == int(js.opt_state.step) == steps
    _close_trees(ts.bn_state, js.bn_state, "bn_state", TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_jax(name):
    jc, tc = _configs(name)
    js = j_init_train_state(jc, jax.random.PRNGKey(11))
    ts = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    p0 = jax.tree.map(np.asarray, js.params)
    batch = next(SyntheticDataset(4, image_dim=16, num_classes=8, seed=5))
    jbatch = next(JSynthetic(4, image_dim=16, num_classes=8, seed=5))
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    jstep, tstep = j_make_train_step(jc, donate=False), make_train_step(tc)
    for step in range(1, 4):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, batch)
        if step in (1, 3):
            _compare(ts, tm, js, jm, tc, step, p0)
    if name == "adam-no_bn-cosine":
        want = j_make_eval_step(jc)(js, jbatch)
        got = eval_step(ts, batch, tc)
        for k in ("loss", "accuracy", "top5"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=METRIC_TOL,
                                       err_msg=k)


def test_init_train_state_defaults_to_the_card():
    import inspect

    assert inspect.signature(init_train_state).parameters["device"].default == "cuda"
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config())
    state = init_train_state(cfg, device="cpu")
    again = init_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device="cpu")
    for (p, a), (_, b) in zip(bridge.flatten(state.params), bridge.flatten(again.params)):
        assert torch.equal(a, b), p
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert state.opt_state.mean_decay_prod.dtype == torch.float32


def test_grad_accum_rejects_a_ragged_batch():
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                           execution=tcfg.ExecutionConfig(grad_accum=3))
    state = init_train_state(cfg, device="cpu")
    batch = next(SyntheticDataset(4, image_dim=16, num_classes=8))
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(cfg)(state, batch)
