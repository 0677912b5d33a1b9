"""The port's eval forward against resnet_tpu.models.forward(train=False).

Same parameters (JAX init, perturbed BN affine, through the bridge), same
perturbed running statistics, same numpy images. Agreement within 1e-4 of
max|JAX logits| on the CPU in fp32, JAX at 'highest' precision.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.models import forward as j_forward
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.models import forward, predict

TOL = 1e-4


def _perturbed(mcfg, seed):
    """JAX params with gamma/beta moved off (1, 0), and running stats with
    mean ~ N(0, 0.1), var ~ U[0.5, 2], as numpy trees."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), mcfg))
    state = jax.tree.map(np.asarray, j_init_bn_state(mcfg))

    def bn(path, a):
        name = path[-1].key
        if name == "gamma":
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "beta":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(bn, params),
            jax.tree_util.tree_map_with_path(bn, state))


def _compare(jm, tm, *, engine, batch=2, tol=TOL, seed=0):
    params, state = _perturbed(jm, seed)
    x = np.random.default_rng(seed).normal(0, 50, (batch, jm.input_dim, jm.input_dim, 3)
                                           ).astype(np.float32)
    if engine == "pallas":
        jecfg = jcfg.ExecutionConfig(kernels="pallas", conv_kernels="pallas",
                                     pallas_interpret=True)
        tecfg = tcfg.ExecutionConfig(kernels="pallas", conv_kernels="pallas")
    else:
        jecfg, tecfg = jcfg.ExecutionConfig(), tcfg.ExecutionConfig()
    want, _ = j_forward(params, x, jm, jecfg, train=False, bn_state=state)
    want = np.asarray(want)
    got, aux = forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                       tecfg, train=False,
                       bn_state=bridge.bn_state_from_numpy(state, device="cpu"))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= tol * scale, f"max err {err} vs {tol} * {scale}"
    return got, aux, want


TINY = {
    "bottleneck-reference": {},
    "basic-standard": dict(bottleneck=False, expansion=1, stride_projection_kernel=1),
}


@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("variant", sorted(TINY))
def test_tiny_forward_matches_jax(variant, engine):
    kw = TINY[variant]
    got, aux, _ = _compare(jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw),
                           engine=engine, batch=3)
    assert len(aux["bn_stats"]["blocks"]) == 2


def test_resnet50_forward_matches_jax():
    """Full-width ResNet-50 at input 64, batch 2: all 16 blocks, the 7x7/s2
    stem's (3, 2) padding and the 3x3/s2 projections; JAX on XLA."""
    got, _, want = _compare(jcfg.model_config("resnet50", input_dim=64),
                            tcfg.model_config("resnet50", input_dim=64),
                            engine="pallas")
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_predict_and_bn_off():
    jm, tm = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    params, state = _perturbed(jm, 5)
    x = np.random.default_rng(5).normal(0, 50, (2, 16, 16, 3)).astype(np.float32)
    tp = bridge.params_from_numpy(params, device="cpu")
    ts = bridge.bn_state_from_numpy(state, device="cpu")
    probs = predict(tp, torch.from_numpy(x), tm, bn_state=ts)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2))
    from resnet_tpu.models import predict as j_predict

    want = np.asarray(j_predict(params, x, jm, bn_state=state))
    assert np.abs(probs.numpy() - want).max() <= TOL * np.abs(want).max()
    # bn_mode='off' needs no statistics and matches JAX's diagnostic path
    got, _ = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(bn_mode="off"),
                     train=False)
    want, _ = j_forward(params, x, jm, jcfg.ExecutionConfig(bn_mode="off"), train=False)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_eval_needs_running_stats():
    tm = tcfg.tiny_model_config()
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg.tiny_model_config())),
        device="cpu")
    with pytest.raises(ValueError, match="running statistics"):
        forward(params, torch.zeros(1, 16, 16, 3), tm, train=False)
    with pytest.raises(ValueError, match="running statistics"):
        forward(params, torch.zeros(1, 16, 16, 3), tm,
                tcfg.ExecutionConfig(bn_mode="frozen"), train=True)
    # training mode normalizes with the batch statistics and needs none
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 50, (2, 16, 16, 3))
                         .astype(np.float32))
    logits, aux = forward(params, x, tm, train=True)
    mean, var = aux["bn_stats"]["init_bn"]
    assert logits.shape == (2, 8) and torch.isfinite(logits).all()
    assert mean.shape == var.shape == (8,) and (var > 0).all()
    assert not mean.requires_grad


def test_config_fields_mirror_jax():
    dropped = {"pallas_interpret", "scoped_vmem_limit_kib", "grad_accum_unroll"}
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tcfg.ModelConfig) == names(jcfg.ModelConfig)
    assert names(tcfg.ExecutionConfig) == [
        n for n in names(jcfg.ExecutionConfig) if n not in dropped]
    assert not hasattr(tcfg.ExecutionConfig, "jit_compiler_options")
    for name in jcfg.PRESETS:
        assert dataclasses.asdict(tcfg.model_config(name)) == dataclasses.asdict(
            jcfg.model_config(name))
    assert dataclasses.asdict(tcfg.tiny_model_config()) == dataclasses.asdict(
        jcfg.tiny_model_config())


@pytest.mark.parametrize("execution", [dict(kernels="fused"), dict(kernels="hybrid"),
                                       dict(kernels="fusedxla", space_to_depth=True)])
def test_spatial_configs_of_every_engine_equal_jax(execution):
    """spatial_devices=2 with the fused engines (and the s2d stem) builds,
    as in the JAX package, a config equal to JAX's field for field (the
    execution fields the port keeps)."""
    kw = dict(model=tcfg.tiny_model_config(), parallel=tcfg.ParallelConfig(spatial_devices=2))
    ours = dataclasses.asdict(tcfg.TrainConfig(
        execution=tcfg.ExecutionConfig(**execution), **kw))
    theirs = dataclasses.asdict(jcfg.TrainConfig(
        model=jcfg.tiny_model_config(), execution=jcfg.ExecutionConfig(**execution),
        parallel=jcfg.ParallelConfig(spatial_devices=2)))
    ex, jex = ours.pop("execution"), theirs.pop("execution")
    assert ex == {k: jex[k] for k in ex}
    assert ours == theirs


@pytest.mark.parametrize("kernels", ["fused", "fusedxla", "hybrid"])
def test_fused_engines_run_the_standard_path_outside_training(kernels):
    """The fused engines are accepted; outside a batch-statistics training
    forward (eval, bn_mode 'frozen') they run the standard path with plain
    ops, as in the JAX package, so they equal kernels='xla' exactly."""
    jm, tm = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    params, state = _perturbed(jm, 4)
    tp = bridge.params_from_numpy(params, device="cpu")
    ts = bridge.bn_state_from_numpy(state, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 50, (2, 16, 16, 3))
                         .astype(np.float32))
    for train, mode in ((False, "batch"), (True, "frozen")):
        got, _ = forward(tp, x, tm, tcfg.ExecutionConfig(kernels=kernels, bn_mode=mode),
                         train=train, bn_state=ts)
        want, _ = forward(tp, x, tm, tcfg.ExecutionConfig(bn_mode=mode), train=train,
                          bn_state=ts)
        assert torch.equal(got, want)


def test_forward_trains_by_default_as_jax_does():
    """Both packages' forward called with no ``train`` argument: JAX's
    defaults to train=True (resnet_tpu/models/resnet.py:262), so both
    normalize with the batch statistics and need no running statistics;
    logits and every batch statistic within 1e-4 of max|JAX|."""
    import inspect

    assert inspect.signature(forward).parameters["train"].default is True
    assert inspect.signature(j_forward).parameters["train"].default is True
    jm, tm = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    params, _ = _perturbed(jm, 6)
    x = np.random.default_rng(6).normal(0, 50, (3, 16, 16, 3)).astype(np.float32)
    want, jaux = j_forward(params, x, jm, jcfg.ExecutionConfig())
    got, aux = forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                       tcfg.ExecutionConfig())
    for what, a, b in (("logits", got, want), ("bn_stats", aux["bn_stats"], jaux["bn_stats"])):
        pa, pb = bridge.flatten(a), bridge.flatten(b)
        assert [p for p, _ in pa] == [p for p, _ in pb], what
        for (path, g), (_, w) in zip(pa, pb):
            w = np.asarray(w)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= TOL * float(np.abs(w).max()), (what, path, err)


def test_blockfused_is_accepted():
    assert tcfg.ExecutionConfig(kernels="blockfused").kernels == "blockfused"


def test_typos_still_fail_as_value_errors():
    with pytest.raises(ValueError):
        tcfg.ExecutionConfig(kernels="palas")


GROUPED = dict(groups=2, width_multiplier=2.0)


@pytest.mark.parametrize("what", ["forward", "train", "bf16"])
def test_grouped_conv_only_on_the_plain_path(what):
    """The grouped 3x3s (ResNeXt) run the plain conv under every
    conv_kernels, as JAX sends them to XLA; every other conv keeps K1. The
    tiny grouped model under kernels='pallas', conv_kernels='pallas'
    against JAX's (Pallas in interpret mode): the eval forward within 1e-4
    of max|JAX|; one training forward and backward by
    test_train_forward_and_grads_match_jax's rule; and one bf16 Adam step by
    tests/test_torch_nchw.py's (within 2x JAX's own bf16-vs-fp32 gap)."""
    jm, tm = jcfg.tiny_model_config(**GROUPED), tcfg.tiny_model_config(**GROUPED)
    kw = dict(kernels="pallas", conv_kernels="pallas")
    if what == "forward":
        _compare(jm, tm, engine="pallas")
    elif what == "train":
        _train_parity(jm, tm, kw)
    else:
        _bf16_step_parity(jm, tm, kw)


def _bf16_step_parity(jm, tm, kw):
    from resnet_tpu.train.state import init_train_state as j_init_train_state
    from resnet_tpu.train.step import make_train_step as j_make_train_step
    from test_torch_nchw import METRIC_TOL, _gap, _held, _held_trees

    from resnet_tpu_torch.train import make_train_step

    jecfg = jcfg.ExecutionConfig(compute_dtype="bfloat16", pallas_interpret=True, **kw)
    jecfg32 = dataclasses.replace(jecfg, compute_dtype="float32")
    opt = dict(learning_rate=1e-4)
    jc = jcfg.TrainConfig(model=jm, execution=jecfg, optimizer=jcfg.OptimizerConfig(**opt))
    tc = tcfg.TrainConfig(model=tm, execution=tcfg.ExecutionConfig(compute_dtype="bfloat16",
                                                                   **kw),
                          optimizer=tcfg.OptimizerConfig(**opt))
    js0 = jax.device_get(j_init_train_state(jc, jax.random.PRNGKey(11)))
    rng = np.random.default_rng(5)
    batch = {"images": rng.normal(0, 50, (4, 16, 16, 3)).astype(np.float32),
             "labels": rng.integers(0, 8, 4).astype(np.int32)}
    js, jmet = j_make_train_step(jc, donate=False)(js0, batch)
    js32, jmet32 = j_make_train_step(dataclasses.replace(jc, execution=jecfg32),
                                     donate=False)(js0, batch)
    ts, tmet = make_train_step(tc)(bridge.train_state_from_numpy(js0, device="cpu"), batch)
    for k in ("loss", "grad_norm"):
        _held(tmet[k].item(), float(jmet[k]), _gap([float(jmet[k])], [float(jmet32[k])]), k,
              METRIC_TOL)
    lr = opt["learning_rate"]
    for name in ("params", "opt_state", "bn_state"):
        _held_trees(getattr(ts, name), getattr(js, name), getattr(js32, name), name, TOL,
                    2 * lr if name == "params" else 0.0)


@pytest.mark.parametrize("kernels", ["fused", "hybrid", "fusedxla"])
def test_fused_engines_refuse_a_grouped_model_as_jax_does(kernels):
    """JAX's fused engines fail on a grouped model with a ValueError (a
    shape mismatch in their ungrouped convs); the port's raise one that
    names the grouped conv before any conv runs."""
    jm, tm = jcfg.tiny_model_config(**GROUPED), tcfg.tiny_model_config(**GROUPED)
    params, _ = _perturbed(jm, 7)
    x = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(ValueError):
        j_forward(params, x, jm, jcfg.ExecutionConfig(kernels=kernels, pallas_interpret=True))
    with pytest.raises(ValueError, match="grouped conv"):
        forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                tcfg.ExecutionConfig(kernels=kernels))


def _jax_train_grads(params, state, x, labels, jecfg, jm):
    """JAX's summed-CE gradients, logits and bn_stats through
    train/step.py::_loss_fn."""
    from resnet_tpu.train.step import _loss_fn

    cfg = jcfg.TrainConfig(model=jm, execution=jecfg)
    batch = {"images": x, "labels": labels}
    fn = jax.jit(jax.value_and_grad(lambda p, b, s: _loss_fn(p, b, s, cfg), has_aux=True))
    (loss, (logits, aux)), grads = fn(params, batch, state)
    return loss, logits, aux["bn_stats"], grads


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("bn_mode", ["batch", "frozen"])
def test_train_forward_and_grads_match_jax(engine, bn_mode):
    """forward(train=True) on the tiny model: logits, bn_stats and the
    gradients of the summed CE against jax.grad of _loss_fn (Pallas in
    interpret mode for engine 'pallas'). Logits and statistics within 1e-4
    of max|JAX|; every gradient leaf within 1e-4 of its max|JAX| (measured
    ~2e-5 at worst, the BN beta leaves whose gradients nearly cancel)."""
    kw = dict(bn_mode=bn_mode)
    if engine == "pallas":
        kw.update(kernels="pallas", conv_kernels="pallas")
    _train_parity(jcfg.tiny_model_config(), tcfg.tiny_model_config(), kw)


def _train_parity(jm, tm, kw):
    """Summed loss, logits, bn_stats and every gradient leaf of one training
    forward and backward, the port against JAX (Pallas in interpret mode)."""
    from resnet_tpu_torch.train import loss_and_grads

    params, state = _perturbed(jm, 3)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 50, (4, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, 8, 4).astype(np.int32)
    jecfg = jcfg.ExecutionConfig(pallas_interpret=True, **kw)
    tcfg_ = tcfg.TrainConfig(model=tm, execution=tcfg.ExecutionConfig(**kw))
    loss, logits, stats, grads = _jax_train_grads(params, state, x, labels, jecfg, jm)
    got_loss, got_logits, aux, got_grads = loss_and_grads(
        bridge.params_from_numpy(params, device="cpu"),
        {"images": torch.from_numpy(x), "labels": torch.from_numpy(labels)},
        bridge.bn_state_from_numpy(state, device="cpu"), tcfg_)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    for got, want, what in ((got_logits, logits, "logits"),
                            (aux["bn_stats"], stats, "bn_stats"),
                            (got_grads, grads, "grads")):
        a, b = bridge.flatten(got), bridge.flatten(want)
        assert [p for p, _ in a] == [p for p, _ in b], what
        for (path, g), (_, w) in zip(a, b):
            w = np.asarray(w)
            err = float(np.abs(g.detach().numpy() - w).max())
            assert err <= TOL * max(float(np.abs(w).max()), 1e-30), (what, path, err)


# (engine, tiny variant, relu_cap)
FUSED_CASES = [(e, v, None) for e in ("fused", "hybrid", "fusedxla") for v in sorted(TINY)]
FUSED_CASES.append(("fused", "bottleneck-reference", 2.0))


@pytest.mark.parametrize("engine,variant,cap", FUSED_CASES)
def test_fused_engines_match_jax(engine, variant, cap):
    """The fused engines' training forward (models.fused_resnet) on the
    tiny bottleneck and basic-block models, and 'fused' with a cap of 2.0
    that clips the prologues and joins: logits, bn_stats and every gradient
    leaf within 1e-4 of max|JAX| against the JAX package's engine of the
    same name."""
    kw = TINY[variant]
    _train_parity(jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw),
                  dict(kernels=engine, relu_cap=cap))


def _count_block_fused(monkeypatch, module):
    """Count the calls of ``module.block_fused`` (which the model imports
    when it routes a block there)."""
    calls = []
    real = module.block_fused

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(module, "block_fused", counted)
    return calls


# name -> (tiny-model overrides, blocks the JAX package routes to block_fused)
BLOCKFUSED_MODELS = {
    # 4C = 128 and 256: JAX routes blocks 1 and 3 to its kernel too
    "width-32": (dict(init_filters=32, block_sizes=(2, 2)), 2),
    # 4C = 32 and 64: JAX falls back to its per-op path (its Mosaic-only
    # lane test), the port still takes K10's plain version
    "width-8": (dict(block_sizes=(2, 2)), 0),
}


@pytest.mark.parametrize("cap", [None, 2.0])
@pytest.mark.parametrize("model", sorted(BLOCKFUSED_MODELS))
def test_blockfused_engine_matches_jax(monkeypatch, model, cap):
    """kernels='blockfused' on a tiny model with two identity blocks (1 and
    3): the port sends exactly those to block_fused, and its summed loss,
    logits, bn_stats and every gradient leaf agree with the JAX package's
    engine of the same name within 1e-4 of max|JAX|."""
    import resnet_tpu.kernels.block_fused as jbf

    import resnet_tpu_torch.kernels.block_fused as tbf

    kw, jax_routed = BLOCKFUSED_MODELS[model]
    ours, theirs = _count_block_fused(monkeypatch, tbf), _count_block_fused(monkeypatch, jbf)
    _train_parity(jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw),
                  dict(kernels="blockfused", relu_cap=cap))
    c4 = 4 * kw.get("init_filters", 8)
    assert [s[-1] for s in ours] == [c4, 2 * c4]
    assert len(theirs) == jax_routed


def test_blockfused_runs_the_standard_path_outside_batch_training(monkeypatch):
    """Eval, bn_mode 'frozen' and 'off' take the standard path with plain
    ops, never block_fused, so they equal kernels='xla' exactly."""
    import resnet_tpu_torch.kernels.block_fused as tbf

    kw = dict(block_sizes=(2, 2))
    jm, tm = jcfg.tiny_model_config(**kw), tcfg.tiny_model_config(**kw)
    params, state = _perturbed(jm, 7)
    tp = bridge.params_from_numpy(params, device="cpu")
    ts = bridge.bn_state_from_numpy(state, device="cpu")
    x = torch.from_numpy(np.random.default_rng(7).normal(0, 50, (2, 16, 16, 3))
                         .astype(np.float32))
    calls = _count_block_fused(monkeypatch, tbf)
    for train, mode in ((False, "batch"), (True, "frozen"), (True, "off")):
        got, _ = forward(tp, x, tm, tcfg.ExecutionConfig(kernels="blockfused", bn_mode=mode),
                         train=train, bn_state=ts)
        want, _ = forward(tp, x, tm, tcfg.ExecutionConfig(bn_mode=mode), train=train,
                          bn_state=ts)
        assert torch.equal(got, want)
    assert calls == []


@pytest.mark.parametrize("kw", [dict(remat="block"), dict(bn_stats_batch=2)],
                         ids=["remat", "ghost_bn"])
def test_remat_and_ghost_bn_train_like_jax(kw):
    """Remat and ghost BN, which the port once refused, in a training
    forward and backward on the tiny model with every hand kernel's plain
    version: logits, bn_stats and every gradient leaf within 1e-4 of
    max|JAX| (tests/test_torch_remat.py and tests/test_torch_ghost_bn.py
    hold each further); TrainConfig takes both."""
    kw = dict(kw, kernels="pallas", conv_kernels="pallas")
    _train_parity(jcfg.tiny_model_config(), tcfg.tiny_model_config(), kw)
    assert tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                            execution=tcfg.ExecutionConfig(**kw)).execution == \
        tcfg.ExecutionConfig(**kw)
