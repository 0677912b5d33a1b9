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
    got, aux = forward(bridge.params_from_numpy(params), torch.from_numpy(x), tm,
                       tecfg, bn_state=bridge.bn_state_from_numpy(state))
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
    tp, ts = bridge.params_from_numpy(params), bridge.bn_state_from_numpy(state)
    probs = predict(tp, torch.from_numpy(x), tm, bn_state=ts)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2))
    from resnet_tpu.models import predict as j_predict

    want = np.asarray(j_predict(params, x, jm, bn_state=state))
    assert np.abs(probs.numpy() - want).max() <= TOL * np.abs(want).max()
    # bn_mode='off' needs no statistics and matches JAX's diagnostic path
    got, _ = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(bn_mode="off"))
    want, _ = j_forward(params, x, jm, jcfg.ExecutionConfig(bn_mode="off"), train=False)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


def test_eval_needs_running_stats():
    tm = tcfg.tiny_model_config()
    params = bridge.params_from_numpy(
        jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg.tiny_model_config())))
    with pytest.raises(ValueError, match="running statistics"):
        forward(params, torch.zeros(1, 16, 16, 3), tm)
    with pytest.raises(NotImplementedError, match="A2"):
        forward(params, torch.zeros(1, 16, 16, 3), tm, train=True)


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


@pytest.mark.parametrize("kw,item", [
    (dict(kernels="fused"), "A3"),
    (dict(kernels="fusedxla"), "A3"),
    (dict(kernels="hybrid"), "A3"),
    (dict(kernels="blockfused"), "A4"),
    (dict(compute_dtype="bfloat16"), "A5"),
    (dict(layout="NCHW"), "A6"),
    (dict(space_to_depth=True), "A8"),
])
def test_unported_configs_name_their_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        tcfg.ExecutionConfig(**kw)


def test_typos_still_fail_as_value_errors():
    with pytest.raises(ValueError):
        tcfg.ExecutionConfig(kernels="palas")


def test_grouped_conv_only_on_the_plain_path():
    mcfg = tcfg.tiny_model_config(groups=2, width_multiplier=2.0)
    from resnet_tpu_torch.models import init_bn_state, init_params

    gen = torch.Generator().manual_seed(0)
    params, state = init_params(gen, mcfg), init_bn_state(mcfg)
    x = torch.zeros(1, 16, 16, 3)
    logits, _ = forward(params, x, mcfg, tcfg.ExecutionConfig(kernels="pallas"),
                        bn_state=state)
    assert logits.shape == (1, 8)
    with pytest.raises(NotImplementedError, match="A7"):
        forward(params, x, mcfg, tcfg.ExecutionConfig(conv_kernels="pallas"),
                bn_state=state)
