"""The space-to-depth stem (``ExecutionConfig.space_to_depth``,
resnet_tpu_torch/ops/space_to_depth.py) against the JAX package on the CPU.

* The two folds only move data: ``space_to_depth`` and ``s2d_stem_weights``
  equal JAX's bit for bit.
* ``s2d_stem_conv`` (the same 4x4/s1 conv over 12 channels on both sides,
  summed in XLA's and torch's orders) within 1e-5 of max|JAX| in fp32.
* The tiny model with a 7x7 stem (``tiny_model_config(init_kernel=7)``,
  JAX's own s2d test model, tests/test_model.py:160-183) with s2d on: one
  eval forward and one Adam step from one bridged state, on the plain ops
  and on the hand kernels (their plain versions here, JAX's Pallas in
  interpret mode), in fp32 and bf16, held as tests/test_torch_nchw.py holds
  its runs: fp32 within 1e-4 of max|JAX| (parameters also 2 lr), bf16
  within 2x JAX's own gap between its bf16 and fp32 runs plus 1e-5.
* The s2d stem against the port's standard stem within JAX's own
  tolerances for the two (rtol 1e-4 on the logits, 1e-3 on the gradients:
  the sums are reassociated).
* Where JAX keeps the standard stem (NCHW, a 3x3 stem, the fused engines'
  training forward) the port's logits with s2d on equal its logits with
  s2d off bit for bit, and JAX's with s2d on within 1e-4; an odd H raises
  ValueError in both, from the standard stem's geometry. Remat reruns the
  blocks and not the stem: its gradients equal the no-remat step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import _perturbed
from test_torch_nchw import METRIC_TOL, TOL, _gap, _held, _held_trees

from resnet_tpu import config as jcfg
from resnet_tpu.models import forward as j_forward
from resnet_tpu.ops import space_to_depth as jsd
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.ops import space_to_depth as tsd
from resnet_tpu_torch.train import loss_and_grads, make_train_step

STEM_TOL = 1e-5
STEM_LOGIT_RTOL, STEM_GRAD_RTOL = 1e-4, 1e-3  # tests/test_model.py:172, :183


def _models(**over):
    return jcfg.tiny_model_config(init_kernel=7, **over), tcfg.tiny_model_config(
        init_kernel=7, **over)


def _images(seed, n, d=16, layout="NHWC"):
    x = np.random.default_rng(seed).normal(0, 50, (n, d, d, 3)).astype(np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if layout == "NCHW" else x


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 224, 224, 3), (3, 6, 10, 5)])
def test_folds_are_jax_bit_for_bit(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    got = tsd.space_to_depth(torch.from_numpy(x))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 4 * shape[3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsd.space_to_depth(jnp.asarray(x))))
    w = rng.normal(size=(7, 7, shape[3], 8)).astype(np.float32)
    ws = tsd.s2d_stem_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jsd.s2d_stem_weights(jnp.asarray(w))))
    assert ws.shape == (4, 4, 4 * shape[3], 8) and not ws[0, :, :2 * shape[3]].any()


def test_folds_refuse_what_jax_asserts():
    with pytest.raises(ValueError):
        tsd.space_to_depth(torch.zeros(1, 15, 16, 3))
    with pytest.raises(ValueError):
        tsd.s2d_stem_weights(torch.zeros(3, 3, 3, 8))


@pytest.mark.parametrize("d", [16, 32])
def test_stem_conv_matches_jax(d):
    rng = np.random.default_rng(d)
    x = rng.normal(0, 50, (2, d, d, 3)).astype(np.float32)
    w = rng.normal(0, 0.1, (7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(jsd.s2d_stem_conv(jnp.asarray(x), jnp.asarray(w),
                                        precision=jax.lax.Precision.HIGHEST))
    got = tsd.s2d_stem_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, d // 2, d // 2, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=STEM_TOL * np.abs(want).max())


def _ecfgs(dtype, engine, **kw):
    kw = dict(space_to_depth=True, compute_dtype=dtype, **kw)
    if engine == "pallas":
        kw.update(kernels="pallas", conv_kernels="pallas")
    return (jcfg.ExecutionConfig(pallas_interpret=engine == "pallas", **kw),
            tcfg.ExecutionConfig(**kw))


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_forward_and_train_step_match_jax(dtype, engine):
    jecfg, tecfg = _ecfgs(dtype, engine)
    jecfg32 = dataclasses.replace(jecfg, compute_dtype="float32")
    jm, tm = _models()
    bf16 = dtype == "bfloat16"

    params, state = _perturbed(jm, 2)
    x = _images(2, 3)
    want = np.asarray(j_forward(params, x, jm, jecfg, train=False, bn_state=state)[0])
    want32 = (np.asarray(j_forward(params, x, jm, jecfg32, train=False, bn_state=state)[0])
              if bf16 else None)
    got, _ = forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                     tecfg, train=False, bn_state=bridge.bn_state_from_numpy(state, "cpu"))
    _held(got.numpy(), want, _gap([want], [want32]) if bf16 else None, "eval logits", TOL)

    opt = dict(learning_rate=1e-4)
    jc = jcfg.TrainConfig(model=jm, execution=jecfg, optimizer=jcfg.OptimizerConfig(**opt))
    tc = tcfg.TrainConfig(model=tm, execution=tecfg, optimizer=tcfg.OptimizerConfig(**opt))
    js0 = jax.device_get(j_init_train_state(jc, jax.random.PRNGKey(11)))
    rng = np.random.default_rng(5)
    batch = {"images": _images(5, 4), "labels": rng.integers(0, 8, 4).astype(np.int32)}
    js, jmet = j_make_train_step(jc, donate=False)(js0, batch)
    js32, jmet32 = (j_make_train_step(dataclasses.replace(jc, execution=jecfg32),
                                      donate=False)(js0, batch) if bf16 else (None, None))
    ts, tmet = make_train_step(tc)(bridge.train_state_from_numpy(js0, device="cpu"), batch)
    for k in ("loss", "grad_norm"):
        _held(tmet[k].item(), float(jmet[k]),
              _gap([float(jmet[k])], [float(jmet32[k])]) if bf16 else None, k, METRIC_TOL)
    lr = opt["learning_rate"]
    for name, tol in (("params", lambda s: TOL * s + 2 * lr), ("opt_state", TOL),
                      ("bn_state", TOL)):
        _held_trees(getattr(ts, name), getattr(js, name),
                    getattr(js32, name) if bf16 else None, name, tol,
                    2 * lr if name == "params" else 0.0)


def _grads(params, x, mcfg, ecfg):
    labels = torch.from_numpy(np.arange(x.shape[0], dtype=np.int32) % mcfg.num_classes)
    cfg = tcfg.TrainConfig(model=mcfg, execution=ecfg)
    _, logits, _, grads = loss_and_grads(params, {"images": x, "labels": labels}, None, cfg)
    return logits, grads


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_s2d_stem_tracks_the_standard_stem(engine):
    """The port's two stems on one model, within the tolerances JAX allows
    its own two (the 7x7's sums against the 4x4's)."""
    _, tm = _models()
    params = bridge.params_from_numpy(_perturbed(_models()[0], 1)[0], device="cpu")
    x = torch.from_numpy(_images(1, 2))
    kw = dict(kernels="pallas", conv_kernels="pallas") if engine == "pallas" else {}
    y0, g0 = _grads(params, x, tm, tcfg.ExecutionConfig(**kw))
    y1, g1 = _grads(params, x, tm, tcfg.ExecutionConfig(space_to_depth=True, **kw))
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(), rtol=STEM_LOGIT_RTOL,
                               atol=1e-5)
    for (path, a), b in zip(bridge.flatten(g1), bridge.leaves(g0), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=STEM_GRAD_RTOL, atol=1e-4,
                                   err_msg=path)
    assert not torch.equal(y0, y1)  # the s2d route was taken


# where JAX keeps the standard stem: (label, model overrides, execution, layout)
NO_S2D = [
    ("NCHW", {}, dict(layout="NCHW"), "NCHW"),
    ("3x3 stem", dict(init_kernel=3), {}, "NHWC"),
    ("fused", {}, dict(kernels="fused"), "NHWC"),
    ("hybrid", {}, dict(kernels="hybrid"), "NHWC"),
    ("fusedxla", {}, dict(kernels="fusedxla"), "NHWC"),
]


@pytest.mark.parametrize("label,over,execution,layout", NO_S2D, ids=[c[0] for c in NO_S2D])
def test_s2d_is_a_no_op_where_jax_keeps_the_standard_stem(label, over, execution, layout):
    jm = jcfg.tiny_model_config(**{"init_kernel": 7, **over})
    tm = tcfg.tiny_model_config(**{"init_kernel": 7, **over})
    params, _ = _perturbed(jm, 3)
    x = _images(3, 2, layout=layout)
    tp = bridge.params_from_numpy(params, device="cpu")
    on, _ = forward(tp, torch.from_numpy(x), tm,
                    tcfg.ExecutionConfig(space_to_depth=True, **execution))
    off, _ = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(**execution))
    assert torch.equal(on, off)
    want = np.asarray(j_forward(params, x, jm, jcfg.ExecutionConfig(space_to_depth=True,
                                                                     **execution))[0])
    _held(on.detach().numpy(), want, None, label, TOL)


def test_odd_height_raises_as_in_jax():
    jm, tm = _models()
    params, _ = _perturbed(jm, 4)
    x = np.zeros((1, 15, 16, 3), np.float32)
    with pytest.raises(ValueError):
        j_forward(params, x, jm, jcfg.ExecutionConfig(space_to_depth=True))
    with pytest.raises(ValueError):
        forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                tcfg.ExecutionConfig(space_to_depth=True))


@pytest.mark.parametrize("remat", ["block", "stage", "elementwise"])
def test_s2d_under_remat_gives_the_no_remat_gradients(remat):
    _, tm = _models(block_sizes=(2, 2))
    params = bridge.params_from_numpy(_perturbed(_models(block_sizes=(2, 2))[0], 5)[0],
                                      device="cpu")
    x = torch.from_numpy(_images(5, 2))
    kw = dict(space_to_depth=True, kernels="pallas", conv_kernels="pallas")
    y0, g0 = _grads(params, x, tm, tcfg.ExecutionConfig(**kw))
    y1, g1 = _grads(params, x, tm, tcfg.ExecutionConfig(remat=remat, **kw))
    assert torch.equal(y0, y1)
    for (path, a), b in zip(bridge.flatten(g1), bridge.leaves(g0), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * b.abs().max().item(),
                                   msg=path)
