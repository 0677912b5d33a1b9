"""NCHW and bf16 through the port's model and training step, against the
JAX package on the CPU.

* The tiny model over {NHWC, NCHW} x {float32, bfloat16} x {plain ops,
  hand kernels (their plain versions here; JAX's Pallas in interpret
  mode)}: one eval forward on perturbed parameters and running statistics,
  and one train step from one bridged state. fp32 is held as
  tests/test_torch_model.py and tests/test_torch_train.py hold NHWC today;
  bf16 within 2x JAX's own gap between its bf16 and fp32 runs on the same
  inputs, plus 1e-5, each of a leaf's max: the gap is taken relative to
  each leaf's max and its largest over the tree (the parameters, each
  optimizer moment, the running statistics) is the tree's, since a leaf's
  own gap may be near 0 by chance. bf16 rounds at other places in the two
  frameworks (the plain path: torch's CPU ops against XLA's). Adam's parameters also get the fp32 tests'
  2 lr per step: the first steps move each weight by about lr * sign(g),
  so a gradient near 0 whose sign differs flips its update.
* Under NCHW the hand-kernel path takes no K4: the statistics are plain,
  as resnet_tpu/ops/dispatch.py:58 sends them.
* The ``nchw`` and ``fast`` presets train the tiny model for 3 steps
  beside JAX.
"""

import dataclasses
import operator

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.models import forward as j_forward
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.train import make_train_step

TOL = 1e-4  # fp32, of max|JAX| (tests/test_torch_model.py, test_torch_train.py)
METRIC_TOL = 1e-5
FLOOR = 1e-5  # beside 2x the bf16-vs-fp32 gap


def _ecfgs(layout, dtype, engine):
    kw = dict(layout=layout, compute_dtype=dtype)
    if engine == "pallas":
        kw.update(kernels="pallas", conv_kernels="pallas")
    return (jcfg.ExecutionConfig(pallas_interpret=engine == "pallas", **kw),
            tcfg.ExecutionConfig(**kw))


def _images(rng, n, layout):
    x = rng.normal(0, 50, (n, 16, 16, 3)).astype(np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if layout == "NCHW" else x


def _perturbed(seed):
    """JAX params with BN affines moved off (1, 0) and running statistics
    off (0, 1), as numpy trees."""
    jm = jcfg.tiny_model_config()
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(seed), jm))
    state = jax.tree.map(np.asarray, j_init_bn_state(jm))

    def move(path, a):
        name = path[-1].key
        if name in ("gamma", "beta", "mean"):
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return (jax.tree_util.tree_map_with_path(move, params),
            jax.tree_util.tree_map_with_path(move, state))


def _gap(want, want32):
    """JAX's bf16-vs-fp32 gap over a list of arrays, each of its max: the
    largest max|want - want32| / max|want|."""
    return max(float(np.abs(np.asarray(w, np.float64) - np.asarray(w32, np.float64)).max())
               / max(float(np.abs(np.asarray(w)).max()), 1e-30)
               for w, w32 in zip(want, want32, strict=True))


def _held(got, want, gap, what, fp32_tol, slack=0.0):
    """got against want: within fp32_tol(scale) where gap is None (fp32),
    else within (2 gap + FLOOR) * scale + slack; scale is max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    if gap is None:
        limit = fp32_tol(scale) if callable(fp32_tol) else fp32_tol * scale
    else:
        limit = (2 * gap + FLOOR) * scale + slack
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: {err} > {limit}"


def _held_trees(got, want, want32, what, fp32_tol, slack=0.0):
    """Every leaf of got (port) against want (JAX), paths checked; want32
    (JAX in fp32) gives the tree's gap, None holds fp32."""
    a = bridge.flatten(bridge.to_numpy(got))
    b = bridge.flatten(jax.tree.map(np.asarray, want))
    assert [p for p, _ in a] == [p for p, _ in b], what
    gap = None
    if want32 is not None:
        gap = _gap([w for _, w in b], jax.tree.leaves(jax.tree.map(np.asarray, want32)))
    for (path, g), (_, w) in zip(a, b):
        _held(g, w, gap, f"{what}/{path}", fp32_tol, slack)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_forward_and_train_step_match_jax(layout, dtype, engine):
    jecfg, tecfg = _ecfgs(layout, dtype, engine)
    jecfg32 = dataclasses.replace(jecfg, compute_dtype="float32")
    jm, tm = jcfg.tiny_model_config(), tcfg.tiny_model_config()
    bf16 = dtype == "bfloat16"

    # the eval forward
    params, state = _perturbed(2)
    x = _images(np.random.default_rng(2), 3, layout)
    want = np.asarray(j_forward(params, x, jm, jecfg, train=False, bn_state=state)[0])
    want32 = (np.asarray(j_forward(params, x, jm, jecfg32, train=False, bn_state=state)[0])
              if bf16 else None)
    got, _ = forward(bridge.params_from_numpy(params, device="cpu"), torch.from_numpy(x), tm,
                     tecfg, train=False, bn_state=bridge.bn_state_from_numpy(state, "cpu"))
    assert got.dtype is torch.float32
    _held(got.numpy(), want, _gap([want], [want32]) if bf16 else None, "eval logits", TOL)

    # one train step from one bridged state (Adam, lr 1e-4)
    opt = dict(learning_rate=1e-4)
    jc = jcfg.TrainConfig(model=jm, execution=jecfg, optimizer=jcfg.OptimizerConfig(**opt))
    tc = tcfg.TrainConfig(model=tm, execution=tecfg, optimizer=tcfg.OptimizerConfig(**opt))
    js0 = jax.device_get(j_init_train_state(jc, jax.random.PRNGKey(11)))
    rng = np.random.default_rng(5)
    batch = {"images": _images(rng, 4, layout),
             "labels": rng.integers(0, 8, 4).astype(np.int32)}
    js, jmet = j_make_train_step(jc, donate=False)(js0, batch)
    js32, jmet32 = (j_make_train_step(dataclasses.replace(jc, execution=jecfg32),
                                      donate=False)(js0, batch) if bf16 else (None, None))
    ts, tmet = make_train_step(tc)(bridge.train_state_from_numpy(js0, device="cpu"), batch)
    for k in ("loss", "grad_norm"):
        _held(tmet[k].item(), float(jmet[k]),
              _gap([float(jmet[k])], [float(jmet32[k])]) if bf16 else None, k, METRIC_TOL)
    lr = opt["learning_rate"]
    for name, tol in (("params", lambda s: TOL * s + 2 * lr), ("opt_state.means", TOL),
                      ("opt_state.vars", TOL), ("bn_state", TOL)):
        pick = operator.attrgetter(name)
        _held_trees(pick(ts), pick(js), pick(js32) if bf16 else None, name, tol,
                    2 * lr if name == "params" else 0.0)


@pytest.mark.parametrize("layout,k4", [("NHWC", 9), ("NCHW", 0)])
def test_hand_kernel_path_takes_k4_only_under_nhwc(monkeypatch, layout, k4):
    """The tiny model's 9 BN layers take the moments kernel's wrapper under
    NHWC and the plain statistics under NCHW; every conv takes the conv
    kernel's wrapper in both (counted here by call, since on the CPU the
    launch counters do not move)."""
    from resnet_tpu_torch.ops import dispatch

    calls = {"moments": 0, "conv2d": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(dispatch._kbn, "moments", counted("moments", dispatch._kbn.moments))
    monkeypatch.setattr(dispatch._kconv, "conv2d", counted("conv2d", dispatch._kconv.conv2d))
    _, tecfg = _ecfgs(layout, "float32", "pallas")
    tm = tcfg.tiny_model_config()
    params = bridge.params_from_numpy(_perturbed(1)[0], device="cpu")
    x = torch.from_numpy(_images(np.random.default_rng(1), 2, layout))
    forward(params, x, tm, tecfg, train=True)
    assert calls == {"moments": k4, "conv2d": 9}


@pytest.mark.parametrize("variant", ["nchw", "fast"])
def test_presets_train_like_jax(variant):
    """Three steps of the preset (lr 1e-3) on the tiny model at batch 4 from
    one bridged state. nchw (fp32, plain path): step 1 with the fp32
    tolerances of tests/test_torch_train.py, step 3's loss within 1e-4 and
    its running statistics within 2e-4 of max (at lr 1e-3 an Adam update
    that flips with a gradient's last bits moves later steps' statistics,
    ROADMAP.md queue C). fast (bf16, cap 10): every step's loss and each
    leaf within 2x JAX's own gap to the same preset in fp32, the gap taken
    over the step's loss, parameters and running statistics (parameters
    also 2 lr per step, as above)."""
    jc = dataclasses.replace(jcfg.variant_config(variant), model=jcfg.tiny_model_config())
    tc = dataclasses.replace(tcfg.variant_config(variant), model=tcfg.tiny_model_config())
    jc32 = dataclasses.replace(jc, execution=dataclasses.replace(
        jc.execution, compute_dtype="float32"))
    layout = tc.execution.layout
    js = js32 = jax.device_get(j_init_train_state(jc, jax.random.PRNGKey(7)))
    ts = bridge.train_state_from_numpy(js, device="cpu")
    rng = np.random.default_rng(9)
    batch = {"images": _images(rng, 4, layout),
             "labels": rng.integers(0, 8, 4).astype(np.int32)}
    jstep, jstep32 = (j_make_train_step(c, donate=False) for c in (jc, jc32))
    tstep = make_train_step(tc)
    bf16 = variant == "fast"
    lr = tc.optimizer.learning_rate
    for step in range(1, 4):
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, batch)
        if bf16:
            js32, jmet32 = jstep32(js32, batch)
            # the step's gap: over its loss, parameters and running statistics
            want = [float(jmet["loss"])] + jax.tree.leaves((js.params, js.bn_state))
            gap = _gap(want, [float(jmet32["loss"])] + jax.tree.leaves(
                (js32.params, js32.bn_state)))
            _held(tmet["loss"].item(), want[0], gap, f"step {step} loss", 0)
            for name in ("params", "bn_state"):
                for (path, g), w in zip(bridge.flatten(bridge.to_numpy(getattr(ts, name))),
                                        jax.tree.leaves(getattr(js, name)), strict=True):
                    _held(g, np.asarray(w), gap, f"step {step} {name}/{path}", 0,
                          2 * lr * step if name == "params" else 0.0)
        elif step == 1:
            _held(tmet["loss"].item(), float(jmet["loss"]), None, "loss", METRIC_TOL)
            _held_trees(ts.params, js.params, None, "step 1 params",
                        lambda s: TOL * s + 2 * lr)
            _held_trees(ts.bn_state, js.bn_state, None, "step 1 bn_state", TOL)
    if bf16:  # fp32 master parameters under bf16 compute (tests/test_train.py:368-390)
        assert all(p.dtype is torch.float32 for p in bridge.leaves(ts.params))
    else:
        _held(tmet["loss"].item(), float(jmet["loss"]), None, "step 3 loss", TOL)
        _held_trees(ts.bn_state, js.bn_state, None, "step 3 bn_state", 2e-4)
