"""The port's plain ops against resnet_tpu.ops on the same numpy inputs.

fp32 on the CPU, JAX at 'highest' matmul precision (conftest): agreement
within 1e-4 of max|reference| unless a test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import ops as jops
from resnet_tpu_torch import ops

TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} vs {tol} * {scale}"


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("in_dim,k,s,want", [
    (224, 7, 2, (3, 2)),
    (56, 3, 2, (1, 0)),
    (56, 1, 2, (0, -1)),
    (56, 3, 1, (1, 1)),
    (112, 3, 2, (1, 0)),
    (7, 1, 1, (0, 0)),
])
def test_reference_padding(in_dim, k, s, want):
    assert ops.reference_padding(in_dim, k, s) == want
    assert jops.reference_padding(in_dim, k, s) == want


def test_reference_padding_rejects_ragged_stride():
    with pytest.raises(ValueError):
        ops.reference_padding(7, 3, 2)


# (h, cin, cout, k, stride): tests/test_kernels.py TestPallasConv.CASES plus
# the full 7x7/s2 stem geometry at input 32
CONV_CASES = [
    (16, 3, 8, 7, 2),
    (8, 8, 16, 1, 1),
    (8, 16, 16, 3, 1),
    (8, 16, 16, 3, 2),
    (8, 8, 32, 3, 2),
    (32, 3, 8, 7, 2),
]


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
def test_conv2d(rng, h, cin, cout, k, stride):
    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    got = ops.conv2d(T(x), T(w), stride=stride)
    want = jops.conv2d(J(x), J(w), stride=stride, layout="NHWC")
    assert got.is_contiguous()
    close(got, want)


def test_conv2d_1x1_stride2_crops(rng):
    """1x1/s2 pads (0, -1): the crop path of the explicit padding."""
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    w = rng.normal(size=(1, 1, 4, 6)).astype(np.float32)
    close(ops.conv2d(T(x), T(w), stride=2),
          jops.conv2d(J(x), J(w), stride=2, layout="NHWC"))


def test_conv2d_grouped(rng):
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 2, 8)) * 0.2).astype(np.float32)
    close(ops.conv2d(T(x), T(w), stride=2, groups=4),
          jops.conv2d(J(x), J(w), stride=2, layout="NHWC", groups=4))


@pytest.mark.parametrize("h,k,s", [(16, 3, 2), (112, 3, 2), (9, 3, 1)])
def test_max_pool(rng, h, k, s):
    x = rng.normal(size=(2, h, h, 5)).astype(np.float32)
    got = ops.max_pool(T(x), kernel=k, stride=s)
    want = jops.max_pool(J(x), kernel=k, stride=s, layout="NHWC")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_all_negative_edges():
    """-inf padding: an all-negative image keeps negative maxima at edges."""
    x = -np.abs(np.random.default_rng(0).normal(size=(1, 6, 6, 2))).astype(np.float32) - 1
    got = ops.max_pool(T(x), kernel=3, stride=2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.max_pool(J(x), kernel=3, stride=2)))
    assert (got < 0).all()


def test_global_avg_pool(rng):
    x = rng.normal(size=(3, 7, 7, 16)).astype(np.float32)
    close(ops.global_avg_pool(T(x)), jops.global_avg_pool(J(x), layout="NHWC"))


def test_batch_norm_eval(rng):
    c = 12
    x = rng.normal(1.0, 3.0, size=(2, 5, 5, c)).astype(np.float32)
    gamma = rng.normal(1, 0.2, c).astype(np.float32)
    beta = rng.normal(0, 0.2, c).astype(np.float32)
    mean = rng.normal(0, 0.5, c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    got, (m, v) = ops.batch_norm(T(x), T(gamma), T(beta), eps=1e-7,
                                 mean=T(mean), var=T(var))
    want, _ = jops.batch_norm(J(x), J(gamma), J(beta), eps=1e-7, layout="NHWC",
                              mean=J(mean), var=J(var))
    close(got, want)
    np.testing.assert_array_equal(m.numpy(), mean)
    close(ops.batch_norm_inference(T(x), T(gamma), T(beta), T(mean), T(var)),
          jops.batch_norm_inference(J(x), J(gamma), J(beta), J(mean), J(var)))


def test_batch_norm_needs_statistics(rng):
    """Without mean and var, BN takes the batch statistics (biased variance,
    fp32) and matches JAX's training-mode batch_norm."""
    x = rng.normal(1.0, 3.0, size=(2, 5, 5, 6)).astype(np.float32)
    gamma = rng.normal(1, 0.2, 6).astype(np.float32)
    beta = rng.normal(0, 0.2, 6).astype(np.float32)
    got, (m, v) = ops.batch_norm(T(x), T(gamma), T(beta))
    want, (jm, jv) = jops.batch_norm(J(x), J(gamma), J(beta), layout="NHWC")
    close(got, want)
    close(m, jm)
    close(v, jv)
    close(v, x.reshape(-1, 6).var(0))


def test_batch_norm_vjp_matches_jax(rng):
    """Gradients of a loss on (y, mean, var) w.r.t. x, gamma and beta through
    the closed-form moments VJP, within 1e-4 of max|JAX| each."""
    import jax

    x = rng.normal(0.5, 2.0, size=(2, 4, 4, 5)).astype(np.float32)
    gamma = rng.normal(1, 0.2, 5).astype(np.float32)
    beta = rng.normal(0, 0.2, 5).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    dm, dv = rng.normal(size=5).astype(np.float32), rng.normal(size=5).astype(np.float32)

    def jloss(a, g, b):
        y, (m, v) = jops.batch_norm(a, g, b, layout="NHWC")
        return (y * dy).sum() + (m * dm).sum() + (v * dv).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(J(x), J(gamma), J(beta))
    xs = [T(a.copy()).requires_grad_(True) for a in (x, gamma, beta)]
    y, (m, v) = ops.batch_norm(*xs)
    loss = (y * T(dy)).sum() + (m * T(dm)).sum() + (v * T(dv)).sum()
    for got, w in zip(torch.autograd.grad(loss, xs), want):
        close(got, w)


def test_update_running_stats_matches_jax(rng):
    rm, rv, m, v = (rng.normal(size=7).astype(np.float32) for _ in range(4))
    got = ops.update_running_stats(T(rm), T(rv), T(m), T(v), 0.9)
    want = jops.update_running_stats(J(rm), J(rv), J(m), J(v), 0.9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(rng, reduction, smoothing):
    """Value and gradient w.r.t. the logits, within 1e-4 of max|JAX|."""
    import jax

    logits = rng.normal(0, 3, size=(6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    kw = dict(reduction=reduction, label_smoothing=smoothing)
    want = jops.cross_entropy(J(logits), J(labels), **kw)
    jg = jax.grad(lambda z: jops.cross_entropy(z, J(labels), **kw).sum())(J(logits))
    z = T(logits.copy()).requires_grad_(True)
    got = ops.cross_entropy(z, T(labels), **kw)
    close(got, want)
    (tg,) = torch.autograd.grad(got.sum(), [z])
    close(tg, jg)


def test_accuracies_match_jax(rng):
    logits = rng.normal(size=(16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    logits[np.arange(0, 16, 3), labels[::3]] += 5.0  # some hits
    for mean in (True, False):
        np.testing.assert_array_equal(
            ops.top1_accuracy(T(logits), T(labels), mean=mean).numpy(),
            np.asarray(jops.top1_accuracy(J(logits), J(labels), mean=mean)))
    for k in (1, 5):
        np.testing.assert_array_equal(
            ops.topk_accuracy(T(logits), T(labels), k).numpy(),
            np.asarray(jops.topk_accuracy(J(logits), J(labels), k)))


@pytest.mark.parametrize("h", [8, 9])
def test_max_pool_vjp_first_maximum_wins_ties(h):
    """Integer-valued inputs make many windows tie; the gradient must land
    where JAX's select_scatter VJP puts it (the first maximum in scan
    order), exactly."""
    import jax

    x = np.random.default_rng(h).integers(-2, 3, size=(2, h, h, 3)).astype(np.float32)
    stride = 2 if h % 2 == 0 else 1
    out = jops.max_pool(J(x), kernel=3, stride=stride, layout="NHWC")
    dy = np.random.default_rng(1).normal(size=out.shape).astype(np.float32)
    want = jax.grad(lambda a: (jops.max_pool(a, kernel=3, stride=stride,
                                             layout="NHWC") * dy).sum())(J(x))
    xt = T(x.copy()).requires_grad_(True)
    (got,) = torch.autograd.grad((ops.max_pool(xt, kernel=3, stride=stride) * T(dy)).sum(),
                                 [xt])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,kw", [
    ("constant", dict()),
    ("cosine", dict(total_steps=10, warmup_steps=3)),
    ("step", dict(total_steps=10, warmup_steps=2)),
])
def test_schedules_match_jax(name, kw):
    from resnet_tpu.config import OptimizerConfig as JOpt
    from resnet_tpu.optim import make_schedule as j_make
    from resnet_tpu_torch.config import OptimizerConfig
    from resnet_tpu_torch.optim import make_schedule

    jf = j_make(JOpt(learning_rate=0.1, schedule=name, **kw))
    tf = make_schedule(OptimizerConfig(learning_rate=0.1, schedule=name, **kw))
    for step in range(12):
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), float(jf(np.int32(step))), rtol=1e-6)


def _opt_trees(rng):
    """A small parameter tree with BN and bias leaves, its gradients, and
    'no_bn' masks for both packages."""
    params = {"conv": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32)},
              "bn": {"gamma": rng.normal(1, 0.1, 4).astype(np.float32),
                     "beta": rng.normal(0, 0.1, 4).astype(np.float32)},
              "fc": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                     "b": rng.normal(size=3).astype(np.float32)}}
    grads = {k: {n: rng.normal(size=a.shape).astype(np.float32) for n, a in v.items()}
             for k, v in params.items()}
    return params, grads


def _tree_close(got, want, tol=1e-5):
    from resnet_tpu_torch import bridge

    a, b = bridge.flatten(bridge.to_numpy(got)), bridge.flatten(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        y = np.asarray(y)
        assert np.abs(x - y).max() <= tol * max(np.abs(y).max(), 1e-30), p


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_updates_match_jax(rng, opt):
    """Two steps of adam_update / sgd_update with weight decay and
    wd_mask='no_bn' (BN gamma/beta and the bias exempt), within 1e-5 of
    max|JAX| per leaf; the Adam decay products exactly."""
    import jax

    from resnet_tpu import optim as joptim
    from resnet_tpu.train.step import _wd_mask_tree as j_mask
    from resnet_tpu_torch import bridge, optim
    from resnet_tpu_torch.train.step import _wd_mask_tree

    params, grads = _opt_trees(rng)
    tp = bridge.params_from_numpy(params, device="cpu")
    tg = bridge.params_from_numpy(grads, device="cpu")
    jp, jg = jax.tree.map(J, params), jax.tree.map(J, grads)
    mask, jmask = _wd_mask_tree(tp, "no_bn"), j_mask(jp, "no_bn")
    assert bridge.flatten(mask) == [(p, float(v)) for p, v in bridge.flatten(jmask)]
    if opt == "adam":
        kw = dict(learning_rate=1e-2, weight_decay=0.1, beta1=0.9, beta2=0.999, eps=1e-7)
        ts, js = optim.adam_init(tp), joptim.adam_init(jp)
        for _ in range(2):
            tp, ts = optim.adam_update(tg, ts, tp, wd_mask=mask, **kw)
            jp, js = joptim.adam_update(jg, js, jp, wd_mask=jmask, **kw)
        _tree_close(ts.means, js.means)
        _tree_close(ts.vars, js.vars)
        assert ts.mean_decay_prod.item() == float(js.mean_decay_prod)
        assert ts.var_decay_prod.item() == float(js.var_decay_prod)
    else:
        kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=0.1)
        ts, js = optim.sgd_init(tp), joptim.sgd_init(jp)
        for _ in range(2):
            tp, ts = optim.sgd_update(tg, ts, tp, wd_mask=mask, **kw)
            jp, js = joptim.sgd_update(jg, js, jp, wd_mask=jmask, **kw)
        _tree_close(ts.momentum_buf, js.momentum_buf)
    _tree_close(tp, jp)
    assert int(ts.step) == int(js.step) == 2


def test_linear(rng):
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    close(ops.linear(T(x), T(w)), jops.linear(J(x), J(w)))
    close(ops.linear(T(x), T(w), T(b)), jops.linear(J(x), J(w), J(b)))


@pytest.mark.parametrize("stable", [True, False])
def test_softmax(rng, stable):
    x = rng.normal(0, 4, size=(4, 10)).astype(np.float32)
    close(ops.softmax(T(x), stable=stable), jops.softmax(J(x), stable=stable))
    close(ops.log_softmax(T(x)), jops.log_softmax(J(x)))


def test_naive_softmax_overflows_like_the_reference():
    x = np.array([[100.0, 0.0]], np.float32)
    assert torch.isnan(ops.softmax(T(x), stable=False)).any()
    assert np.isnan(np.asarray(jops.softmax(J(x), stable=False))).any()
    close(ops.softmax(T(x)), jops.softmax(J(x)))


def test_relu_and_cap(rng):
    from resnet_tpu.ops import activation as jact

    x = rng.normal(0, 8, size=(64,)).astype(np.float32)
    np.testing.assert_array_equal(ops.relu(T(x)).numpy(), np.asarray(jact.relu(J(x))))
    np.testing.assert_array_equal(ops.relu_cap(T(x)).numpy(),
                                  np.asarray(jact.relu_cap(J(x))))
