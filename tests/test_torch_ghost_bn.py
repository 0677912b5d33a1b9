"""Ghost BN (``ExecutionConfig.bn_stats_batch``) in the port against the JAX
package on the CPU.

``batch_norm_ghost`` (statistics from the first k images, normalization over
the batch, a closed-form VJP) against ``resnet_tpu.ops.batchnorm.
batch_norm_ghost`` at (4, 8, 8, 16) with k = 2: y, the statistics and the
VJP with cotangents on y and on both statistics, within rtol 1e-5 (atol
1e-6 of the values near 0); against its own plain counterpart (autograd of
the sliced moments); then the tiny model with ``bn_stats_batch=4`` of a
batch of 8 against JAX's forward and gradients (tests/test_model.py:313-362), within 1e-4 of
max|JAX| per leaf as the other training parity tests hold them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu.ops.batchnorm import batch_norm_ghost as j_ghost
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.models import forward
from resnet_tpu_torch.ops.batchnorm import (
    batch_moments,
    batch_norm,
    batch_norm_ghost,
    batch_norm_ghost_reference,
)

RTOL, ATOL = 1e-5, 1e-6
SHAPE, K = (4, 8, 8, 16), 2


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, SHAPE).astype(np.float32)
    gamma = (1 + 0.2 * rng.normal(size=SHAPE[-1])).astype(np.float32)
    beta = (0.3 * rng.normal(size=SHAPE[-1])).astype(np.float32)
    dy = rng.normal(size=SHAPE).astype(np.float32)
    dmean = rng.normal(size=SHAPE[-1]).astype(np.float32)
    dvar = rng.normal(size=SHAPE[-1]).astype(np.float32)
    return x, gamma, beta, dy, dmean, dvar


def _port_vjp(fn, x, gamma, beta, cts):
    """(y, mean, var, dx, dgamma, dbeta) of fn at the cotangents cts."""
    xs, g, b = (torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta))
    y, (mean, var) = fn(xs, g, b)
    outs, grads = zip(*[(o, torch.from_numpy(c)) for o, c in zip((y, mean, var), cts)
                        if c is not None])
    d = torch.autograd.grad(outs, (xs, g, b), grads)
    return [t.detach().numpy() for t in (y, mean, var, *d)]


@pytest.mark.parametrize("stat_cts", [False, True], ids=["dy", "dy+dstats"])
def test_batch_norm_ghost_matches_jax(stat_cts):
    x, gamma, beta, dy, dmean, dvar = _inputs()
    cts = (dy, dmean, dvar) if stat_cts else (dy, None, None)

    def jfn(x, g, b):
        return j_ghost(x, g, b, K, eps=1e-7)

    (jy, (jm, jv)), vjp = jax.vjp(jfn, x, gamma, beta)
    jct = (dy, (dmean if stat_cts else jnp.zeros_like(jm),
                dvar if stat_cts else jnp.zeros_like(jv)))
    want = [np.asarray(a) for a in (jy, jm, jv, *vjp(jct))]
    got = _port_vjp(lambda a, g, b: batch_norm_ghost(a, g, b, K, eps=1e-7),
                    x, gamma, beta, cts)
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("stat_cts", [False, True], ids=["dy", "dy+dstats"])
def test_batch_norm_ghost_closed_form_matches_its_plain_version(stat_cts):
    """The closed-form backward against autograd of the sliced moments."""
    x, gamma, beta, dy, dmean, dvar = _inputs(1)
    cts = (dy, dmean, dvar) if stat_cts else (dy, None, None)
    got = _port_vjp(lambda a, g, b: batch_norm_ghost(a, g, b, K), x, gamma, beta, cts)
    want = _port_vjp(lambda a, g, b: batch_norm_ghost_reference(a, g, b, K),
                     x, gamma, beta, cts)
    for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL * np.abs(b).max(),
                                   err_msg=name)
    # the images past the stats sample get no share of the statistics' terms
    xs = torch.from_numpy(x).requires_grad_(True)
    y, _ = batch_norm_ghost(xs, torch.from_numpy(gamma), torch.from_numpy(beta), K)
    (dx,) = torch.autograd.grad(y, xs, torch.from_numpy(dy))
    inv = torch.rsqrt(batch_moments(torch.from_numpy(x[:K]))[1] + 1e-7)
    torch.testing.assert_close(dx[K:], torch.from_numpy(dy[K:] * gamma) * inv,
                               rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("k", [0, 4, 9])
def test_batch_norm_ghost_of_the_whole_batch_is_batch_norm(k):
    x, gamma, beta, *_ = _inputs(2)
    args = [torch.from_numpy(a) for a in (x, gamma, beta)]
    y, (mean, var) = batch_norm_ghost(*args, k)
    want, (wm, wv) = batch_norm(*args)
    assert torch.equal(y, want) and torch.equal(mean, wm) and torch.equal(var, wv)


def _model_inputs():
    jm = jcfg.tiny_model_config()
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(0), jm))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 30, (8, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, jm.num_classes, (8,)).astype(np.int32)
    return jm, params, x, labels


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_ghost_bn_model_matches_jax(engine):
    """The tiny model with bn_stats_batch=4 of a batch of 8 (test_model.py's
    case): logits, every layer's ghost statistics and every gradient leaf of
    the summed CE within 1e-4 of max|JAX|; the first BN's statistics are the
    moments of the stats slice; bn_stats_batch=8 is the full batch."""
    from resnet_tpu.train.step import _loss_fn

    from resnet_tpu_torch.train import loss_and_grads

    jm, params, x, labels = _model_inputs()
    kw = dict(bn_stats_batch=4)
    if engine == "pallas":
        kw.update(kernels="pallas", conv_kernels="pallas")
    jc = jcfg.TrainConfig(model=jm, execution=jcfg.ExecutionConfig(**kw))
    fn = jax.value_and_grad(lambda p: _loss_fn(p, {"images": x, "labels": labels}, None, jc),
                            has_aux=True)
    (jloss, (jlogits, jaux)), jgrads = fn(params)
    tm = tcfg.tiny_model_config()
    tc = tcfg.TrainConfig(model=tm, execution=tcfg.ExecutionConfig(**kw))
    tp = bridge.params_from_numpy(params, device="cpu")
    batch = {"images": torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    loss, logits, aux, grads = loss_and_grads(tp, batch, None, tc)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for what, got, want in (("logits", logits, jlogits), ("bn_stats", aux["bn_stats"],
                                                          jaux["bn_stats"]),
                            ("grads", grads, jgrads)):
        a, b = bridge.flatten(got), bridge.flatten(want)
        assert [p for p, _ in a] == [p for p, _ in b], what
        for (path, g), (_, w) in zip(a, b):
            w = np.asarray(w)
            err = float(np.abs(g.detach().numpy() - w).max())
            assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-30), (what, path, err)
    # the stem BN's statistics are the moments of the first 4 images' conv
    from resnet_tpu_torch.ops import conv2d

    y0 = conv2d(torch.from_numpy(x[:4]), tp["init_conv"]["w"], stride=tm.init_stride)
    m_ref, _ = batch_moments(y0)
    torch.testing.assert_close(aux["bn_stats"]["init_bn"][0], m_ref, rtol=1e-5, atol=1e-5)
    full, _ = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig())
    whole, _ = forward(tp, torch.from_numpy(x), tm, tcfg.ExecutionConfig(bn_stats_batch=8))
    assert torch.equal(full, whole)


@pytest.mark.parametrize("kernels", ["fused", "hybrid", "fusedxla", "blockfused"])
def test_engines_take_the_standard_path_under_ghost_bn(kernels):
    """With ghost BN the fused engines and the whole-block route fall back to
    the standard path (JAX models/resnet.py:130, :284): equal to
    kernels='xla' with the same ghost BN."""
    kw = dict(init_filters=32, block_sizes=(2, 2)) if kernels == "blockfused" else {}
    tm = tcfg.tiny_model_config(**kw)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1),
                                                    jcfg.tiny_model_config(**kw)))
    tp = bridge.params_from_numpy(params, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 30, (4, 16, 16, 3))
                         .astype(np.float32))
    got, gaux = forward(tp, x, tm, tcfg.ExecutionConfig(kernels=kernels, bn_stats_batch=2))
    want, waux = forward(tp, x, tm, tcfg.ExecutionConfig(bn_stats_batch=2))
    assert torch.equal(got, want)
    for (p, a), (_, b) in zip(bridge.flatten(gaux["bn_stats"]),
                              bridge.flatten(waux["bn_stats"])):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("accum,k", [(2, 2)])
def test_ghost_bn_train_steps_match_jax(accum, k):
    """train_step on a batch of 8 with grad_accum=2 and bn_stats_batch=2
    (each microbatch of 4 takes its statistics from its first 2 images) and
    every hand kernel's plain version: everything the step produces after
    steps 1 and 3 against JAX's, by test_torch_train's rules.

    Without grad_accum (k = 4 of the 8) this batch puts one element of
    block 1's reduce BN output 6.1e-6 from 0, while the two packages'
    forward values there differ by up to 9.3e-6 (fp32 sums in another
    order): its ReLU gate flips, which moves that layer's dbeta by 8% of
    max and grad_norm by 7.4e-4. That step is held gradient by gradient in
    test_ghost_bn_model_matches_jax; a one-image sample (the only ghost
    sample of a microbatch of 2) leaves 4 pixels a channel in the last
    blocks, where summation order alone moves grad_norm by 1.2e-5."""
    from test_torch_train import _compare

    from resnet_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from resnet_tpu.train.state import init_train_state as j_init_train_state
    from resnet_tpu.train.step import make_train_step as j_make_train_step
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import make_train_step

    ex = dict(kernels="pallas", conv_kernels="pallas", bn_stats_batch=k, grad_accum=accum)
    jc = jcfg.TrainConfig(model=jcfg.tiny_model_config(), execution=jcfg.ExecutionConfig(**ex))
    tc = tcfg.TrainConfig(model=tcfg.tiny_model_config(), execution=tcfg.ExecutionConfig(**ex))
    js = j_init_train_state(jc, jax.random.PRNGKey(11))
    ts = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    p0 = jax.tree.map(np.asarray, js.params)
    batch = next(SyntheticDataset(8, image_dim=16, num_classes=8, seed=5))
    jbatch = next(JSynthetic(8, image_dim=16, num_classes=8, seed=5))
    jstep, tstep = j_make_train_step(jc, donate=False), make_train_step(tc)
    for step in range(1, 4):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, batch)
        if step in (1, 3):
            _compare(ts, tm, js, jm, tc, step, p0)
