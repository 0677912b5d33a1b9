"""bf16 in the port against the JAX package on the CPU.

* Kernel modules: the plain versions the bf16 wrappers run on CPU tensors
  (fp32 arithmetic on the upcast inputs, one rounding) against JAX's Pallas
  kernels in interpret mode on the same bf16 inputs, which accumulate in
  fp32 and round once: every bf16 element within one bf16 ulp of JAX's
  value plus 1e-5 of max|JAX| (two fp32 sums in different orders may round
  to neighbouring bf16 values); K4's fp32 statistics within 1e-5 of max.
* ``param_dtype='bfloat16'``: the parameters stay bf16 and the Adam state
  fp32; per-tensor and fused Adam match JAX after 2 steps; a dump of bf16
  parameters is byte-equal to JAX's and each package restores the other's.
* Serving with ``weights_dtype='bfloat16'`` against JAX's export, and the
  CLI's ``--export-dtype bfloat16``.
* The fused and whole-block engines in bf16 (tests/test_torch_bf16_engines.py
  holds them to JAX): with bf16 compute or bf16 parameters they train, and
  match kernels='xla' where JAX's function is the same one (bf16
  parameters under fp32 compute); the same configurations under NCHW or in
  eval run the standard path. K5, K6, K8, K9 and K10's wrappers take bf16
  data and return it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.kernels import bn, conv, fused, matmul

REL = 1e-5  # beside one bf16 ulp per element


def _bf16(a):
    """A numpy fp32 array rounded to bf16: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _ulp(w):
    """One bf16 ulp of each |w| (0 at 0)."""
    m, e = np.frexp(np.abs(w))
    return np.where(w != 0, np.ldexp(1.0, e - 8), 0.0)


def close_bf16(got, want):
    """got (torch) within one bf16 ulp of want (JAX) plus 1e-5 of max|want|
    for a bf16 result, within 1e-5 of max|want| for an fp32 one."""
    assert got.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[
        jnp.dtype(want.dtype).type]
    w = np.asarray(want.astype(jnp.float32), np.float64)
    g = got.float().numpy().astype(np.float64)
    assert g.shape == w.shape
    slack = (_ulp(w) if got.dtype is torch.bfloat16 else 0.0) + REL * np.abs(w).max()
    assert np.all(np.abs(g - w) <= slack), float(np.max(np.abs(g - w) - slack))


# (H=W, Cin, Cout, k, stride): k in {1, 3, 7}, stride in {1, 2}, Cin = 3
CONV_CASES = [(16, 3, 8, 7, 2), (16, 3, 8, 7, 1), (8, 8, 16, 1, 1), (8, 8, 32, 1, 2),
              (8, 16, 16, 3, 1), (8, 16, 16, 3, 2), (8, 3, 8, 3, 1)]


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
def test_conv2d_and_vjp_bf16_match_pallas(rng, h, cin, cout, k, stride):
    from resnet_tpu.kernels.conv import conv2d_pallas

    jx, tx = _bf16(rng.normal(size=(2, h, h, cin)))
    jw, tw = _bf16(rng.normal(size=(k, k, cin, cout)) * 0.2)
    jg, tg = _bf16(rng.normal(size=(2, h // stride, h // stride, cout)))
    y, vjp = jax.vjp(lambda x, w: conv2d_pallas(x, w, stride, None, True), jx, jw)
    close_bf16(conv.conv2d(tx, tw, stride), y)
    if k == 1 and stride > 1:
        return  # JAX's Pallas VJP cannot pad a 1x1/s2 gradient (a negative pad)
    dx, dw = vjp(jg)
    close_bf16(conv.conv2d_dx(tg, tw, tx.shape, stride), dx)
    close_bf16(conv.conv2d_dw(tx, tg, k, stride), dw)


@pytest.mark.parametrize("m,k,n", [(3, 256, 100), (8, 40, 24), (1, 7, 5)])
def test_matmul_and_vjp_bf16_match_pallas(rng, m, k, n):
    from resnet_tpu.kernels import matmul as j_matmul

    ja, ta = _bf16(rng.normal(size=(m, k)))
    jb, tb = _bf16(rng.normal(size=(k, n)) * 0.1)
    jg, tg = _bf16(rng.normal(size=(m, n)))
    y, vjp = jax.vjp(lambda a, b: j_matmul(a, b, True), ja, jb)
    da, db = vjp(jg)
    close_bf16(matmul.matmul(ta, tb), y)
    got_da, got_db = matmul.matmul_bwd(ta, tb, tg)
    close_bf16(got_da, da)
    close_bf16(got_db, db)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 7, 7, 9)])
def test_add_relu_and_mask_bf16_match_pallas(rng, shape):
    from resnet_tpu.kernels import add_relu

    ja, ta = _bf16(rng.normal(size=shape))
    jb, tb = _bf16(rng.normal(size=shape))
    jg, tg = _bf16(rng.normal(size=shape))
    y, vjp = jax.vjp(lambda a, b: add_relu(a, b, True), ja, jb)
    da, db = vjp(jg)
    close_bf16(fused.add_relu(ta, tb), y)
    got = fused.add_relu_mask(ta, tb, tg)
    close_bf16(got, da)
    close_bf16(got, db)


@pytest.mark.parametrize("m,c", [(200, 16), (1000, 33)])
def test_moments_and_vjp_bf16_match_pallas(rng, m, c):
    """fp32 statistics of bf16 rows (bn.py:77, :101), and the VJP's dx in
    fp32 cast to bf16 (bn.py:120-125)."""
    from resnet_tpu.kernels.bn import moments as j_moments

    jx, tx = _bf16(rng.normal(2.0, 3.0, size=(m, c)))
    (mean, var), vjp = jax.vjp(lambda x: j_moments(x, True), jx)
    dmean = rng.normal(size=c).astype(np.float32)
    dvar = rng.normal(size=c).astype(np.float32)
    (dx,) = vjp((jnp.asarray(dmean), jnp.asarray(dvar)))
    tx.requires_grad_(True)
    got_mean, got_var = bn.moments(tx)
    close_bf16(got_mean.detach(), mean)
    close_bf16(got_var.detach(), var)
    got_dx, = torch.autograd.grad((got_mean, got_var), tx,
                                  (torch.from_numpy(dmean), torch.from_numpy(dvar)))
    close_bf16(got_dx, dx)


# ----------------------------------------------- bf16 parameters and Adam


def _bf16_param_configs(fused_adam):
    jc = jcfg.TrainConfig(model=jcfg.tiny_model_config(),
                          execution=jcfg.ExecutionConfig(param_dtype="bfloat16",
                                                         pallas_interpret=True),
                          optimizer=jcfg.OptimizerConfig(fused=fused_adam,
                                                         learning_rate=1e-3))
    tc = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                          execution=tcfg.ExecutionConfig(param_dtype="bfloat16"),
                          optimizer=tcfg.OptimizerConfig(fused=fused_adam,
                                                         learning_rate=1e-3))
    return jc, tc


@pytest.mark.parametrize("fused_adam", [False, True], ids=["per-tensor", "fused"])
def test_bf16_parameters_train_as_jax(fused_adam):
    """Two Adam steps from one bridged state with bf16 parameters: they stay
    bf16 and the moments fp32 (adam.py:45, :145-166). The gradients of bf16
    parameters are bf16 in both packages (the cast's VJP), so an fp32
    gradient that differs in its last bits may round to the neighbouring
    bf16 value: each parameter leaf within one bf16 ulp of its max plus
    2 lr per step (an update whose gradient is near 0 may flip sign), the
    moments within two bf16 ulps of their max (v holds g squared), the loss
    within 1e-5."""
    from resnet_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from resnet_tpu.train.state import init_train_state as j_init
    from resnet_tpu.train.step import make_train_step as j_make_train_step
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import make_train_step

    jc, tc = _bf16_param_configs(fused_adam)
    js = j_init(jc, jax.random.PRNGKey(3))
    ts = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert all(p.dtype is torch.bfloat16 for p in bridge.leaves(ts.params))
    batch = next(SyntheticDataset(4, image_dim=16, num_classes=8, seed=2))
    jbatch = next(JSynthetic(4, image_dim=16, num_classes=8, seed=2))
    jstep, tstep = j_make_train_step(jc, donate=False), make_train_step(tc)
    for _ in range(2):
        js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert all(p.dtype is torch.bfloat16 for p in bridge.leaves(ts.params))
    assert all(m.dtype is torch.float32 for m in bridge.leaves(ts.opt_state.means))
    lr = tc.optimizer.learning_rate
    for (path, got), (_, want) in zip(bridge.flatten(bridge.to_numpy(ts.params)),
                                      bridge.flatten(jax.tree.map(
                                          lambda a: np.asarray(a, np.float32), js.params))):
        scale = float(np.abs(want).max())
        assert np.abs(got - want).max() <= 2.0 ** -8 * scale + 2 * lr * 2, path
    for tree_t, tree_j in ((ts.opt_state.means, js.opt_state.means),
                           (ts.opt_state.vars, js.opt_state.vars)):
        for (path, got), (_, want) in zip(bridge.flatten(bridge.to_numpy(tree_t)),
                                          bridge.flatten(jax.tree.map(np.asarray, tree_j))):
            assert np.abs(got - want).max() <= 2.0 ** -7 * float(np.abs(want).max()), path


def test_bf16_parameter_dumps_are_jax_bytes_both_ways(tmp_path):
    """A dump of bf16 parameters is byte-equal to JAX's (every leaf written
    as fp32, checkpoint.py:71-83 there), and each package restores the
    other's into bf16 leaves, bit for bit."""
    import os

    from resnet_tpu.data.shards import ShardCursor as JShardCursor
    from resnet_tpu.train import checkpoint as j_ckpt
    from resnet_tpu.train.state import init_train_state as j_init
    from resnet_tpu_torch.data import ShardCursor
    from resnet_tpu_torch.train import checkpoint as t_ckpt

    jc, tc = _bf16_param_configs(False)
    js = jax.device_get(j_init(jc, jax.random.PRNGKey(4)))
    ts = bridge.train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_ckpt.save_checkpoint(jdir, 0, js, JShardCursor())
    t_ckpt.save_checkpoint(tdir, 0, ts, ShardCursor())
    pdir = os.path.join("00000000", "model_params")
    names = sorted(os.listdir(os.path.join(jdir, pdir)))
    assert names == sorted(os.listdir(os.path.join(tdir, pdir))) and names
    for name in names:
        with open(os.path.join(jdir, pdir, name), "rb") as a, \
                open(os.path.join(tdir, pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    got, _ = t_ckpt.restore_checkpoint(jdir, 0, ts)
    want, _ = j_ckpt.restore_checkpoint(tdir, 0, js)
    for (path, a), (_, b) in zip(bridge.flatten(got.params), bridge.flatten(ts.params)):
        assert a.dtype is torch.bfloat16 and torch.equal(a, b), path
    for a, b in zip(jax.tree.leaves(want.params), jax.tree.leaves(js.params), strict=True):
        assert a.dtype == jnp.bfloat16 and np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- serving


def _served_logits(weights_dtype, layout="NHWC"):
    """(JAX fp32 export, JAX export, port export) logits of a perturbed tiny
    model on one batch, with weights cast to ``weights_dtype``."""
    from resnet_tpu.export import export_inference as j_export
    from resnet_tpu.models import init_bn_state as j_init_bn_state
    from resnet_tpu.models import init_params as j_init_params
    from resnet_tpu_torch.export import export_inference

    jm = jcfg.tiny_model_config()
    rng = np.random.default_rng(8)
    params = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(8), jm))
    state = jax.tree.map(lambda a: (np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                                    ).astype(np.float32), j_init_bn_state(jm))
    x = rng.normal(0, 50, (3, 16, 16, 3)).astype(np.float32)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    jecfg, tecfg = jcfg.ExecutionConfig(layout=layout), tcfg.ExecutionConfig(layout=layout)
    want32 = np.asarray(j_export(params, jm, bn_state=state, ecfg=jecfg).call(x))
    want = np.asarray(j_export(params, jm, bn_state=state, ecfg=jecfg,
                               weights_dtype=weights_dtype).call(x))
    model = export_inference(bridge.params_from_numpy(params, device="cpu"),
                             tcfg.tiny_model_config(),
                             bn_state=bridge.bn_state_from_numpy(state, device="cpu"),
                             ecfg=tecfg, weights_dtype=weights_dtype)
    assert all(b.dtype is torch.bfloat16 for b in model.buffers())
    got = model.call(x)
    assert got.dtype is torch.float32
    return want32, want, got.numpy()


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_bf16_weights_export_matches_jax(layout):
    """export_inference(..., weights_dtype='bfloat16') casts the parameters
    and the running statistics; its fp32 logits are within 2x JAX's own gap
    between its bf16-weight and fp32 exports (tests/test_export.py:126) of
    JAX's bf16-weight logits."""
    want32, want, got = _served_logits("bfloat16", layout)
    gap = np.abs(want - want32).max()
    assert gap > 0
    assert np.abs(got - want).max() <= 2 * gap


def test_cli_export_dtype_bfloat16(tmp_path):
    from resnet_tpu_torch.export import load_inference
    from resnet_tpu_torch.train.cli import main

    art = str(tmp_path / "model.pt")
    main(["--model", "tiny", "--synthetic", "--batch-size", "8", "--checkpoint-dir",
          str(tmp_path / "dumps"), "--log-every", "0", "--device", "cpu", "--export", art,
          "--export-dtype", "bfloat16"])
    served = load_inference(art, device="cpu")
    state = served.program.state_dict
    assert state and all(b.dtype is torch.bfloat16 for b in state.values())
    logits = served.call(np.zeros((2, 16, 16, 3), np.float32))
    assert logits.dtype is torch.float32 and np.isfinite(logits.numpy()).all()


# ------------------------------------------- the fused and whole-block engines


def _tiny_forward(ecfg, train=True, layout="NHWC"):
    """forward of a tiny model with two identity blocks (so 'blockfused'
    routes some to K10) on zeros, with running statistics."""
    from resnet_tpu_torch.models import forward, init_bn_state, init_params

    mcfg = tcfg.tiny_model_config(block_sizes=(2, 2))
    params = init_params(torch.Generator().manual_seed(0), mcfg, device="cpu",
                         dtype=ecfg.pdtype)
    x = torch.zeros((2, 16, 16, 3) if layout == "NHWC" else (2, 3, 16, 16))
    return forward(params, x, mcfg, ecfg, train=train,
                   bn_state=init_bn_state(mcfg, device="cpu"))[0]


ENGINES = ["fused", "hybrid", "fusedxla", "blockfused"]


def _engine_step(ecfg):
    """Two Adam steps (lr 1e-3) of the tiny model with two identity blocks
    on one seeded batch: (the first step's summed loss and logits from
    loss_and_grads, the two steps' losses, the parameters before and after)."""
    from resnet_tpu_torch.train import init_train_state, loss_and_grads, make_train_step

    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(block_sizes=(2, 2)), execution=ecfg,
                           optimizer=tcfg.OptimizerConfig(learning_rate=1e-3))
    state = init_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(5)
    batch = {"images": torch.from_numpy(rng.normal(0, 50, (4, 16, 16, 3)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 8, 4).astype(np.int64))}
    loss, logits, _, _ = loss_and_grads(state.params, batch, state.bn_state, cfg)
    p0, step, losses = bridge.leaves(state.params), make_train_step(cfg), []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    return loss, logits, losses, p0, bridge.leaves(state.params)


@pytest.mark.parametrize("dtype", ["compute_dtype", "param_dtype"])
@pytest.mark.parametrize("kernels", ENGINES)
def test_bf16_fused_and_whole_block_engines_train(kernels, dtype):
    """Two steps under the engine with bf16 compute or bf16 parameters:
    finite losses, the second below the first, the parameters kept in their
    dtype and moved (a bf16 γ of 1 does not move by an update of 1e-3, one
    eighth of its ulp, so not every leaf). The first step's summed loss and logits against
    kernels='xla' from the same state: with bf16 parameters alone the
    compute is fp32 and JAX's engine computes the same function as its
    standard path, so within 1e-4 of max (the fp32 tests' tolerance); with
    bf16 compute the two round at other places (tests/test_torch_bf16_engines.py
    holds each engine to JAX's), so within 2x the standard path's own gap
    between its bf16 and fp32 runs plus 1e-5, of max."""
    ecfg = tcfg.ExecutionConfig(kernels=kernels, **{dtype: "bfloat16"})
    loss, logits, losses, p0, p1 = _engine_step(ecfg)
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
    assert all(a.dtype == b.dtype == ecfg.pdtype for a, b in zip(p0, p1))
    assert sum(not torch.equal(a, b) for a, b in zip(p0, p1)) > len(p0) // 2
    xla_loss, xla_logits, *_ = _engine_step(dataclasses.replace(ecfg, kernels="xla"))
    if dtype == "param_dtype":
        tol = 1e-4
    else:
        f32_loss, f32_logits, *_ = _engine_step(dataclasses.replace(
            ecfg, kernels="xla", compute_dtype="float32"))
        tol = 2 * max(abs(xla_loss.item() - f32_loss.item()) / abs(xla_loss.item()),
                      ((xla_logits - f32_logits).abs().max()
                       / xla_logits.abs().max()).item()) + 1e-5
    assert abs(loss.item() - xla_loss.item()) <= tol * abs(xla_loss.item())
    assert (logits - xla_logits).abs().max() <= tol * xla_logits.abs().max()


@pytest.mark.parametrize("kernels", ENGINES)
def test_bf16_engines_run_the_standard_path_under_nchw_and_in_eval(kernels):
    """JAX sends NCHW and eval runs of the fused and whole-block engines down
    the standard path (models/resnet.py:126, :276-284); so does the port,
    in bf16 too, to the same logits as kernels='xla'."""
    for layout, train in (("NCHW", True), ("NHWC", False)):
        ecfg = tcfg.ExecutionConfig(kernels=kernels, compute_dtype="bfloat16", layout=layout)
        plain = dataclasses.replace(ecfg, kernels="xla")
        got = _tiny_forward(ecfg, train, layout)
        assert torch.equal(got, _tiny_forward(plain, train, layout))


def test_bf16_tensors_reach_k5_k6_k8_k9_k10():
    """K5 (bn_apply, bias_act), K6 (batch_norm_act), K8, K9 and K10 take bf16
    data with fp32 rows and return bf16 data (the statistics fp32); K10's
    tf32 weight split takes fp32 weights only."""
    from resnet_tpu_torch.kernels import block_fused, fused_conv

    b = torch.bfloat16
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=g).to(b)
    row = torch.ones(8)
    assert bn.bn_apply(x, row, row, relu=True).dtype is b
    assert fused.bias_act(x, row, row).dtype is b
    y, mean, var = bn.batch_norm_act(x, row, row)
    assert y.dtype is b and mean.dtype is var.dtype is torch.float32
    assert fused_conv.fused_join(x, row, row, x, row, row).dtype is b
    y, sums = fused_conv.fused_conv(x.view(1, 2, 2, 8), torch.ones(1, 1, 8, 8).to(b),
                                    row, row, 1)
    assert y.dtype is b and sums.dtype is torch.float32
    xb = torch.rand(1, 4, 4, 16, generator=g).to(b)
    rows = [torch.ones(n) for n in (4, 4, 4, 4, 16, 16)]
    out, *s = block_fused.block_fused(
        xb, torch.randn(16, 4, generator=g), torch.randn(3, 3, 4, 4, generator=g),
        torch.randn(4, 16, generator=g), *rows, 1e-7)
    assert out.dtype is b and all(t.dtype is torch.float32 for t in s)
    with pytest.raises(ValueError, match="fp32 weights"):
        block_fused.split_tf32(x)
