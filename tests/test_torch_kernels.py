"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU a wrapper runs its plain version (the CUDA kernels are checked
against that plain version on the card, tests/test_torch_gpu.py). Here the
plain version is held against the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, within 1e-4 of max|Pallas|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu_torch.kernels import adam, bn, build, conv, fused, matmul

TOL = 1e-4
COUNTERS = [(conv, "LAUNCHES"), (conv, "DX_LAUNCHES"), (conv, "DW_LAUNCHES"),
            (fused, "LAUNCHES"), (fused, "MASK_LAUNCHES"), (matmul, "LAUNCHES"),
            (matmul, "BWD_LAUNCHES"), (bn, "LAUNCHES"), (adam, "LAUNCHES")]


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture
def no_launch():
    """Reset the counters; the CPU path must leave them at 0."""
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    yield
    assert [getattr(mod, name) for mod, name in COUNTERS] == [0] * len(COUNTERS)


# tests/test_kernels.py TestPallasConv.CASES plus the 7x7/s2 stem at 32
CONV_CASES = [
    (16, 3, 8, 7, 2),
    (8, 8, 16, 1, 1),
    (8, 16, 16, 3, 1),
    (8, 16, 16, 3, 2),
    (8, 8, 32, 3, 2),
    (32, 3, 8, 7, 2),
]


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
def test_conv2d_matches_pallas(rng, no_launch, h, cin, cout, k, stride):
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    close(got, conv2d_pallas(jnp.asarray(x), jnp.asarray(w), stride, None, True))


def test_matmul_matches_pallas(rng, no_launch):
    from resnet_tpu.kernels import matmul as pallas_matmul

    a = rng.normal(size=(3, 2048)).astype(np.float32)
    b = (rng.normal(size=(2048, 1000)) * 0.01).astype(np.float32)
    got = matmul.matmul(torch.from_numpy(a), torch.from_numpy(b))
    close(got, pallas_matmul(jnp.asarray(a), jnp.asarray(b), True))


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 7, 7, 9)])
def test_add_relu_matches_pallas(rng, no_launch, shape):
    from resnet_tpu.kernels import add_relu as pallas_add_relu

    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    got = fused.add_relu(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pallas_add_relu(jnp.asarray(a), jnp.asarray(b), True)))


@pytest.mark.parametrize("call", [
    lambda: fused.add_relu(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)),
    lambda: fused.add_relu(torch.zeros(4, 4).t(), torch.zeros(4, 4)),
    lambda: fused.add_relu(torch.zeros(4), torch.zeros(5)),
    lambda: fused.add_relu(torch.zeros(4, device="meta"), torch.zeros(4, device="meta")),
    lambda: matmul.matmul(torch.zeros(2, 3), torch.zeros(4, 5)),
    lambda: matmul.matmul(torch.zeros(2, 3, dtype=torch.bfloat16),
                          torch.zeros(3, 5, dtype=torch.bfloat16)),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(2, 2, 3, 4)),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 4, 4)),
    lambda: conv.conv2d(torch.zeros(1, 7, 7, 3), torch.zeros(3, 3, 3, 4), 2),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 3, 4, device="meta")),
], ids=["f64", "strided", "shapes", "meta", "mm-shapes", "mm-bf16",
        "even-k", "cin", "ragged-stride", "mixed-devices"])
def test_wrappers_reject_what_the_kernels_do_not_take(no_launch, call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no library: load() raises instead of handing back anything
    that would compute on the CPU."""
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load()
    finally:
        build.load.cache_clear()
    assert not (tmp_path / "build").exists()


def test_sources_and_signatures_agree():
    """Every C entry point the loader binds is defined in csrc/, and the
    library hash changes with the sources."""
    text = "".join(p.read_text() for p in build.sources())
    for name, argtypes in build.SIGNATURES.items():
        assert f'extern "C" int {name}(' in text, name
        assert argtypes[-1] is build.ctypes.c_void_p  # the stream
    assert {p.name for p in build.sources()} == {
        "conv.cu", "matmul.cu", "add_relu.cu", "moments.cu", "adam.cu", "bn.cu",
        "fused_conv.cu"}
    assert build.library_path().name == f"libkernels-{build.source_hash()}.so"


# --- backward passes and the training kernels, against the JAX VJPs ---

def _vjp(fn, *args):
    """(output, VJP at a fixed cotangent) of a JAX function."""
    import jax

    out, pullback = jax.vjp(fn, *args)
    ct = jax.tree.map(lambda o: jnp.asarray(
        np.random.default_rng(7).normal(size=o.shape).astype(np.float32)), out)
    return out, ct, pullback(ct)


def _torch_vjp(fn, cts, *args):
    """(output, input gradients) of a port function at the given cotangents."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cts = cts if isinstance(cts, tuple) else (cts,)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(np.array(c)) for c in cts])
    return out, grads


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES[:5])
def test_conv2d_vjp_matches_pallas(rng, no_launch, h, cin, cout, k, stride):
    """dx and dW through the autograd Function's plain versions against the
    Pallas custom VJP in interpret mode (dilate + flip + conv, per-tap
    matmuls), within 1e-4 of max|JAX| per gradient."""
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    want, ct, (dx, dw) = _vjp(lambda a, b: conv2d_pallas(a, b, stride, None, True),
                              jnp.asarray(x), jnp.asarray(w))
    got, (gx, gw) = _torch_vjp(lambda a, b: conv.conv2d(a, b, stride), ct, x, w)
    close(got.detach(), want)
    close(gx, dx)
    close(gw, dw)


def test_conv2d_skips_dx_for_an_input_without_grad(rng, no_launch):
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)).astype(np.float32))
    w.requires_grad_(True)
    conv.conv2d(x, w, 2).sum().backward()
    assert x.grad is None and w.grad.shape == w.shape


@pytest.mark.parametrize("m,k,n", [(3, 2048, 1000), (8, 40, 24), (1, 7, 5)])
def test_matmul_vjp_matches_pallas(rng, no_launch, m, k, n):
    """g @ b^T and a^T @ g, ragged shapes included, within 1e-4."""
    from resnet_tpu.kernels import matmul as pallas_matmul

    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.01).astype(np.float32)
    want, ct, (da, db) = _vjp(lambda x, y: pallas_matmul(x, y, True),
                              jnp.asarray(a), jnp.asarray(b))
    got, (ga, gb) = _torch_vjp(matmul.matmul, ct, a, b)
    close(got.detach(), want)
    close(ga, da)
    close(gb, db)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 7, 7, 9)])
def test_add_relu_vjp_matches_pallas(rng, no_launch, shape):
    """The mask backward: the same gradient for both inputs, exactly; a sum
    of exactly 0 passes none (strict >)."""
    from resnet_tpu.kernels import add_relu as pallas_add_relu

    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    b.reshape(-1)[:5] = -a.reshape(-1)[:5]
    _, ct, (da, db) = _vjp(lambda x, y: pallas_add_relu(x, y, True),
                           jnp.asarray(a), jnp.asarray(b))
    _, (ga, gb) = _torch_vjp(fused.add_relu, ct, a, b)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(da))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(db))
    assert (ga.numpy().reshape(-1)[:5] == 0).all()


@pytest.mark.parametrize("m,c", [(2 * 8 * 8, 16), (1000, 33), (3, 2048)])
def test_moments_matches_pallas(rng, no_launch, m, c):
    """mean, biased var and their closed-form VJP against the Pallas stats
    kernel in interpret mode, within 1e-4 of max|JAX|."""
    from resnet_tpu.kernels.bn import moments as pallas_moments

    x = (rng.normal(size=(m, c)) * 3 + rng.normal(size=(1, c))).astype(np.float32)
    (mean, var), ct, (dx,) = _vjp(lambda a: pallas_moments(a, True), jnp.asarray(x))
    (gm, gv), (gx,) = _torch_vjp(bn.moments, ct, x)
    close(gm.detach(), mean)
    close(gv.detach(), var)
    close(gx, dx)
    pm, pv = bn.moments_reference(torch.from_numpy(x))
    np.testing.assert_array_equal(pm.numpy(), gm.detach().numpy())


@pytest.mark.parametrize("m", [1, 1000, 401408])
@pytest.mark.parametrize("c", [3, 64, 2048])
def test_moments_chunking_covers_every_row(m, c):
    rows = bn.chunk_rows(m, c)
    chunks = -(-m // rows)
    assert rows % 8 == 0 and rows >= 64 and chunks <= 65535
    assert (chunks - 1) * rows < m <= chunks * rows


@pytest.mark.parametrize("guard", [True, False])
def test_fused_adam_matches_pallas(rng, no_launch, guard):
    """The in-place list update against fused_adam_flat in interpret mode,
    with NaN and inf in the gradients and an inf parameter, the guard on and
    off: every finite value within 1e-6 of max|JAX| (fp32 elementwise, one
    rounding apart), non-finite positions identical."""
    from resnet_tpu.kernels import fused_adam_flat

    shapes = [(3, 3, 4, 8), (8,), (5, 7)]
    ps = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    gs = [rng.normal(size=s).astype(np.float32) * 1e-2 for s in shapes]
    ms = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in shapes]
    vs = [rng.normal(size=s).astype(np.float32) ** 2 * 1e-4 for s in shapes]
    gs[0].reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    ps[2].reshape(-1)[4] = np.inf
    hyper = dict(learning_rate=1e-3, weight_decay=1e-2, beta1=0.9, beta2=0.999,
                 eps=1e-7, cur_mean_decay=np.float32(0.9) ** 3,
                 cur_var_decay=np.float32(0.999) ** 3)
    flat = [jnp.asarray(np.concatenate([a.reshape(-1) for a in t]))
            for t in (ps, gs, ms, vs)]
    want = fused_adam_flat(*flat, nonfinite_guard=guard, interpret=True, **hyper)
    tp, tm, tv = ([torch.from_numpy(a.copy()) for a in t] for t in (ps, ms, vs))
    h = adam.hyper_row(hyper["learning_rate"], hyper["weight_decay"], hyper["beta1"],
                       hyper["beta2"], hyper["eps"], hyper["cur_mean_decay"],
                       hyper["cur_var_decay"], guard, "cpu")
    adam.fused_adam(tp, [torch.from_numpy(g) for g in gs], tm, tv, h)
    for got, w in zip((tp, tm, tv), want):
        got = torch.cat([t.reshape(-1) for t in got]).numpy()
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(w))
        fin = np.isfinite(w)
        assert np.abs(got[fin] - w[fin]).max() <= 1e-6 * np.abs(w[fin]).max()
    # the guard keeps m, v at a non-finite gradient and rolls the inf back
    assert np.isfinite(tm[0].numpy().reshape(-1)[:3]).all() == guard
    assert (tp[2].numpy().reshape(-1)[4] == np.inf) == guard


@pytest.mark.parametrize("m,n,k,want", [
    (147, 64, 401408, 88), (8, 1000, 2048, 4), (2048, 512, 1568, 1), (64, 64, 500, 1)])
def test_split_k_depends_on_the_shapes_only(m, n, k, want):
    assert build.split_k(m, n, k) == want


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (7, 1), (1, 2), (3, 2), (7, 2)])
def test_dx_phases_cover_every_tap_once(k, stride):
    """The phase split of the dx kernel: every tap (i, j) belongs to exactly
    one phase (py, px), the one whose input rows it reaches, and the phase
    weights hold w^T's taps in the kernel's (phase, ti, tj, co) order."""
    w = torch.arange(k * k * 2 * 3, dtype=torch.float32).reshape(k, k, 2, 3)
    wp = conv.dx_phase_weights(w, stride)
    assert wp.shape == (k * k * 3, 2)
    taps = [(py, first + stride * t)
            for py in range(stride)
            for first, count in [conv.phase_taps(py, k, stride)]
            for t in range(count)]
    assert sorted(i for _, i in taps) == list(range(k))
    for py, i in taps:  # tap i reaches input rows iy with (iy + k/2 - i) % s == 0
        assert (py + k // 2 - i) % stride == 0
    rows, off = [], 0
    for py in range(stride):
        for px in range(stride):
            fy, ny = conv.phase_taps(py, k, stride)
            fx, nx = conv.phase_taps(px, k, stride)
            for ti in range(ny):
                for tj in range(nx):
                    rows.append(w[fy + stride * ti, fx + stride * tj].t())
    assert torch.equal(wp, torch.cat(rows))
