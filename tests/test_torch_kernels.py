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

from resnet_tpu_torch.kernels import build, conv, fused, matmul

TOL = 1e-4


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture
def no_launch():
    """Reset the counters; the CPU path must leave them at 0."""
    for mod in (conv, fused, matmul):
        mod.LAUNCHES = 0
    yield
    assert (conv.LAUNCHES, fused.LAUNCHES, matmul.LAUNCHES) == (0, 0, 0)


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
    assert {p.name for p in build.sources()} == {"conv.cu", "matmul.cu", "add_relu.cu"}
    assert build.library_path().name == f"libkernels-{build.source_hash()}.so"
