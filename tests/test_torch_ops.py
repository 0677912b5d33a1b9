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


def test_batch_norm_needs_statistics():
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(NotImplementedError, match="A2"):
        ops.batch_norm(x, torch.ones(3), torch.zeros(3))


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
