"""The port's CUDA kernels against their plain PyTorch versions on the card.

The same checks as phase 3 of chip_smoke.py (resnet_tpu_torch.kernels.checks),
one test per kernel and shape, so each can be rerun alone on a GPU:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

Without a CUDA device every test here skips.
"""

import pytest
import torch

from resnet_tpu_torch.kernels import checks

pytestmark = pytest.mark.gpu

CASES = [(name, case) for name, (*_, cases) in checks.KERNELS.items() for case in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks.fp32_strict()


@pytest.mark.parametrize("name,case", CASES, ids=[f"{n}: {c[0]}" for n, c in CASES])
def test_kernel_matches_plain(cuda, name, case):
    mod, counter, per_call, _ = checks.KERNELS[name]
    before = getattr(mod, counter)
    r = checks.check_case(name, case, timing=False)
    assert r["rel_err"] <= checks.REL_TOL
    # the kernel ran, not the plain version
    assert getattr(mod, counter) == before + per_call


def test_backward_on_cuda_moves_the_backward_counters(cuda):
    """A tiny conv -> add_relu -> matmul graph on the card: its backward runs
    the dx, dW, mask and matmul-backward kernels, and matches the plain
    versions' gradients on the CPU."""
    from resnet_tpu_torch.kernels import conv, fused, matmul

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 4, generator=gen)
    w = torch.randn(3, 3, 4, 6, generator=gen) * 0.2
    fc = torch.randn(6 * 16, 5, generator=gen) * 0.1

    def run(device):
        leaves = [t.to(device).requires_grad_(True) for t in (x, w, fc)]
        y = conv.conv2d(leaves[0], leaves[1], 2)
        y = fused.add_relu(y, y * 0.5)
        out = matmul.matmul(y.reshape(2, -1), leaves[2])
        return torch.autograd.grad(out.square().sum(), leaves)

    before = (conv.DX_LAUNCHES, conv.DW_LAUNCHES, fused.MASK_LAUNCHES,
              matmul.BWD_LAUNCHES)
    got = run("cuda")
    after = (conv.DX_LAUNCHES, conv.DW_LAUNCHES, fused.MASK_LAUNCHES,
             matmul.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 2]
    for g, want in zip(got, run("cpu")):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-5)


def test_fused_conv_keeps_the_halo_at_zero_on_cuda(cuda):
    """K8 with scale 0 and shift 1: every in-image element of u is 1, so an
    all-ones 3x3 filter counts each window's in-image taps (4 in a corner,
    6 on an edge, 9 inside, times Cin); relu(shift) in the halo would make
    them all 9. Stride 1 and 2, and the sums of those counts."""
    from resnet_tpu_torch.kernels import fused_conv

    cin = 3
    x = torch.randn(1, 6, 6, cin, device="cuda")
    w = torch.ones(3, 3, cin, 1, device="cuda")
    scale, shift = torch.zeros(cin, device="cuda"), torch.ones(cin, device="cuda")
    taps = torch.tensor([2.0, 3, 3, 3, 3, 2])
    for stride in (1, 2):
        before = fused_conv.LAUNCHES
        y, sums = fused_conv.fused_conv(x, w, scale, shift, stride)
        assert fused_conv.LAUNCHES == before + 1
        want = torch.outer(taps, taps)[::stride, ::stride] * cin
        assert torch.equal(y[0, :, :, 0].cpu(), want)
        assert torch.equal(sums[:, 0].cpu(), torch.stack([want.sum(), (want ** 2).sum()]))
