"""The port's CUDA kernels against their plain PyTorch versions on the card.

The same checks as phase 3 of chip_smoke.py (resnet_tpu_torch.kernels.checks),
one test per kernel and shape, so each can be rerun alone on a GPU:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Without a CUDA device every test here skips.
"""

import pytest
import torch

from resnet_tpu_torch.kernels import checks

pytestmark = pytest.mark.gpu

CASES = [(name, case) for name, (_, cases) in checks.KERNELS.items() for case in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks.fp32_strict()


@pytest.mark.parametrize("name,case", CASES, ids=[f"{n}: {c[0]}" for n, c in CASES])
def test_kernel_matches_plain(cuda, name, case):
    mod = checks.KERNELS[name][0]
    before = mod.LAUNCHES
    r = checks.check_case(name, case, timing=False)
    assert r["rel_err"] <= checks.REL_TOL
    assert mod.LAUNCHES == before + 1  # the kernel ran, not the plain version


def test_cuda_input_requiring_grad_is_refused(cuda):
    from resnet_tpu_torch.kernels import fused

    a = torch.ones(8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        fused.add_relu(a, torch.ones(8, device="cuda"))
