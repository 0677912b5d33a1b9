"""Each CUDA kernel against its plain version, at the serving slice's shapes.

Shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``; runs on a CUDA
device only. The plain side must run in true fp32, so ``fp32_strict()``
turns TF32 off in cuDNN and cuBLAS. A case passes when
max|kernel - plain| <= 1e-4 * max|plain|. Times are the median of
CUDA-event timings of single calls after warm-up.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Tuple

import torch

from . import conv, fused, matmul

REL_TOL = 1e-4

# (label, batch, H=W, Cin, Cout, k, stride): one of each conv ResNet-50 runs
CONV_CASES: List[Tuple[str, int, int, int, int, int, int]] = [
    ("stem 7x7/s2 224->112 3->64", 8, 224, 3, 64, 7, 2),
    ("1x1 56^2 64->64", 8, 56, 64, 64, 1, 1),
    ("1x1 56^2 64->256", 8, 56, 64, 256, 1, 1),
    ("3x3/s1 56^2 64->64", 8, 56, 64, 64, 3, 1),
    ("3x3/s2 56->28 128->128", 8, 56, 128, 128, 3, 2),
    ("proj 3x3/s2 56->28 256->512", 8, 56, 256, 512, 3, 2),
    ("1x1 7^2 2048->512", 8, 7, 2048, 512, 1, 1),
]
# (label, shape, storage offset in floats): the join at stage 1, a size
# that leaves a scalar tail, and a misaligned start that takes no float4
ADD_RELU_CASES: List[Tuple[str, Tuple[int, ...], int]] = [
    ("join (8,56,56,256)", (8, 56, 56, 256), 0),
    ("odd size (3,7,7,9)", (3, 7, 7, 9), 0),
    ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1),
]
# (label, M, K, N): the FC head at batch 8 and at a ragged M
MATMUL_CASES: List[Tuple[str, int, int, int]] = [
    ("fc (8,2048)@(2048,1000)", 8, 2048, 1000),
    ("fc (3,2048)@(2048,1000)", 3, 2048, 1000),
]

KERNELS = {
    "conv2d": (conv, CONV_CASES),
    "add_relu": (fused, ADD_RELU_CASES),
    "matmul": (matmul, MATMUL_CASES),
}


def fp32_strict() -> None:
    """True fp32 on the plain side: no TF32 in cuDNN convs or cuBLAS GEMMs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def median_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(kernel: str, case, gen: torch.Generator, device):
    def randn(*shape, scale=1.0, offset=0):
        n = 1
        for s in shape:
            n *= s
        flat = torch.randn(n + offset, generator=gen, device=device) * scale
        return flat[offset:].view(shape)

    if kernel == "conv2d":
        _, n, h, cin, cout, k, s = case
        x = randn(n, h, h, cin)
        w = randn(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5)
        return (
            lambda: conv.conv2d(x, w, s),
            lambda: conv.conv2d_reference(x, w, s),
        )
    if kernel == "add_relu":
        _, shape, offset = case
        a, b = randn(*shape, offset=offset), randn(*shape, offset=offset)
        return (lambda: fused.add_relu(a, b),
                lambda: fused.add_relu_reference(a, b))
    _, m, k, n = case
    a, b = randn(m, k), randn(k, n, scale=0.01)
    return (lambda: matmul.matmul(a, b),
            lambda: matmul.matmul_reference(a, b))


def check_case(kernel: str, case, *, device="cuda", seed: int = 0,
               timing: bool = True) -> Dict[str, object]:
    """Run one case; raise RuntimeError where the kernel disagrees.

    Returns {kernel, case, max_abs_err, rel_err, ms, plain_ms}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    run, plain = _inputs(kernel, case, gen, device)
    got, want = run(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise RuntimeError(f"{kernel} {case[0]}: shape {tuple(got.shape)} "
                           f"vs plain {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rel = err / scale if scale else err
    if not (rel <= REL_TOL):
        raise RuntimeError(f"{kernel} {case[0]}: max|kernel - plain| = {err} "
                           f"is {rel:.3e} of max|plain| = {scale} > {REL_TOL}")
    out = {"kernel": kernel, "case": case[0], "max_abs_err": err,
           "rel_err": rel}
    if timing:
        out["ms"] = median_ms(run)
        out["plain_ms"] = median_ms(plain)
    return out
