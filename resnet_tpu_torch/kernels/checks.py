"""Each CUDA kernel against its plain version, at the serving and training
shapes of ResNet-50.

Shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``; runs on a CUDA
device only. The plain side must run in true fp32, so ``fp32_strict()``
turns TF32 off in cuDNN and cuBLAS. A case passes when
max|kernel - plain| <= 1e-4 * max|plain| for every output (fp32 summed in
another order gives ~1e-6; an indexing fault shows as O(1)). The batch-norm
statistics sum up to 2,809,856 rows (the stem at batch 224): in fp32 that
order alone moves the sums by ~1e-6 relative, so the same 1e-4 holds for
them. For Adam, the positions
left non-finite must agree exactly as well.

The fused conv (K8) is held on y, Σy and Σy² each against its own max, the
whole-block kernel (K10) likewise on out, r, s, e, each block's Σ and Σ²
rows and the six (scale, shift) rows it applied, and
the BN backward (K6) on y, dx, dγ and dβ through ``batch_norm_act``'s forward
and backward (the kernel path: K4, K5, K6) against ``bn_act_reference``'s
forward and the plain backward at the statistics the kernel path saved, so
that both see the same ReLU gate.

Times are the median of CUDA-event timings of single calls after warm-up
(for K6, the backward kernel alone against the plain backward): ``ms``
includes the host's time to enqueue the call wherever that is longer than
the device's work (a small kernel behind a Python wrapper). Each is
repeated as ``device_ms``, the device time of the kernels one call launches
(torch.profiler), so that a small kernel can be held against a library
call without the two host paths in the way, and as ``host_us``, the host's
time per call over 200 calls enqueued back to back: the cost a host-bound
step pays for each call. Beside the
kernel (``ms``) and its plain version (``plain_ms``), a case times one
PyTorch library call computing the same function where there is one
(``library_ms``, a yardstick the port never calls; None otherwise; for K8
``F.conv2d`` of the same shape, which is the conv alone and less work), and
gives the least time the card could take for the work (``bound_ms``): the
larger of the bytes the function must move (inputs read once, outputs
written once) over 3.35 TB/s and the operations it does over the H100
SXM's peak for their type, with ``bound_by`` naming the one that sets it:
the FLOPs over the 67 TFLOP/s fp32 peak, and for the conv forward, dW and
dx, the fused conv (K8) and the whole-block kernel (K10), whose kernels do
each fp32 product as three TF32 products on the tensor cores
(``csrc/tc_gemm.cuh``; K10's ``csrc/wg_gemm.cuh``), three times their FLOPs
over 495 TFLOP/s; for those
``fp32_fma_bound_ms`` gives the bound at the fp32 FMA peak beside it.

K10's weight split (``check_split``, ``SPLIT_CASES``) must equal its plain
version bit for bit, on weights with exact ties at the dropped bits.

The split-K GEMMs, the FC backward and the BN statistics
(``REPEAT_KERNELS``) are also run a second time on the same inputs and must
give the same bits: their partials are added in split order, or in one
fixed order inside a block, with no atomics in any sum. A case marked
exact (the fused conv's halo case, integer-valued so that every order of
summation is exact) must match its plain version bit for bit.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import adam, block_fused, bn, conv, fused, fused_conv, matmul

REL_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, tensor cores

# (label, batch, H=W, Cin, Cout, k, stride): one of each conv ResNet-50 runs
_CONV_SHAPES: List[Tuple[str, int, int, int, int, int]] = [
    ("stem 7x7/s2 224->112 3->64", 224, 3, 64, 7, 2),
    ("1x1 56^2 64->64", 56, 64, 64, 1, 1),
    ("1x1 56^2 64->256", 56, 64, 256, 1, 1),
    ("3x3/s1 56^2 64->64", 56, 64, 64, 3, 1),
    ("3x3/s2 56->28 128->128", 56, 128, 128, 3, 2),
    ("proj 3x3/s2 56->28 256->512", 56, 256, 512, 3, 2),
    ("1x1 7^2 2048->512", 7, 2048, 512, 1, 1),
]
CONV_CASES = [(label, 8, *shape) for label, *shape in _CONV_SHAPES]
TRAIN_CONV_CASES = [(label, 32, *shape) for label, *shape in _CONV_SHAPES]
# the stem at the clean variant's batch 224: M = 224 * 112 * 112 = 2,809,856
# output rows, 7x the largest view of batch 32 (build.tc_split's waves,
# the kernels' row indexing)
STEM_224 = ("stem 7x7/s2 224->112 3->64, batch 224", 224, 224, 3, 64, 7, 2)
# the forward: serving (batch 8) and training (batch 32) shapes, then widths
# not a multiple of 4 (4-byte copies of x and w) at stride 1 on 64-wide
# tiles and at stride 2 on 128-wide ones, then the stem at batch 224
FWD_CONV_CASES = [(f"{label}, batch {n}", n, *shape)
                  for label, n, *shape in CONV_CASES + TRAIN_CONV_CASES] + [
    ("ragged 3x3 7^2 9->33, batch 2", 2, 7, 9, 33, 3, 1),
    ("ragged 3x3/s2 14->7 130->66, batch 2", 2, 14, 130, 66, 3, 2),
    STEM_224,
]
# the training step never takes the images' gradient, so no stem dx at
# batch 32; then stage 4's 3x3, whose GEMM splits K in 5 (build.tc_split),
# and widths not a multiple of 4 (4-byte copies of g and w) at stride 1 on
# 128-wide tiles and at stride 2 on 64-wide ones; then the stem's shape at
# batch 224 (Cin = 3: 4-byte copies over the largest M)
TRAIN_DX_CASES = TRAIN_CONV_CASES[1:] + [
    ("split K 3x3/s1 7^2 512->512", 32, 7, 512, 512, 3, 1),
    ("ragged 3x3 7^2 130->33, batch 2", 2, 7, 130, 33, 3, 1),
    ("ragged 3x3/s2 14->7 9->33, batch 2", 2, 14, 9, 33, 3, 2),
    STEM_224,
]
# dW: the training shapes, then widths not a multiple of 4 (4-byte copies
# of x and g) and a depth whose last split chunk is not a whole K-step
# (build.tc_split: 3 chunks of 512, 512 and 434 pixels), then the stem at
# batch 224 (2.8 M pixels of depth)
TRAIN_DW_CASES = TRAIN_CONV_CASES + [
    ("ragged 3x3 7^2 9->33, batch 2", 2, 7, 9, 33, 3, 1),
    ("split K 3x3 27^2 20->24, batch 2, ragged last chunk", 2, 27, 20, 24, 3, 1),
    STEM_224,
]
# (label, shape, storage offset in floats): the join at stage 1, a size
# that leaves a scalar tail, and a misaligned start that takes no float4
ADD_RELU_CASES: List[Tuple[str, Tuple[int, ...], int]] = [
    ("join (8,56,56,256)", (8, 56, 56, 256), 0),
    ("odd size (3,7,7,9)", (3, 7, 7, 9), 0),
    ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1),
    ("join (224,56,56,256), batch 224", (224, 56, 56, 256), 0),
]
ADD_RELU_MASK_CASES = [
    ("join bwd (32,56,56,256)", (32, 56, 56, 256), 0),
    ("odd size (3,7,7,9)", (3, 7, 7, 9), 0),
    ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1),
    ("join bwd (224,56,56,256), batch 224", (224, 56, 56, 256), 0),
]
# (label, M, K, N, storage offset of B in floats), the label ending in the
# route (matmul.matmul_route): the FC head when serving at batch 8 and 3,
# at batch 1 and at the training batch 32, one M above the skinny limit,
# and a ragged N (N % 4 != 0) and a misaligned B, which take 4-byte copies
MATMUL_CASES: List[Tuple[str, int, int, int, int]] = [
    (f"{label} ({m},{k})@({k},{n}) {matmul.matmul_route(m, n, k)}", m, k, n, offset)
    for label, m, k, n, offset in [("fc", 8, 2048, 1000, 0), ("fc", 3, 2048, 1000, 0),
                                   ("fc", 1, 2048, 1000, 0), ("fc", 32, 2048, 1000, 0),
                                   ("fc", 64, 2048, 1000, 0),
                                   ("ragged N", 5, 300, 33, 0),
                                   ("misaligned B", 8, 2048, 1000, 1)]
]
# (label, M, K, N, storage offset of b in floats, need da, need db): the FC
# backward at the training batch, a ragged N with a misaligned b (4-byte
# copies), the FC on frozen features (db alone), and two row tiles of da
MATMUL_BWD_CASES: List[Tuple[str, int, int, int, int, bool, bool]] = [
    ("fc bwd (32,2048)@(2048,1000)", 32, 2048, 1000, 0, True, True),
    ("ragged N (5,300)@(300,33), b misaligned", 5, 300, 33, 1, True, True),
    ("db only (32,2048)@(2048,1000), frozen features", 32, 2048, 1000, 0, False, True),
    ("(64,2048)@(2048,1000), two da row tiles", 64, 2048, 1000, 0, True, True),
]
# (label, rows M, channels C): BN statistics at batch 32, then the stem and
# stage 1 at batch 224 (180 M elements each, 7x batch 32's rows)
MOMENTS_CASES: List[Tuple[str, int, int]] = [
    ("stem (32*112*112, 64)", 32 * 112 * 112, 64),
    ("stage 1 (32*56*56, 256)", 32 * 56 * 56, 256),
    ("stage 4 (32*7*7, 2048)", 32 * 7 * 7, 2048),
    ("ragged (1000, 33)", 1000, 33),
    ("stem (224*112*112, 64), batch 224", 224 * 112 * 112, 64),
    ("stage 1 (224*56*56, 256), batch 224", 224 * 56 * 56, 256),
]
# (label, model name): Adam over that model's parameter list
ADAM_CASES = [("resnet50 params, non-finite injected", "resnet50")]
# (label, batch, H=W, Cin, Cout, k, stride, prologue, cap): the fused
# engine's conv sites at batch 32, a capped one, three ragged ones at
# batch 2 (4-byte copies), the second deep enough (K = 9 * 129) that the
# GEMM splits K and the statistics come from the summed y, the third on
# 128-wide tiles; and the halo case (_fused_conv_case): shift > 0 on every
# channel, so act(shift) != 0, on integer values that every order of
# summation keeps exact, held to the plain version bit for bit
FUSED_CONV_CASES = [
    ("reduce 1x1 56^2 256->64", 32, 56, 256, 64, 1, 1, False, None),
    ("spatial 3x3/s1 56^2 64->64, prologue", 32, 56, 64, 64, 3, 1, True, None),
    ("spatial 3x3/s2 56->28 128->128, prologue", 32, 56, 128, 128, 3, 2, True, None),
    ("expand 1x1 7^2 512->2048, prologue", 32, 7, 512, 2048, 1, 1, True, None),
    ("proj 3x3/s2 56->28 256->512", 32, 56, 256, 512, 3, 2, False, None),
    ("spatial 3x3/s1 14^2 256->256, prologue, cap 10", 32, 14, 256, 256, 3, 1, True, 10.0),
    ("ragged 3x3 7^2 9->33, batch 2", 2, 7, 9, 33, 3, 1, True, None),
    ("ragged 3x3 7^2 129->33, batch 2, split K", 2, 7, 129, 33, 3, 1, True, None),
    ("ragged 3x3 7^2 9->130, batch 2", 2, 7, 9, 130, 3, 1, True, None),
    ("halo 3x3 7^2 16->64, batch 2, act(shift) > 0, exact", 2, 7, 16, 64, 3, 1, True, None),
]
# (label, shape, storage offset in floats, cap): residual joins
FUSED_JOIN_CASES = [
    ("join (32,56,56,256)", (32, 56, 56, 256), 0, None),
    ("join (32,7,7,2048)", (32, 7, 7, 2048), 0, None),
    ("odd size (3,7,7,9)", (3, 7, 7, 9), 0, None),
    ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1, None),
    ("cap 10 (32,14,14,1024)", (32, 14, 14, 1024), 0, 10.0),
]
# (label, shape, relu, cap, storage offset in floats): K5 through bias_act
BIAS_ACT_CASES = [
    ("stem (32,112,112,64), relu", (32, 112, 112, 64), True, None, 0),
    ("(32,56,56,256), no relu", (32, 56, 56, 256), False, None, 0),
    ("stem (32,112,112,64), relu, cap 10", (32, 112, 112, 64), True, 10.0, 0),
    ("odd size (3,7,7,9), relu", (3, 7, 7, 9), True, None, 0),
    ("misaligned (8,7,7,2048), relu", (8, 7, 7, 2048), True, None, 1),
]
# (label, M, C, relu): batch_norm_act forward and backward
BN_BWD_CASES = [(f"({label}){' relu' if relu else ''}", m, c, relu)
                for label, m, c in [("32*112*112, 64", 32 * 112 * 112, 64),
                                    ("32*28*28, 512", 32 * 28 * 28, 512),
                                    ("32*7*7, 2048", 32 * 7 * 7, 2048),
                                    ("1000, 33", 1000, 33)]
                for relu in (True, False)]
# (label, x shape (N, H, W, 4C), C, cap): K10 at the four identity-block
# shapes of ResNet-50 at batch 32; a cap of 2 that clips in both prologues
# and in the join; widths not a multiple of 4 with M = 75 rows, not a
# multiple of 128; and a batch-2 block whose 3x3 splits K in 2
# (build.wg_split), so that its statistics come from the summed y
BLOCK_FUSED_CASES = [
    ("stage 1 (32,56,56,256) C=64", (32, 56, 56, 256), 64, None),
    ("stage 2 (32,28,28,512) C=128", (32, 28, 28, 512), 128, None),
    ("stage 3 (32,14,14,1024) C=256", (32, 14, 14, 1024), 256, None),
    ("stage 4 (32,7,7,2048) C=512", (32, 7, 7, 2048), 512, None),
    ("cap 2 (32,14,14,1024) C=256", (32, 14, 14, 1024), 256, 2.0),
    ("ragged (3,5,5,36) C=9", (3, 5, 5, 36), 9, None),
    ("split K (2,4,4,516) C=129", (2, 4, 4, 516), 129, None),
]
# (label, K, N): K10's weights as its split kernel takes them (block_fused
# split_tf32), the reduce (4C, C), the 3x3 (9C, C) and the expand (C, 4C)
# of the four identity-block stages, then widths that are not multiples of 4
SPLIT_CASES = [(f"stage {i} {what} ({k},{n})", k, n)
               for i, c in enumerate((64, 128, 256, 512), 1)
               for what, k, n in (("reduce", 4 * c, c), ("3x3", 9 * c, c),
                                  ("expand", c, 4 * c))] + [
    ("ragged 3x3 (81,9)", 81, 9), ("ragged expand (9,36)", 9, 36)]

# the split-K GEMMs, the FC backward and the BN statistics, run twice per
# case and held to the same bits
REPEAT_KERNELS = ("conv2d", "conv2d_dx", "conv2d_dw", "matmul_bwd", "moments",
                  "fused_conv", "block_fused")

# name -> (module, launch counter, counter moves per call, cases)
KERNELS = {
    "conv2d": (conv, "LAUNCHES", 1, FWD_CONV_CASES),
    "conv2d_dx": (conv, "DX_LAUNCHES", 1, TRAIN_DX_CASES),
    "conv2d_dw": (conv, "DW_LAUNCHES", 1, TRAIN_DW_CASES),
    "add_relu": (fused, "LAUNCHES", 1, ADD_RELU_CASES),
    "add_relu_mask": (fused, "MASK_LAUNCHES", 1, ADD_RELU_MASK_CASES),
    "matmul": (matmul, "LAUNCHES", 1, MATMUL_CASES),
    "matmul_bwd": (matmul, "BWD_LAUNCHES", 1, MATMUL_BWD_CASES),
    "moments": (bn, "LAUNCHES", 1, MOMENTS_CASES),
    "adam": (adam, "LAUNCHES", 1, ADAM_CASES),
    "fused_conv": (fused_conv, "LAUNCHES", 1, FUSED_CONV_CASES),
    "fused_join": (fused_conv, "JOIN_LAUNCHES", 1, FUSED_JOIN_CASES),
    "bias_act": (bn, "APPLY_LAUNCHES", 1, BIAS_ACT_CASES),
    "bn_bwd": (bn, "BWD_LAUNCHES", 1, BN_BWD_CASES),
    "block_fused": (block_fused, "LAUNCHES", 1, BLOCK_FUSED_CASES),
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


def host_us(fn: Callable[[], object], calls: int = 200, warmup: int = 3) -> float:
    """Host time of one call in microseconds: ``calls`` calls enqueued back
    to back on the host clock, with no synchronize among them, divided by
    ``calls``; the device is synchronized before and after. Where the
    device's work is shorter than the host's, this is the rate at which a
    host-bound step can issue the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_profile(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
                   tries: int = 2) -> Optional[Dict[str, float]]:
    """Device time of one call by kernel: each kernel and copy that the call
    launches, by name (cut to 80 characters), with its summed device time
    over ``reps`` calls (torch.profiler, after warm-up) divided by ``reps``.
    A profile that records no device time (seen once on the H100) is taken
    again; None if every try records none."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "Profiler clears events ..."
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows: Dict[str, float] = {}
            for e in prof.key_averages():
                if e.self_device_time_total > 0:
                    key = e.key[:80]
                    rows[key] = rows.get(key, 0.0) + e.self_device_time_total / reps / 1e3
        if rows:
            return rows
    return None


def device_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2,
              tries: int = 2) -> Optional[float]:
    """Device time of one call: the summed device time of every kernel and
    copy it launches (``device_profile``)."""
    rows = device_profile(fn, reps, warmup, tries)
    return None if rows is None else sum(rows.values())


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS_PER_S
          ) -> Tuple[float, str]:
    """(least ms, 'bytes' or 'operations') on an H100 SXM at full power,
    for ``flops`` operations at ``peak`` per second."""
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


class _Case:
    """What one check runs: the kernel, its plain version, an optional
    library call, and the work the function must do."""

    def __init__(self, run, plain, nbytes, flops, library=None, as_plain=None,
                 timed=None, library_covers=slice(None), library_same=True,
                 peak=FP32_FLOPS_PER_S, exact=False):
        self.run, self.plain, self.library = run, plain, library
        self.exact = exact  # the kernel must equal the plain version bit for bit
        # the plain outputs the library call computes too; library_same
        # False: a yardstick of the same shape that does less work (K8)
        self.library_covers, self.library_same = library_covers, library_same
        self.nbytes, self.flops, self.peak = nbytes, flops, peak
        # what is timed, where the compared call does more (Adam: the
        # kernel's update alone, without the copies that make its state)
        self.timed = timed or (run, plain)
        # maps the library call's result onto the plain version's layout
        self.as_plain = as_plain or (lambda out: out)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _make(kernel: str, case, gen: torch.Generator, device) -> _Case:
    def randn(*shape, scale=1.0, offset=0):
        n = 1
        for s in shape:
            n *= s
        flat = torch.randn(n + offset, generator=gen, device=device) * scale
        return flat[offset:].view(shape)

    if kernel.startswith("conv2d"):
        _, n, h, cin, cout, k, s = case
        ho = h // s
        x = randn(n, h, h, cin)
        w = randn(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5)
        g = randn(n, ho, ho, cout)
        flops = 2 * n * ho * ho * k * k * cin * cout
        w_oihw = w.permute(3, 2, 0, 1)
        if kernel == "conv2d":
            return _Case(lambda: conv.conv2d(x, w, s),
                         lambda: conv.conv2d_reference(x, w, s),
                         4 * (x.numel() + w.numel() + g.numel()), 3 * flops,
                         lambda: F.conv2d(_nchw(x), w_oihw, stride=s, padding=k // 2),
                         _nhwc, peak=TF32_FLOPS_PER_S)
        if kernel == "conv2d_dx":
            return _Case(lambda: conv.conv2d_dx(g, w, x.shape, s),
                         lambda: conv.conv2d_dx_reference(g, w, x.shape, s),
                         4 * (g.numel() + w.numel() + x.numel()), 3 * flops,
                         lambda: torch.nn.grad.conv2d_input(
                             (n, cin, h, h), w_oihw, _nchw(g), stride=s,
                             padding=k // 2),
                         _nhwc, peak=TF32_FLOPS_PER_S)
        return _Case(lambda: conv.conv2d_dw(x, g, k, s),
                     lambda: conv.conv2d_dw_reference(x, g, k, s),
                     4 * (x.numel() + g.numel() + w.numel()), 3 * flops,
                     lambda: torch.nn.grad.conv2d_weight(
                         _nchw(x), (cout, cin, k, k), _nchw(g), stride=s,
                         padding=k // 2),
                     lambda dw: dw.permute(2, 3, 1, 0), peak=TF32_FLOPS_PER_S)
    if kernel == "add_relu":
        _, shape, offset = case
        a, b = randn(*shape, offset=offset), randn(*shape, offset=offset)
        return _Case(lambda: fused.add_relu(a, b),
                     lambda: fused.add_relu_reference(a, b), 12 * a.numel(),
                     a.numel())
    if kernel == "add_relu_mask":
        _, shape, offset = case
        a, b = randn(*shape, offset=offset), randn(*shape, offset=offset)
        g = randn(*shape, offset=offset)
        return _Case(lambda: fused.add_relu_mask(a, b, g),
                     lambda: fused.add_relu_mask_reference(a, b, g), 16 * a.numel(),
                     a.numel())
    if kernel == "matmul":
        _, m, k, n, offset = case
        a, b = randn(m, k), randn(k, n, scale=0.01, offset=offset)
        return _Case(lambda: matmul.matmul(a, b),
                     lambda: matmul.matmul_reference(a, b),
                     4 * (m * k + k * n + m * n), 2 * m * n * k,
                     lambda: torch.matmul(a, b))
    if kernel == "matmul_bwd":
        _, m, k, n, offset, need_a, need_b = case
        a, b, g = randn(m, k), randn(k, n, scale=0.01, offset=offset), randn(m, n)
        want = (need_a, need_b)

        def needed(pair):
            return tuple(t for t, keep in zip(pair, want) if keep)

        # inputs read once (b only for da, a only for db), outputs written once
        nbytes = 4 * (m * n + need_a * (k * n + m * k) + need_b * (m * k + k * n))
        return _Case(lambda: needed(matmul.matmul_bwd(a, b, g, need_a, need_b)),
                     lambda: needed(matmul.matmul_bwd_reference(a, b, g)),
                     nbytes, 2 * m * n * k * (need_a + need_b),
                     lambda: needed((torch.matmul(g, b.t()) if need_a else None,
                                     torch.matmul(a.t(), g) if need_b else None)))
    if kernel == "moments":
        _, m, c = case
        x = randn(m, c) * 2.0 + randn(1, c)
        return _Case(lambda: bn.moments(x), lambda: bn.moments_reference(x),
                     4 * (m * c + 2 * c), 3 * m * c,
                     lambda: torch.var_mean(x, dim=0, unbiased=False),
                     lambda vm: (vm[1], vm[0]))
    if kernel == "adam":
        return _adam_case(case, randn, device)
    if kernel == "fused_conv":
        return _fused_conv_case(case, randn)
    if kernel == "fused_join":
        _, shape, offset, cap = case
        c = shape[-1]
        e, r = randn(*shape, offset=offset), randn(*shape, offset=offset)
        se, sr = 1 + randn(c, scale=0.2), 1 + randn(c, scale=0.2)
        te, tr = randn(c, scale=0.2), randn(c, scale=0.2)
        return _Case(lambda: fused_conv.fused_join(e, se, te, r, sr, tr, cap),
                     lambda: fused_conv.fused_join_reference(e, se, te, r, sr, tr, cap),
                     12 * e.numel() + 16 * c, 6 * e.numel())
    if kernel == "bias_act":
        _, shape, relu, cap, offset = case
        c = shape[-1]
        x = randn(*shape, offset=offset)
        scale, shift = 1 + randn(c, scale=0.2), randn(c, scale=0.5)
        return _Case(lambda: fused.bias_act(x, scale, shift, relu, cap),
                     lambda: bn.bn_apply_reference(x, scale, shift, relu=relu, cap=cap),
                     8 * x.numel() + 8 * c, 4 * x.numel())
    if kernel == "bn_bwd":
        return _bn_bwd_case(case, randn)
    if kernel == "block_fused":
        return _block_fused_case(case, randn)
    raise ValueError(f"unknown kernel {kernel!r}")


def _fused_conv_case(case, randn) -> _Case:
    label, n, h, cin, cout, k, s, prologue, cap = case
    ho = h // s
    exact = label.startswith("halo")
    if exact:
        # u = relu(x * 0 + shift) = shift, an integer 1..3 on every channel,
        # times weights in {-1, 0, 1}: every y, y^2 and sum is an integer
        # below 2^24, exact in fp32 in any order and in TF32's split (lo =
        # 0). A halo tap that became act(shift) moves an edge output by >= 1.
        x = randn(n, h, h, cin)
        w = torch.round(randn(k, k, cin, cout)).clamp(-1.0, 1.0)
        scale = torch.zeros_like(randn(cin))
        shift = 1.0 + torch.round(randn(cin).abs()).clamp(0.0, 2.0)
    else:
        x = randn(n, h, h, cin)
        w = randn(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5)
        # shift > 0 on about half the channels: relu(shift) must not reach the halo
        scale, shift = 1 + randn(cin, scale=0.2), randn(cin, scale=0.5)
    args = (x, w, scale, shift, s, None, prologue, True, cap)

    def split(out):
        y, sums = out
        return y, sums[0], sums[1]

    return _Case(lambda: split(fused_conv.fused_conv(*args)),
                 lambda: split(fused_conv.fused_conv_reference(*args)),
                 4 * (x.numel() + w.numel() + n * ho * ho * cout + 2 * cin + 2 * cout),
                 3 * 2 * n * ho * ho * k * k * cin * cout,
                 lambda: F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=s,
                                  padding=k // 2),
                 library_same=False, peak=TF32_FLOPS_PER_S, exact=exact)


def _block_fused_case(case, randn) -> _Case:
    _, (n, h, w, c4), c, cap = case
    x = torch.clamp_min(randn(n, h, w, c4), 0.0)  # a block's input is a ReLU's output
    ws = (randn(c4, c, scale=(2.0 / c4) ** 0.5), randn(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5),
          randn(c, c4, scale=(2.0 / c) ** 0.5))
    # shift > 0 on about half the channels: relu(shift) must not reach the halo
    rows = [t for width in (c, c, c4) for t in (1 + randn(width, scale=0.2),
                                                randn(width, scale=0.5))]
    args = (x, *ws, *rows, 1e-7, cap)

    def split(out):
        # out, r, s, e; each sum row on its own; the six affine rows
        *acts, sums_r, sums_s, sums_e, aff = out
        return (*acts, *sums_r, *sums_s, *sums_e, *aff)

    m = n * h * w
    row_floats = 2 * (4 * c + 2 * c4)  # gamma, beta in; the six rows out
    return _Case(lambda: split(block_fused.block_fused_forward(*args)),
                 lambda: split(block_fused.block_fused_reference(*args)),
                 4 * (2 * m * c4 + 2 * m * c + m * c4 + sum(t.numel() for t in ws)
                      + row_floats + 2 * (2 * c + c4)),
                 3 * 2 * m * (2 * c4 * c + 9 * c * c), peak=TF32_FLOPS_PER_S)


def _bn_bwd_case(case, randn) -> _Case:
    _, m, c, relu = case
    x = randn(m, c) * 2.0 + randn(1, c)
    gamma, beta = 1 + randn(c, scale=0.2), randn(c, scale=0.5)
    dy = randn(m, c)
    eps = 1e-7
    mean, var = bn.moments_reference(x)
    inv = torch.rsqrt(var + eps)

    saved = {}

    def run():  # forward K4 and K5, backward K6 through autograd
        xs, g, b = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
        y, saved["mean"], saved["var"] = bn.batch_norm_act(xs, g, b, eps, relu)
        return (y.detach(), *torch.autograd.grad(y, (xs, g, b), dy))

    def plain():
        # the backward's plain version at the statistics K6 was given (its
        # own inputs): a ReLU gate on an element whose x_hat * gamma + beta
        # lies within rounding of 0 would flip between the two paths'
        # statistics and move dx there by gamma * inv_std * dy
        y, _, _ = bn.bn_act_reference(x, gamma, beta, eps, relu)
        return (y, *bn.bn_bwd_reference(x, dy, saved["mean"],
                                        torch.rsqrt(saved["var"] + eps), gamma, beta,
                                        relu=relu))

    library = None
    if not relu:  # the plain BN backward, no ReLU gate
        def library():
            return torch.ops.aten.native_batch_norm_backward(
                dy, x, gamma, None, None, mean, inv, True, eps, [True, True, True])
    # x and dy read, dx written; dx needs s1 and s2 over all rows, so x and
    # dy are read again after the reduction finishes, and only what the L2
    # still holds of them (50 MB) is spared that second read
    nbytes = 4 * (3 * m * c + max(0.0, 2 * m * c - L2_BYTES / 4)) + 4 * 6 * c
    return _Case(run, plain, nbytes, 10 * m * c, library,
                 timed=(lambda: bn.bn_bwd(x, dy, mean, inv, gamma, beta, relu=relu),
                        lambda: bn.bn_bwd_reference(x, dy, mean, inv, gamma, beta,
                                                    relu=relu)),
                 library_covers=slice(1, None))


def _adam_case(case, randn, device) -> _Case:
    from ..config import model_config
    from ..models.init import init_params
    from ..bridge import flatten

    shapes = [t.shape for _, t in flatten(
        init_params(torch.Generator().manual_seed(0), model_config(case[1]),
                    device="meta"))]
    p0 = [randn(*s, scale=0.05) for s in shapes]
    g = [randn(*s, scale=1e-3) for s in shapes]
    m0 = [randn(*s, scale=1e-4) for s in shapes]
    v0 = [randn(*s, scale=1e-3) ** 2 for s in shapes]
    # non-finite gradients (moments kept) and parameters (update rolled back)
    g[0].view(-1)[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    g[-1].view(-1)[-1] = float("nan")
    p0[1].view(-1)[0] = float("inf")
    h = adam.hyper_row(1e-4, 1e-5, 0.9, 0.999, 1e-7, 0.9 ** 10, 0.999 ** 10, True,
                       device)
    n = sum(t.numel() for t in p0)
    state = {}

    def fresh():
        state["k"] = [[t.clone() for t in ts] for ts in (p0, m0, v0)]
        state["p"] = [[t.clone() for t in ts] for ts in (p0, m0, v0)]

    def run():
        p, m, v = state["k"]
        adam.fused_adam(p, g, m, v, h)

    def plain():
        p, m, v = state["p"]
        with torch.no_grad():
            for i in range(len(p)):
                p[i], m[i], v[i] = adam.adam_leaf_reference(p[i], g[i], m[i], v[i], h)

    def flat(which, step):
        # one update from the fresh state, as three flat vectors
        fresh()
        step()
        return [torch.cat([t.reshape(-1) for t in ts]) for ts in state[which]]

    return _Case(lambda: flat("k", run), lambda: flat("p", plain), 4 * 7 * n, 12 * n,
                 timed=(run, plain))


def split_input(k: int, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """A (k, n) weight whose every eighth element sits exactly halfway
    between two tf32 values (the 13 dropped bits 0x1000), where rounding
    to nearest with ties away differs from ties to even."""
    b = torch.randn(k, n, generator=gen, device=device) * (2.0 / k) ** 0.5
    bits = b.view(torch.int32).reshape(-1)
    tie = (bits[::8] & ~0x1FFF) | 0x1000
    bits[::8] = tie
    return b


def check_split(case, *, device="cuda", seed: int = 0,
                timing: bool = True) -> Dict[str, object]:
    """K10's weight split (``block_fused.split_tf32``) against its plain
    version, bit for bit; raises RuntimeError where they differ. Returns
    {kernel, case, max_abs_err, bound_ms, bound_by} and, with timing, ms,
    plain_ms, device_ms and host_us."""
    label, k, n = case
    gen = torch.Generator(device=device).manual_seed(seed)
    b = split_input(k, n, gen, device)
    got, want = block_fused.split_tf32(b), block_fused.split_tf32_reference(b)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"split_tf32 {label}: not equal to the plain version bit for bit")
    least, by = bound(4 * (k * n + got.numel()), 2 * k * n)
    out = {"kernel": "split_tf32", "case": label, "max_abs_err": 0.0, "bound_ms": least,
           "bound_by": by}
    if timing:
        out["ms"] = median_ms(lambda: block_fused.split_tf32(b))
        out["plain_ms"] = median_ms(lambda: block_fused.split_tf32_reference(b))
        out["device_ms"] = device_ms(lambda: block_fused.split_tf32(b))
        out["host_us"] = host_us(lambda: block_fused.split_tf32(b))
    return out


def _outputs(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_case(kernel: str, case, *, device="cuda", seed: int = 0,
               timing: bool = True) -> Dict[str, object]:
    """Run one case; raise RuntimeError where the kernel disagrees.

    Returns {kernel, case, max_abs_err, rel_err, bound_ms, bound_by} (and
    fp32_fma_bound_ms for the tensor-core kernels) and, with timing, ms,
    plain_ms, library_ms, device_ms (with device_kernels, its split by
    kernel name), library_device_ms and host_us."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = _make(kernel, case, gen, device)
    got, want = _outputs(c.run()), _outputs(c.plain())
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for gt, wt in zip(got, want, strict=True):
        if gt.shape != wt.shape:
            raise RuntimeError(f"{kernel} {case[0]}: shape {tuple(gt.shape)} "
                               f"vs plain {tuple(wt.shape)}")
        finite = torch.isfinite(wt)
        if not torch.equal(finite, torch.isfinite(gt)):
            raise RuntimeError(f"{kernel} {case[0]}: non-finite values differ")
        d = (gt[finite] - wt[finite]).abs().max().item() if finite.any() else 0.0
        scale = wt[finite].abs().max().item() if finite.any() else 0.0
        r = d / scale if scale else d
        if not (r <= REL_TOL):
            raise RuntimeError(f"{kernel} {case[0]}: max|kernel - plain| = {d} "
                               f"is {r:.3e} of max|plain| = {scale} > {REL_TOL}")
        if c.exact and not torch.equal(gt, wt):
            raise RuntimeError(f"{kernel} {case[0]}: not equal to the plain version "
                               f"bit for bit (max|kernel - plain| = {d})")
        err, rel = max(err, d), max(rel, r)
    if kernel in REPEAT_KERNELS:
        again = _outputs(c.run())
        if not all(torch.equal(a, b) for a, b in zip(again, got, strict=True)):
            raise RuntimeError(f"{kernel} {case[0]}: a second run gave other bits")
    least, by = bound(c.nbytes, c.flops, c.peak)
    out = {"kernel": kernel, "case": case[0], "max_abs_err": err, "rel_err": rel,
           "bound_ms": least, "bound_by": by}
    if c.peak == TF32_FLOPS_PER_S:  # 3 TF32 products per FLOP: also at the FMA peak
        out["fp32_fma_bound_ms"] = bound(c.nbytes, c.flops / 3)[0]
    if c.library is not None and c.library_same:
        # the yardstick must compute the same function
        for lt, wt in zip(_outputs(c.as_plain(c.library())), want[c.library_covers],
                          strict=True):
            scale = wt.abs().max().item()
            if (lt - wt).abs().max().item() > 1e-3 * scale:
                raise RuntimeError(f"{kernel} {case[0]}: the library call computes "
                                   "another function")
    if timing:
        out["ms"] = median_ms(c.timed[0])
        out["plain_ms"] = median_ms(c.timed[1])
        out["library_ms"] = median_ms(c.library) if c.library is not None else None
        kernels = device_profile(c.timed[0])
        out["device_ms"] = None if kernels is None else sum(kernels.values())
        out["device_kernels"] = kernels
        out["library_device_ms"] = (device_ms(c.library) if c.library is not None
                                    else None)
        out["host_us"] = host_us(c.timed[0])
    return out


def total(results, key: str = "library_ms") -> Optional[float]:
    """Sum of ``key`` over cases, None where any case has none."""
    times = [r.get(key) for r in results]
    return None if any(t is None for t in times) else sum(times)
