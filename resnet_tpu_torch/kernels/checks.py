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

The bf16 kernels (``<name>_bf16``: the conv forward, dx and dW, the join
and its mask, the FC forward and backward, the BN statistics) run the same
wrappers on bf16 inputs at ResNet-50's batch-8 serving and batch-32
training shapes, the stem (Cin = 3, 7x7/s2), a 3x3/s2 projection, a 1x1
expand, the four joins and the FC among them, and are held to their plain
versions (fp32 arithmetic on the upcast inputs, one rounding): every bf16
element within one bf16 ulp of the plain
value plus 1e-5 of max|plain| (``BF16_REL_TOL``), the fp32 statistics
within 1e-5 of max. Their bound counts 2 bytes a value and the GEMMs'
operations at 989 TFLOP/s dense bf16; their library calls are the same
PyTorch calls in bf16, whose results are held to the plain version within
1e-2 of max (a bf16 result of another summation order), where the fp32
ones are held within 1e-3.

The bf16 K5, K6, K8, K9 and K10 (``bias_act_bf16``, ``bn_bwd_bf16``,
``fused_conv_bf16``, ``fused_join_bf16``, ``block_fused_bf16``) run the
fused and whole-block engines' shapes at batch 32: each of the 23 distinct
shapes of ResNet-50's 52 fused-conv sites (``fused_sites``), the four
joins, the stem's BN apply, and the four shapes of the 12 identity blocks,
then ragged, split-K, capped and misaligned cases. Their bf16 outputs are
held by the rule above and their fp32 outputs (K8's and K10's sums, K10's
(scale, shift) rows, K6's dγ and dβ) within 1e-5 of max. K8's bound is its
operations at 989 TFLOP/s dense bf16 and its library call ``F.conv2d`` in
bf16 (the conv alone); K10's bound likewise; K5's, K6's and K9's their
bytes at 2 a value, K6's library call ``native_batch_norm_backward`` on the
bf16 tensors.

The split-K GEMMs, the FC backward, the BN statistics, the BN backward
(K6), K8 and K10 (``REPEAT_KERNELS``) are also run a second time on the
same inputs and must give the same bits: their partials are added in split
order, or in one fixed order inside a block, with no atomics in any sum. A case marked
exact (the fused conv's halo case, integer-valued so that every order of
summation is exact) must match its plain version bit for bit, in fp32 and
in bf16.

Every bf16 case, and each case of the fp32 join, whole-block kernel, BN
statistics, apply and backward (``HASHED``), also reports ``out_hash``, a digest of its kernel's outputs'
bits (``output_hash``): this file copied into another tree of the package
makes the same inputs there, so two trees' kernels are held to the same
bits by comparing their lines.

The int8 serving kernels (``kernels.quant``): Q1 (``qconv``) at each
distinct conv shape of ResNet-50's 53 at batch 8 with its site's epilogue
(ReLU'd bf16 for the stem, reduce and spatial sites, bf16 for the expand
and projection sites), the FC with fp32 logits, a capped site, a 1x1/s2
projection, a ragged case (Cin 3, Cout 33, the byte gather) and stage 4's
3x3 at batch 1 (``APART``: summed apart in chip_smoke.py); Q2
(``quant_act``) on the fp32 images, bf16 activations, the pooled features,
an odd size and an input laid on exact .5 ties and beyond the clip. Each
must equal its plain version bit for bit (``max_abs_err`` 0: integer sums
are exact in any order and the epilogue rounds step by step as the plain
version does); Q1 runs twice to the same bits. Their bound counts 1 byte an
int8 value and Q1's operations at 1,979 TOP/s dense int8. Q1's yardstick,
on every case it accepts (M > 16, N a multiple of 8), is ``torch._int_mm``
of an im2col of x (``qconv_im2col``, made outside the timed call; K
zero-padded to a multiple of 8, the stem's 147 to 152) by the HWIO weight:
the integer product alone, without the dequantizing epilogue, so less
work (``library_covers`` nothing; the line says ``library: int_mm,
product only``); Q2 has none. Q1's operands come from ``qconv_operands``
(``qconv_plans`` times the same inputs under other plans). Q3
(``qconv_grouped``, ``qconv`` with groups > 1) at every distinct grouped
site of ResNeXt-50 32x4d and ResNeXt-101 32x8d at batch 8 and of
ResNeXt-50 at 128 (``qconv_grouped_sites``), a capped site and a ragged
one (Cin / g 3, the word-by-word halo), each bit for bit and twice to the
same bits; its bound the same as Q1's; no yardstick (``torch._int_mm``
takes no groups).
"""

from __future__ import annotations

import hashlib
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.padding import reference_padding
from . import adam, block_fused, bn, conv, fused, fused_conv, matmul, quant

REL_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12  # dense, tensor cores
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores
INT8_OPS_PER_S = 1979e12  # dense, tensor cores
BF16_REL_TOL = 1e-5  # beside one bf16 ulp per element

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
MOMENTS_CASES: List[Tuple] = [
    ("stem (32*112*112, 64)", 32 * 112 * 112, 64),
    ("stage 1 (32*56*56, 256)", 32 * 56 * 56, 256),
    ("stage 4 (32*7*7, 2048)", 32 * 7 * 7, 2048),
    ("ragged (1000, 33)", 1000, 33),
    ("stem (224*112*112, 64), batch 224", 224 * 112 * 112, 64),
    ("stage 1 (224*56*56, 256), batch 224", 224 * 56 * 56, 256),
    # the raw-sums mode (rt_moments_sums_*) of the data-parallel step, at one
    # rank's rows of batch 16
    ("sums: stem (16*112*112, 64)", 16 * 112 * 112, 64, "sums"),
    ("sums: stage 4 (16*7*7, 2048)", 16 * 7 * 7, 2048, "sums"),
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

# the bf16 kernels' cases: ResNet-50's serving (batch 8, the forward and
# the join) and training (batch 32) shapes, the stem, the 1x1 expand and
# the 3x3/s2 projection among them, then widths that are not a multiple of
# 8 (2-byte copies), a K split, a misaligned operand. The forward's last
# cases (an 8th field: x's storage offset in elements): ragged widths at
# stride 1 and 2 and a misaligned x (conv.fwd_bf16_route: 'mma'), a stem
# whose rows end inside a tile and whose window meets the image's edges on
# both sides, and a gather whose last column tile and last slice are part
# empty ('wgmma')
BF16_CONV_CASES = [(f"{label}, batch {n}", n, *shape)
                   for label, n, *shape in CONV_CASES + TRAIN_CONV_CASES] + [
    ("ragged 3x3 7^2 9->33, batch 2", 2, 7, 9, 33, 3, 1),
    ("ragged 3x3/s2 14->7 130->66, batch 2", 2, 14, 130, 66, 3, 2),
    ("misaligned x 3x3 14^2 64->64, batch 2", 2, 14, 64, 64, 3, 1, 1),
    ("stem 7x7/s2 30->15 3->64, batch 2", 2, 30, 3, 64, 7, 2),
    ("3x3 7^2 16->72, batch 2", 2, 7, 16, 72, 3, 1)]
# dx: the training shapes, stage 4's 3x3 (5 splits of 928, which end
# inside 64-deep slices: w by 16-byte copies, conv.dx_bf16_route 'copy'),
# ragged widths at stride 2 ('scalar'), and a stride-2 dx whose Cout is no
# multiple of 64 (its slices cross taps: 'copy' over four phases)
BF16_DX_CASES = TRAIN_CONV_CASES[1:] + [
    ("split K 3x3/s1 7^2 512->512", 32, 7, 512, 512, 3, 1),
    ("ragged 3x3/s2 14->7 9->33, batch 2", 2, 14, 9, 33, 3, 2),
    ("3x3/s2 14->7 72->40, batch 2", 2, 14, 72, 40, 3, 2),
]
BF16_DW_CASES = TRAIN_CONV_CASES + [
    ("split K 3x3 27^2 20->24, batch 2, ragged last chunk", 2, 27, 20, 24, 3, 1)]


def tile_case(label: str, n: int, ranks: int, rank: int, width: int, cin: int, cout: int,
              k: int, stride: int, image: int = 224) -> Tuple:
    """The conv case of rank ``rank``'s tile of rows under spatial
    partitioning over ``ranks`` (``parallel.spatial``): ResNet-50 at
    ``image``, the layer of ``width`` (= its global height): (label, n,
    (tile height, width), Cin, Cout, k, stride, ((lo, hi), (lo_w, hi_w)))."""
    from ..parallel import spatial

    height, rows = image, spatial.even_rows(image, ranks)
    while height > width:  # the stem, then one halving a stage
        height, rows = spatial.next_rows(rows, height, 2)
    t = spatial.tile_of(rows, rank, height, k, stride)
    a, b = rows[rank]
    return (f"tile {label} (rank {rank} of {ranks}: rows {a}-{b} of {height}, halo "
            f"{t.top}+{t.bottom}, pad ({t.lo}, {t.hi})), batch {n}", n,
            (b + t.bottom - a + t.top, width), cin, cout, k, stride,
            ((t.lo, t.hi), reference_padding(width, k, stride)))


# K1 with JAX's explicit padding on the tiles a rank holds under spatial
# partitioning (``parallel.spatial``): the stem's top and bottom tiles on 2
# ranks, an interior 3x3/s1 tile, stage 3's 3x3/s2 and 1x1/s2 on a tile
# whose first row is odd (rows 7-14 of 28 on 4 ranks: pad 0 and -1) and its
# 3x3/s2 on the next tile (a halo row above and below), and
# stage 4's 4- and 3-row tiles on 2 ranks; summed apart from the others
# in chip_smoke.py's kernels line (``TILE``)
TILE = "tile "
TILE_CASES = [
    tile_case("stem 7x7/s2 3->64", 8, 2, 0, 224, 3, 64, 7, 2),
    tile_case("stem 7x7/s2 3->64", 8, 2, 1, 224, 3, 64, 7, 2),
    tile_case("3x3/s1 64->64", 8, 4, 1, 56, 64, 64, 3, 1),
    tile_case("3x3/s2 256->256", 8, 4, 1, 28, 256, 256, 3, 2),
    tile_case("3x3/s2 256->256", 8, 4, 2, 28, 256, 256, 3, 2),
    tile_case("1x1/s2 512->1024", 8, 4, 1, 28, 512, 1024, 1, 2),
    tile_case("3x3/s1 512->512", 8, 2, 0, 7, 512, 512, 3, 1),
    tile_case("3x3/s1 512->512", 8, 2, 1, 7, 512, 512, 3, 1),
]


def fused_tile_case(label: str, n: int, ranks: int, rank: int, width: int, cin: int,
                    cout: int, k: int, stride: int, prologue: bool) -> Tuple:
    """K8's case of rank ``rank``'s tile (``tile_case``): (label, n, (tile
    height, width), Cin, Cout, k, stride, prologue, cap None, padding)."""
    label, n, hw, cin, cout, k, stride, pad = tile_case(label, n, ranks, rank, width, cin,
                                                        cout, k, stride)
    return label, n, hw, cin, cout, k, stride, prologue, None, pad


# K8 and K8-bf16 on the tiles a rank of the fused engines holds under
# spatial partitioning, with JAX's explicit padding: stage 1's 3x3/s1
# interior tile with the prologue on 4 ranks; stage 3's 3x3/s2 (prologue)
# and 1x1/s2 projection (none) on rows 7-14 of 28 (pad 0 and -1); stage 4's
# 4- and 3-row 3x3/s1 tiles on 2 ranks; and a seam (a halo row above, the
# image's edge below) with act(shift) > 0 on integer values, exact
# (``_fused_conv_case``); summed apart as K1's tiles are (``TILE``)
FUSED_TILE_CASES = [
    fused_tile_case("3x3/s1 64->64, prologue", 8, 4, 1, 56, 64, 64, 3, 1, True),
    fused_tile_case("3x3/s2 256->256, prologue", 8, 4, 1, 28, 256, 256, 3, 2, True),
    fused_tile_case("1x1/s2 512->1024", 8, 4, 1, 28, 512, 1024, 1, 2, False),
    fused_tile_case("3x3/s1 512->512, prologue", 8, 2, 0, 7, 512, 512, 3, 1, True),
    fused_tile_case("3x3/s1 512->512, prologue", 8, 2, 1, 7, 512, 512, 3, 1, True),
    fused_tile_case("seam 3x3/s1 16->64, act(shift) > 0, exact", 2, 2, 1, 7, 16, 64, 3, 1,
                    True),
]
# the four stages' joins: served at batch 8 (forward), trained at 32 (mask)
_JOINS = [(56, 256), (28, 512), (14, 1024), (7, 2048)]
_BF16_ODD = [("odd size (3,7,7,9)", (3, 7, 7, 9), 0),
             ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1)]
BF16_ADD_RELU_CASES = [(f"join (8,{h},{h},{c})", (8, h, h, c), 0)
                       for h, c in _JOINS] + _BF16_ODD
BF16_ADD_RELU_MASK_CASES = [(f"join bwd (32,{h},{h},{c})", (32, h, h, c), 0)
                            for h, c in _JOINS] + _BF16_ODD
# ... the label ending in the bf16 route (matmul.fwd_bf16_route; b's
# offset in bf16 elements, so 1 is 2 bytes off a 16-byte boundary)
BF16_MATMUL_CASES = [
    (f"{label.rsplit(' ', 1)[0]} {matmul.fwd_bf16_route(m, n, k, offset % 8 == 0)}", m, k, n,
     offset)
    for label, m, k, n, offset in MATMUL_CASES
    if m in (8, 32, 64) or label.startswith(("ragged", "misaligned"))]
BF16_MATMUL_BWD_CASES = MATMUL_BWD_CASES
BF16_MOMENTS_CASES = MOMENTS_CASES[:4] + MOMENTS_CASES[-1:]


def fused_sites(batch: int) -> List[Tuple]:
    """(label, batch, H, Cin, Cout, k, stride, prologue, cap) of each distinct
    shape among ResNet-50's 52 fused-conv sites (models.fused_resnet: per
    block the reduce, the spatial 3x3 with the stride, the expand, and the
    projection), in model order, the label naming the first site and how
    many share the shape."""
    from ..config import model_config
    from ..models.init import init_params

    mcfg = model_config("resnet50")
    params = init_params(torch.Generator().manual_seed(0), mcfg, device="meta")
    h = mcfg.input_dim // mcfg.init_stride // mcfg.maxpool_stride
    sites: Dict[Tuple, List[str]] = {}
    for i, bp in enumerate(params["blocks"]):
        s = 2 if mcfg.is_reduction_block(i) else 1
        for conv, hh, stride, pro in (("reduce", h, 1, False), ("spatial", h, s, True),
                                      ("expand", h // s, 1, True), ("proj", h, s, False)):
            if conv in bp:
                k, _, cin, cout = bp[conv]["w"].shape
                sites.setdefault((hh, cin, cout, k, stride, pro), []).append(
                    f"block {i} {conv}")
        h //= s
    return [(f"{names[0]} {k}x{k}/s{st} {hh}^2 {cin}->{cout} (x{len(names)})", batch, hh,
             cin, cout, k, st, pro, None)
            for (hh, cin, cout, k, st, pro), names in sites.items()]


# K8 on bf16: every fused-site shape at batch 32; a capped site; ragged
# widths at batch 2 (2-byte copies), the second deep enough that the GEMM
# splits K (statistics from the fp32 split sum); the halo case, exact
BF16_FUSED_CONV_CASES = fused_sites(32) + [
    ("spatial 3x3/s1 14^2 256->256, prologue, cap 10", 32, 14, 256, 256, 3, 1, True, 10.0),
    ("ragged 3x3 7^2 9->33, batch 2", 2, 7, 9, 33, 3, 1, True, None),
    ("ragged 3x3 7^2 129->33, batch 2, split K", 2, 7, 129, 33, 3, 1, True, None),
    ("halo 3x3 7^2 16->64, batch 2, act(shift) > 0, exact", 2, 7, 16, 64, 3, 1, True, None),
]
# K9 on bf16: the four stages' joins at batch 32, a capped one, an odd size
# and a misaligned start
BF16_FUSED_JOIN_CASES = [(f"join (32,{h},{h},{c})", (32, h, h, c), 0, None)
                         for h, c in _JOINS] + [
    ("cap 10 (32,14,14,1024)", (32, 14, 14, 1024), 0, 10.0),
    ("odd size (3,7,7,9)", (3, 7, 7, 9), 0, None),
    ("misaligned (8,7,7,2048)", (8, 7, 7, 2048), 1, None)]
BF16_BIAS_ACT_CASES = [c for c in BIAS_ACT_CASES if c[2]]  # the stem's, with ReLU
BF16_BN_BWD_CASES = BN_BWD_CASES
# K10 on bf16: the four shapes of ResNet-50's 12 identity blocks at batch 32
# (stage 1: 2 blocks, stage 2: 3, stage 3: 5, stage 4: 2), a cap, ragged
# widths, and a block whose 3x3 splits K
BF16_BLOCK_FUSED_CASES = [(label.replace(")", f") x{n}", 1), *rest) for (label, *rest), n in
                          zip(BLOCK_FUSED_CASES[:4], (2, 3, 5, 2))] + BLOCK_FUSED_CASES[4:]

def _conv_sites(preset: str) -> Dict[Tuple, List[str]]:
    """{(H, Cin, Cout, k, stride, relu, groups): the site names} of the conv
    sites of ``preset``'s quantized forward (the stem; per block the reduce,
    the spatial 3x3 with the stride and the model's groups, the expand and
    the projection), in model order with the site's epilogue (ReLU'd bf16
    for the stem, reduce and spatial sites)."""
    from ..config import model_config
    from ..models.init import init_params

    mcfg = model_config(preset)
    params = init_params(torch.Generator().manual_seed(0), mcfg, device="meta")
    k0, _, cin0, cout0 = params["init_conv"]["w"].shape
    sites: Dict[Tuple, List[str]] = {
        (mcfg.input_dim, cin0, cout0, k0, mcfg.init_stride, True, 1): ["stem"]}
    h = mcfg.input_dim // mcfg.init_stride // mcfg.maxpool_stride
    for i, bp in enumerate(params["blocks"]):
        s = 2 if mcfg.is_reduction_block(i) else 1
        for conv, hh, stride, relu in (("reduce", h, 1, True), ("spatial", h, s, True),
                                       ("expand", h // s, 1, False), ("proj", h, s, False)):
            if conv in bp:
                k, _, cin, cout = bp[conv]["w"].shape
                g = mcfg.groups if conv == "spatial" else 1
                sites.setdefault((hh, cin * g, cout, k, stride, relu, g), []).append(
                    f"block {i} {conv}")
        h //= s
    return sites


def qconv_sites(batch: int) -> List[Tuple]:
    """(label, batch, H, Cin, Cout, k, stride, relu, cap, out dtype) of each
    distinct shape among the 53 conv sites of ResNet-50's quantized forward
    (``_conv_sites``), the label naming the first site and how many share
    the shape."""
    return [(f"{names[0]} {k}x{k}/s{st} {hh}^2 {cin}->{cout}{', relu' if relu else ''} "
             f"(x{len(names)})", batch, hh, cin, cout, k, st, relu, None, "bf16")
            for (hh, cin, cout, k, st, relu, _), names in _conv_sites("resnet50").items()]


def qconv_grouped_sites(preset: str, batch: int) -> List[Tuple]:
    """``qconv_sites``'s tuples and the groups, for each distinct shape of
    ``preset``'s grouped conv sites (ResNeXt's spatial 3x3s)."""
    return [(f"{preset} {names[0]} {k}x{k}/s{st} {hh}^2 {cin}->{cout} g{g}, relu "
             f"(x{len(names)}), batch {batch}", batch, hh, cin, cout, k, st, relu, None,
             "bf16", g)
            for (hh, cin, cout, k, st, relu, g), names in _conv_sites(preset).items() if g > 1]


# Q1: every distinct conv site of ResNet-50 at the serving batch 8, the FC
# (fp32 logits), a capped site, a 1x1/s2 projection (the 'standard'
# projections), and a ragged case whose Cin takes the byte gather
QCONV_CASES = qconv_sites(8) + [
    ("fc (8,2048)@(2048,1000), fp32", 8, 1, 2048, 1000, 1, 1, False, None, "f32"),
    ("spatial 3x3/s1 14^2 256->256, relu, cap 10", 8, 14, 256, 256, 3, 1, True, 10.0, "bf16"),
    ("standard proj 1x1/s2 56->28 256->512", 8, 56, 256, 512, 1, 2, False, None, "bf16"),
    ("ragged 3x3 7^2 3->33, batch 2, relu", 2, 7, 3, 33, 3, 1, True, None, "bf16"),
] + [
    # batch 1 (HTTP serves it too): stage 4's 3x3, whose few tiles need K
    # splits to fill the card; reported apart from the cases above
    (f"batch 1 {label}", *rest) for label, *rest in qconv_sites(1)
    if label.startswith("block 14 spatial")]
# Q3: every distinct grouped site of both ResNeXt presets at the serving
# batch 8 and ResNeXt-50's at 128, then a capped site and, on the byte
# path, a ragged one (Cin / g 3)
QCONV_GROUPED_CASES = (
    qconv_grouped_sites("resnext50_32x4d", 8) + qconv_grouped_sites("resnext101_32x8d", 8)
    + qconv_grouped_sites("resnext50_32x4d", 128) + [
        ("3x3/s1 14^2 512->512 g32, relu, cap 10", 8, 14, 512, 512, 3, 1, True, 10.0, "bf16",
         32),
        ("ragged 3x3/s2 10^2 6->10 g2, batch 2", 2, 10, 6, 10, 3, 2, False, None, "bf16", 2)])
# cases each kernel's line in chip_smoke.py also sums apart (by label prefix)
APART = {"qconv": "batch 1 "}
# Q2: (label, shape, dtype, storage offset in elements): the images, the
# largest and the last block's bf16 activations, the pooled features, an
# odd size at an offset (the scalar path), and exact .5 ties (``ties``)
QUANT_ACT_CASES = [
    ("images (8,224,224,3) fp32", (8, 224, 224, 3), torch.float32, 0),
    ("(8,56,56,256) bf16", (8, 56, 56, 256), torch.bfloat16, 0),
    ("(8,7,7,2048) bf16", (8, 7, 7, 2048), torch.bfloat16, 0),
    ("pooled (8,2048) bf16", (8, 2048), torch.bfloat16, 0),
    ("odd size (3,7,7,9) bf16, misaligned", (3, 7, 7, 9), torch.bfloat16, 1),
    ("ties (16,4096) fp32, inv 4: k + 0.5 and beyond the clip", (16, 4096), torch.float32, 0),
]


# the split-K GEMMs, the FC backward and the BN statistics and backward,
# run twice per case and held to the same bits
REPEAT_KERNELS = ("conv2d", "conv2d_dx", "conv2d_dw", "matmul_bwd", "moments", "bn_bwd",
                  "fused_conv", "block_fused", "conv2d_bf16", "conv2d_dx_bf16",
                  "conv2d_dw_bf16", "matmul_bf16", "matmul_bwd_bf16", "moments_bf16",
                  "fused_conv_bf16", "block_fused_bf16", "bn_bwd_bf16", "qconv",
                  "qconv_grouped")

# the fp32 kernels whose cases carry an output hash beside the bf16 ones':
# those that run K9's join body, and K4, K5 and K6
HASHED = ("fused_join", "block_fused", "moments", "bias_act", "bn_bwd", "qconv",
          "qconv_grouped", "quant_act")

# name -> (module, launch counter, counter moves per call, cases)
KERNELS = {
    "conv2d": (conv, "LAUNCHES", 1, FWD_CONV_CASES + TILE_CASES),
    "conv2d_dx": (conv, "DX_LAUNCHES", 1, TRAIN_DX_CASES + TILE_CASES),
    "conv2d_dw": (conv, "DW_LAUNCHES", 1, TRAIN_DW_CASES + TILE_CASES),
    "add_relu": (fused, "LAUNCHES", 1, ADD_RELU_CASES),
    "add_relu_mask": (fused, "MASK_LAUNCHES", 1, ADD_RELU_MASK_CASES),
    "matmul": (matmul, "LAUNCHES", 1, MATMUL_CASES),
    "matmul_bwd": (matmul, "BWD_LAUNCHES", 1, MATMUL_BWD_CASES),
    "moments": (bn, "LAUNCHES", 1, MOMENTS_CASES),
    "adam": (adam, "LAUNCHES", 1, ADAM_CASES),
    "fused_conv": (fused_conv, "LAUNCHES", 1, FUSED_CONV_CASES + FUSED_TILE_CASES),
    "fused_join": (fused_conv, "JOIN_LAUNCHES", 1, FUSED_JOIN_CASES),
    "bias_act": (bn, "APPLY_LAUNCHES", 1, BIAS_ACT_CASES),
    "bn_bwd": (bn, "BWD_LAUNCHES", 1, BN_BWD_CASES),
    "block_fused": (block_fused, "LAUNCHES", 1, BLOCK_FUSED_CASES),
    "conv2d_bf16": (conv, "LAUNCHES_BF16", 1, BF16_CONV_CASES + TILE_CASES),
    "conv2d_dx_bf16": (conv, "DX_LAUNCHES_BF16", 1, BF16_DX_CASES + TILE_CASES),
    "conv2d_dw_bf16": (conv, "DW_LAUNCHES_BF16", 1, BF16_DW_CASES + TILE_CASES),
    "add_relu_bf16": (fused, "LAUNCHES_BF16", 1, BF16_ADD_RELU_CASES),
    "add_relu_mask_bf16": (fused, "MASK_LAUNCHES_BF16", 1, BF16_ADD_RELU_MASK_CASES),
    "matmul_bf16": (matmul, "LAUNCHES_BF16", 1, BF16_MATMUL_CASES),
    "matmul_bwd_bf16": (matmul, "BWD_LAUNCHES_BF16", 1, BF16_MATMUL_BWD_CASES),
    "moments_bf16": (bn, "LAUNCHES_BF16", 1, BF16_MOMENTS_CASES),
    "fused_conv_bf16": (fused_conv, "LAUNCHES_BF16", 1,
                        BF16_FUSED_CONV_CASES + FUSED_TILE_CASES),
    "fused_join_bf16": (fused_conv, "JOIN_LAUNCHES_BF16", 1, BF16_FUSED_JOIN_CASES),
    "bias_act_bf16": (bn, "APPLY_LAUNCHES_BF16", 1, BF16_BIAS_ACT_CASES),
    "bn_bwd_bf16": (bn, "BWD_LAUNCHES_BF16", 1, BF16_BN_BWD_CASES),
    "block_fused_bf16": (block_fused, "LAUNCHES_BF16", 1, BF16_BLOCK_FUSED_CASES),
    "qconv": (quant, "LAUNCHES", 1, QCONV_CASES),
    "qconv_grouped": (quant, "GROUPED_LAUNCHES", 1, QCONV_GROUPED_CASES),
    "quant_act": (quant, "ACT_LAUNCHES", 1, QUANT_ACT_CASES),
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
                 peak=FP32_FLOPS_PER_S, exact=False, bf16=False, library_label=None,
                 plain_reps=20):
        self.run, self.plain, self.library = run, plain, library
        # timed calls of the plain version (fewer where one takes ~0.1 s)
        self.plain_reps = plain_reps
        self.library_label = library_label  # printed where the yardstick needs saying
        self.exact = exact  # the kernel must equal the plain version bit for bit
        self.bf16 = bf16  # held by the bf16 rule (bf16_slack), not REL_TOL
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
    def randn(*shape, scale=1.0, offset=0, dtype=torch.float32):
        n = 1
        for s in shape:
            n *= s
        flat = (torch.randn(n + offset, generator=gen, device=device) * scale).to(dtype)
        return flat[offset:].view(shape)

    if kernel.endswith("_bf16"):
        return _bf16_case(kernel[:-len("_bf16")], case, randn)

    if kernel.startswith("conv2d"):
        n, (h, wd), cin, cout, k, s, pad, _, (ho, wo) = conv_case(case)
        x = randn(n, h, wd, cin)
        w = randn(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5)
        g = randn(n, ho, wo, cout)
        flops = 2 * n * ho * wo * k * k * cin * cout
        w_oihw = w.permute(3, 2, 0, 1)
        if pad is not None:  # a tile: JAX's explicit padding, no one library call
            runs = {"conv2d": (lambda: conv.conv2d(x, w, s, pad),
                               lambda: conv.conv2d_reference(x, w, s, pad)),
                    "conv2d_dx": (lambda: conv.conv2d_dx(g, w, x.shape, s, pad),
                                  lambda: conv.conv2d_dx_reference(g, w, x.shape, s, pad)),
                    "conv2d_dw": (lambda: conv.conv2d_dw(x, g, k, s, pad),
                                  lambda: conv.conv2d_dw_reference(x, g, k, s, pad))}
            return _Case(*runs[kernel], 4 * (x.numel() + w.numel() + g.numel()), 3 * flops,
                         peak=TF32_FLOPS_PER_S)
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
        _, m, c, *mode = case
        x = randn(m, c) * 2.0 + randn(1, c)
        if mode:  # the raw sums: no one library call computes both
            return _Case(lambda: bn.moments_sums(x), lambda: bn.moments_sums_reference(x),
                         4 * (m * c + 2 * c), 3 * m * c)
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
    if kernel == "qconv":
        return _qconv_case(case, gen, device)
    if kernel == "qconv_grouped":
        return _qconv_grouped_case(case, gen, device)
    if kernel == "quant_act":
        return _quant_act_case(case, randn, device)
    raise ValueError(f"unknown kernel {kernel!r}")


def qconv_operands(case, gen, device):
    """A Q1 (or, with groups as the case's last entry, Q3) case's operands:
    int8 values over the whole range (the largest accumulators), dq sized
    so that the epilogue's values spread around the cap and 0: (xq, w, dq,
    bias, packed weight, qconv's keywords)."""
    _, n, h, cin, cout, k, s, relu, cap, out, *grouped = case
    groups = grouped[0] if grouped else 1
    xq = torch.randint(-127, 128, (n, h, h, cin), generator=gen, device=device,
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (k, k, cin // groups, cout), generator=gen, device=device,
                      dtype=torch.int8)
    kk = k * k * cin // groups
    dq = (torch.rand(cout, generator=gen, device=device) + 0.5) * (4.0 / (127 * 127 * kk ** 0.5))
    b = torch.randn(cout, generator=gen, device=device)
    out_dtype = torch.float32 if out == "f32" else torch.bfloat16
    kw = dict(stride=s, relu=relu, cap=cap, out_dtype=out_dtype)
    if grouped:
        kw["groups"] = groups
    return xq, w, dq, b, quant.pack_weight(w, groups), kw


def qconv_im2col(xq: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """The (M, k*k*Cin) int8 rows of a conv's windows over the reference's
    padding, in the plain (di, dj, ci) order: the library yardstick's A."""
    n, h, wd, cin = xq.shape
    (top, bottom), (left, right) = reference_padding(h, k, s), reference_padding(wd, k, s)
    xp = F.pad(xq, (0, 0, left, right, top, bottom))
    win = xp.unfold(1, k, s).unfold(2, k, s)  # (N, Ho, Wo, Cin, k, k)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * cin)


def _qconv_case(case, gen, device) -> _Case:
    """Q1 on ``qconv_operands``; the yardstick ``torch._int_mm`` wherever it
    takes the shapes (M > 16, K and N multiples of 8; the stem's K 147
    zero-padded to 152), on an im2col of x made outside the timed call."""
    _, n, h, cin, cout, k, s, relu, cap, out = case
    xq, w, dq, b, wk, kw = qconv_operands(case, gen, device)
    ho = h // s
    kk = k * k * cin
    m = n * ho * ho
    library = None
    kpad = -(-kk // 8) * 8  # the stem's 147 -> 152: zeros add nothing
    if m > 16 and cout % 8 == 0:  # what _int_mm takes
        a2 = F.pad(qconv_im2col(xq, k, s), (0, kpad - kk)).contiguous()
        w2 = F.pad(w.reshape(kk, cout), (0, 0, 0, kpad - kk)).contiguous()

        def library():  # the integer product only
            return torch._int_mm(a2, w2)
    # a 1x1 conv reads only the pixels its stride lands on
    x_bytes = m * cin if k == 1 else xq.numel()
    return _Case(lambda: quant.qconv(xq, w, dq, b, wk=wk, **kw),
                 lambda: quant.qconv_reference(xq, w, dq, b, **kw),
                 x_bytes + w.numel() + m * cout * (4 if out == "f32" else 2) + 8 * cout,
                 2 * m * kk * cout, library, library_same=False, peak=INT8_OPS_PER_S,
                 exact=True, bf16=kw["out_dtype"] == torch.bfloat16,
                 library_label="torch._int_mm, the integer product alone (no epilogue)"
                 if library is not None else None)


def _qconv_grouped_case(case, gen, device) -> _Case:
    """Q3 on ``qconv_operands``; no one PyTorch call computes a grouped
    int8 conv (``torch._int_mm`` takes no groups), so no yardstick. The
    plain version (float64, cuDNN off) takes ~0.1 s a call at batch 128:
    3 timed calls there."""
    _, n, h, cin, cout, k, s, *_ = case
    xq, w, dq, b, wk, kw = qconv_operands(case, gen, device)
    m = n * (h // s) ** 2
    return _Case(lambda: quant.qconv(xq, w, dq, b, wk=wk, **kw),
                 lambda: quant.qconv_reference(xq, w, dq, b, **kw),
                 xq.numel() + w.numel() + m * cout * 2 + 8 * cout,
                 2 * m * w[..., 0].numel() * cout, peak=INT8_OPS_PER_S, exact=True,
                 bf16=True, plain_reps=3 if n >= 64 else 20)


def _quant_act_case(case, randn, device) -> _Case:
    """Q2 at a scale from the input's absmax (a calibrated site's), or on
    exact .5 ties at inv = 4, most of them beyond the clip."""
    label, shape, dtype, offset = case
    if label.startswith("ties"):
        numel = shape[0] * shape[1]
        x = (torch.arange(numel, device=device, dtype=torch.float32) - numel // 2 + 0.5) / 4
        x = x.view(shape).to(dtype)
        inv = 4.0
    else:
        x = randn(*shape, scale=3.0, offset=offset, dtype=dtype)
        scale = float(x.float().abs().max()) / 127.0
        inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    return _Case(lambda: quant.quant_act(x, inv), lambda: quant.quant_act_reference(x, inv),
                 x.numel() * (x.element_size() + 1), x.numel(), exact=True)


def conv_case(case) -> Tuple:
    """(n, (H, W), Cin, Cout, k, stride, padding or None, x's storage
    offset, (Ho, Wo)) of a conv case: (label, n, H=W, Cin, Cout, k, stride)
    with an optional offset, or a tile's (label, n, (H, W), ..., padding)."""
    _, n, h, cin, cout, k, s, *rest = case
    pad = rest[0] if rest and isinstance(rest[0], tuple) else None
    offset = rest[0] if rest and pad is None else 0
    h, wd = h if isinstance(h, tuple) else (h, h)
    geo = conv.geometry(h, wd, k, s, pad)
    return n, (h, wd), cin, cout, k, s, pad, offset, geo[2:]


def _bf16_case(kernel: str, case, randn) -> _Case:
    """The bf16 case of ``kernel``: the same wrapper on bf16 inputs, its
    plain version the wrapper's own (fp32 on the upcast inputs, one
    rounding), the library call the same PyTorch call in bf16."""
    bf = torch.bfloat16

    def r(*shape, scale=1.0, offset=0):
        return randn(*shape, scale=scale, offset=offset, dtype=bf)

    def r_(shape, offset):
        return r(*shape, offset=offset)

    if kernel.startswith("conv2d"):
        n, (h, wd), cin, cout, k, s, pad, offset, (ho, wo) = conv_case(case)
        x = r(n, h, wd, cin, offset=offset)
        w = r(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5)
        g = r(n, ho, wo, cout)
        nbytes = 2 * (x.numel() + w.numel() + g.numel())
        flops = 2 * n * ho * wo * k * k * cin * cout
        w_oihw = w.permute(3, 2, 0, 1)
        if pad is not None:  # a tile: JAX's explicit padding, no one library call
            runs = {"conv2d": (lambda: conv.conv2d(x, w, s, pad),
                               lambda: conv.conv2d_reference(x, w, s, pad)),
                    "conv2d_dx": (lambda: conv.conv2d_dx(g, w, x.shape, s, pad),
                                  lambda: conv.conv2d_dx_reference(g, w, x.shape, s, pad)),
                    "conv2d_dw": (lambda: conv.conv2d_dw(x, g, k, s, pad),
                                  lambda: conv.conv2d_dw_reference(x, g, k, s, pad))}
            return _Case(*runs[kernel], nbytes, flops, peak=BF16_FLOPS_PER_S, bf16=True)
        if kernel == "conv2d":
            run, plain = (lambda: conv.conv2d(x, w, s)), (lambda: conv.conv2d_reference(x, w, s))
            library, as_plain = (lambda: F.conv2d(_nchw(x), w_oihw, stride=s, padding=k // 2)), _nhwc
        elif kernel == "conv2d_dx":
            run = lambda: conv.conv2d_dx(g, w, x.shape, s)  # noqa: E731
            plain = lambda: conv.conv2d_dx_reference(g, w, x.shape, s)  # noqa: E731
            library = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
                (n, cin, h, h), w_oihw, _nchw(g), stride=s, padding=k // 2)
            as_plain = _nhwc
        else:
            run, plain = (lambda: conv.conv2d_dw(x, g, k, s)), (lambda: conv.conv2d_dw_reference(x, g, k, s))
            library = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
                _nchw(x), (cout, cin, k, k), _nchw(g), stride=s, padding=k // 2)
            as_plain = lambda dw: dw.permute(2, 3, 1, 0)  # noqa: E731
        return _Case(run, plain, nbytes, flops, library, as_plain, peak=BF16_FLOPS_PER_S,
                     bf16=True)
    if kernel in ("add_relu", "add_relu_mask"):
        _, shape, offset = case
        a, b, g = (r(*shape, offset=offset) for _ in range(3))
        if kernel == "add_relu":
            return _Case(lambda: fused.add_relu(a, b), lambda: fused.add_relu_reference(a, b),
                         6 * a.numel(), a.numel(), bf16=True)
        return _Case(lambda: fused.add_relu_mask(a, b, g),
                     lambda: fused.add_relu_mask_reference(a, b, g), 8 * a.numel(),
                     a.numel(), bf16=True)
    if kernel == "matmul":
        _, m, k, n, offset = case
        a, b = r(m, k), r(k, n, scale=0.01, offset=offset)
        return _Case(lambda: matmul.matmul(a, b), lambda: matmul.matmul_reference(a, b),
                     2 * (m * k + k * n + m * n), 2 * m * n * k, lambda: torch.matmul(a, b),
                     peak=BF16_FLOPS_PER_S, bf16=True)
    if kernel == "matmul_bwd":
        _, m, k, n, offset, need_a, need_b = case
        a, b, g = r(m, k), r(k, n, scale=0.01, offset=offset), r(m, n)
        want = (need_a, need_b)

        def needed(pair):
            return tuple(t for t, keep in zip(pair, want) if keep)

        nbytes = 2 * (m * n + need_a * (k * n + m * k) + need_b * (m * k + k * n))
        return _Case(lambda: needed(matmul.matmul_bwd(a, b, g, need_a, need_b)),
                     lambda: needed(matmul.matmul_bwd_reference(a, b, g)),
                     nbytes, 2 * m * n * k * (need_a + need_b),
                     lambda: needed((torch.matmul(g, b.t()) if need_a else None,
                                     torch.matmul(a.t(), g) if need_b else None)),
                     peak=BF16_FLOPS_PER_S, bf16=True)
    if kernel == "moments":
        _, m, c, *mode = case
        x = (randn(m, c) * 2.0 + randn(1, c)).to(bf)
        if mode:
            return _Case(lambda: bn.moments_sums(x), lambda: bn.moments_sums_reference(x),
                         2 * m * c + 8 * c, 3 * m * c, bf16=True)
        return _Case(lambda: bn.moments(x), lambda: bn.moments_reference(x),
                     2 * m * c + 8 * c, 3 * m * c,
                     lambda: torch.var_mean(x, dim=0, unbiased=False),
                     lambda vm: (vm[1], vm[0]), bf16=True)
    if kernel == "fused_conv":
        return _fused_conv_case(case, randn, bf)
    if kernel == "fused_join":
        _, shape, offset, cap = case
        c = shape[-1]
        e, r = r_(shape, offset), r_(shape, offset)
        se, sr = 1 + randn(c, scale=0.2), 1 + randn(c, scale=0.2)
        te, tr = randn(c, scale=0.2), randn(c, scale=0.2)
        return _Case(lambda: fused_conv.fused_join(e, se, te, r, sr, tr, cap),
                     lambda: fused_conv.fused_join_reference(e, se, te, r, sr, tr, cap),
                     6 * e.numel() + 16 * c, 6 * e.numel(), bf16=True)
    if kernel == "bias_act":
        _, shape, relu, cap, offset = case
        c = shape[-1]
        x = r_(shape, offset)
        scale, shift = 1 + randn(c, scale=0.2), randn(c, scale=0.5)
        return _Case(lambda: fused.bias_act(x, scale, shift, relu, cap),
                     lambda: bn.bn_apply_reference(x, scale, shift, relu=relu, cap=cap),
                     4 * x.numel() + 8 * c, 4 * x.numel(), bf16=True)
    if kernel == "bn_bwd":
        return _bn_bwd_case(case, randn, bf)
    if kernel == "block_fused":
        return _block_fused_case(case, randn, bf)
    raise ValueError(f"unknown bf16 kernel {kernel!r}")


def bf16_slack(want: torch.Tensor) -> torch.Tensor:
    """Per element, one bf16 ulp of the plain value (0 where it is 0) for a
    bf16 output; 0 for an fp32 one."""
    w = want.float().abs()
    if want.dtype is not torch.bfloat16:
        return torch.zeros_like(w)
    _, e = torch.frexp(w)  # w = f * 2^e, 0.5 <= f < 1: the ulp is 2^(e - 8)
    return torch.where(w > 0, torch.ldexp(torch.ones_like(w), e - 8), torch.zeros_like(w))


def fused_conv_case(case) -> Tuple:
    """(n, (H, W), Cin, Cout, k, stride, prologue, cap, padding or None,
    (Ho, Wo)) of a K8 case: (label, n, H=W, Cin, Cout, k, stride, prologue,
    cap), or a tile's (label, n, (H, W), ..., cap, padding)."""
    _, n, h, cin, cout, k, s, prologue, cap, *pad = case
    pad = pad[0] if pad else None
    h, wd = h if isinstance(h, tuple) else (h, h)
    return (n, (h, wd), cin, cout, k, s, prologue, cap, pad,
            conv.geometry(h, wd, k, s, pad)[2:])


def _fused_conv_case(case, randn, dtype=torch.float32) -> _Case:
    """K8 in fp32 (3 TF32 products per FLOP) or bf16 (x and w bf16, the
    rows fp32); a tile with its explicit padding (no one library call pads
    asymmetrically)."""
    n, (h, wd), cin, cout, k, s, prologue, cap, pad, (ho, wo) = fused_conv_case(case)
    exact = ", exact" in case[0]
    bf16 = dtype is torch.bfloat16
    if exact:
        # u = relu(x * 0 + shift) = shift, an integer 1..3 on every channel,
        # times weights in {-1, 0, 1}: every y, y^2 and sum is an integer
        # below 2^24, exact in fp32 in any order and in TF32's split (lo =
        # 0); in bf16 both sides round the same exact fp32 y. A halo tap
        # that became act(shift) moves an edge output by >= 1.
        x = randn(n, h, wd, cin).to(dtype)
        w = torch.round(randn(k, k, cin, cout)).clamp(-1.0, 1.0).to(dtype)
        scale = torch.zeros_like(randn(cin))
        shift = 1.0 + torch.round(randn(cin).abs()).clamp(0.0, 2.0)
    else:
        x = randn(n, h, wd, cin).to(dtype)
        w = randn(k, k, cin, cout, scale=(2.0 / (k * k * (cin + cout))) ** 0.5).to(dtype)
        # shift > 0 on about half the channels: relu(shift) must not reach the halo
        scale, shift = 1 + randn(cin, scale=0.2), randn(cin, scale=0.5)
    args = (x, w, scale, shift, s, pad, prologue, True, cap)

    def split(out):
        y, sums = out
        return y, sums[0], sums[1]

    flops = 2 * n * ho * wo * k * k * cin * cout
    library = None if pad is not None else (
        lambda: F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=s, padding=k // 2))
    return _Case(lambda: split(fused_conv.fused_conv(*args)),
                 lambda: split(fused_conv.fused_conv_reference(*args)),
                 x.element_size() * (x.numel() + w.numel() + n * ho * wo * cout)
                 + 4 * (2 * cin + 2 * cout),
                 flops if bf16 else 3 * flops, library,
                 library_same=False, peak=BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S,
                 exact=exact, bf16=bf16)


def _block_fused_staged(args, got):
    """K10's plain version stage by stage, each stage on the kernel's own
    results of the stage before (``got``, block_fused_forward's output):
    stage 0 from x, stage 1 from the kernel's r and (sc_r, sh_r), stage 2
    from its s and (sc_s, sh_s), the join from its e and (sc_e, sh_e); each
    stage's rows from its own plain sums. In bf16 an intermediate one ulp
    apart (two fp32 sums rounded after different orders) moves the next
    stage by that ulp times the following BN's scale, several of that
    stage's ulps where it cancels; held stage by stage, each output is one
    rounding from its plain value. Returns what block_fused_reference does."""
    from ..ops.conv import conv2d

    x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap = args
    _, r_k, s_k, e_k, _, _, _, aff = got
    n, h, wd, c4 = x.shape
    c, m, dt = w1.shape[1], n * h * wd, x.dtype

    def stage(a, w, shape, gamma, beta):
        y = (a.reshape(m, -1).float() @ w.to(dt).float()).reshape(shape)
        sums = fused_conv.channel_sums(y)
        return y.to(dt), sums, fused_conv.bn_affine_from_sums(sums, gamma, beta, m, eps)

    def act(a, sc, sh):
        v = torch.clamp_min(a.float() * sc + sh, 0.0)
        return (v if cap is None else torch.clamp_max(v, cap)).to(dt)

    r, sums_r, rows_r = stage(x, w1, (n, h, wd, c), g1, b1)
    s_f = conv2d(act(r_k, *aff[:2]).float(), w2.to(dt).float(), padding=((1, 1), (1, 1)))
    sums_s = fused_conv.channel_sums(s_f)
    rows_s = fused_conv.bn_affine_from_sums(sums_s, g2, b2, m, eps)
    e, sums_e, rows_e = stage(act(s_k, *aff[2:4]), w3, (n, h, wd, c4), g3, b3)
    out = torch.clamp_min(e_k.float() * aff[4] + aff[5] + x.float(), 0.0)
    out = (out if cap is None else torch.clamp_max(out, cap)).to(dt)
    return (out, r, s_f.to(dt), e, sums_r, sums_s, sums_e, (*rows_r, *rows_s, *rows_e))


def _block_fused_case(case, randn, dtype=torch.float32) -> _Case:
    """K10 in fp32 (3 TF32 products per FLOP, held to the plain version of
    the whole block) or bf16 (x and the weights bf16, γ and β fp32, held
    stage by stage, ``_block_fused_staged``)."""
    _, (n, h, w, c4), c, cap = case
    bf16 = dtype is torch.bfloat16
    # a block's input is a ReLU's output
    x = torch.clamp_min(randn(n, h, w, c4), 0.0).to(dtype)
    ws = (randn(c4, c, scale=(2.0 / c4) ** 0.5).to(dtype),
          randn(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5).to(dtype),
          randn(c, c4, scale=(2.0 / c) ** 0.5).to(dtype))
    # shift > 0 on about half the channels: relu(shift) must not reach the halo
    rows = [t for width in (c, c, c4) for t in (1 + randn(width, scale=0.2),
                                                randn(width, scale=0.5))]
    args = (x, *ws, *rows, 1e-7, cap)
    saved = {}

    def split(out):
        # out, r, s, e; each sum row on its own; the six affine rows
        *acts, sums_r, sums_s, sums_e, aff = out
        return (*acts, *sums_r, *sums_s, *sums_e, *aff)

    def run():
        saved["got"] = block_fused.block_fused_forward(*args)
        return split(saved["got"])

    def plain():
        if bf16:
            return split(_block_fused_staged(args, saved["got"]))
        return split(block_fused.block_fused_reference(*args))

    m = n * h * w
    row_floats = 2 * (4 * c + 2 * c4)  # gamma, beta in; the six rows out
    flops = 2 * m * (2 * c4 * c + 9 * c * c)
    return _Case(run, plain,
                 x.element_size() * (2 * m * c4 + 2 * m * c + m * c4
                                     + sum(t.numel() for t in ws))
                 + 4 * (row_floats + 2 * (2 * c + c4)),
                 flops if bf16 else 3 * flops,
                 timed=(lambda: block_fused.block_fused_forward(*args),
                        lambda: block_fused.block_fused_reference(*args)),
                 peak=BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S, bf16=bf16)


def _bn_bwd_case(case, randn, dtype=torch.float32) -> _Case:
    """batch_norm_act forward and backward (K4, K5, K6) on fp32 or bf16 x,
    γ and β fp32."""
    _, m, c, relu = case
    x = (randn(m, c) * 2.0 + randn(1, c)).to(dtype)
    gamma, beta = 1 + randn(c, scale=0.2), randn(c, scale=0.5)
    dy = randn(m, c).to(dtype)
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
    el = x.element_size()
    nbytes = el * (3 * m * c + max(0.0, 2 * m * c - L2_BYTES / el)) + 4 * 6 * c
    return _Case(run, plain, nbytes, 10 * m * c, library,
                 timed=(lambda: bn.bn_bwd(x, dy, mean, inv, gamma, beta, relu=relu),
                        lambda: bn.bn_bwd_reference(x, dy, mean, inv, gamma, beta,
                                                    relu=relu)),
                 library_covers=slice(1, None), bf16=dtype is torch.bfloat16)


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


def output_hash(tensors) -> str:
    """A digest of the tensors' bits: each one's dtype, shape and bytes,
    in order (16 hex digits)."""
    h = hashlib.blake2b(digest_size=8)
    for t in tensors:
        t = t.detach().contiguous()
        h.update(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def check_case(kernel: str, case, *, device="cuda", seed: int = 0,
               timing: bool = True) -> Dict[str, object]:
    """Run one case; raise RuntimeError where the kernel disagrees.

    Returns {kernel, case, max_abs_err, rel_err, bound_ms, bound_by} (and
    fp32_fma_bound_ms for the tensor-core kernels, out_hash for the bf16
    and ``HASHED`` kernels) and, with timing, ms,
    plain_ms, library_ms, device_ms (with device_kernels, its split by
    kernel name), library_device_ms and host_us."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = _make(kernel, case, gen, device)
    got, want = _outputs(c.run()), _outputs(c.plain())
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for i, (gt, wt) in enumerate(zip(got, want, strict=True)):
        if not gt.is_floating_point():  # int8 (Q2): compared as values
            gt, wt = gt.float(), wt.float()
        if gt.shape != wt.shape:
            raise RuntimeError(f"{kernel} {case[0]}: shape {tuple(gt.shape)} "
                               f"vs plain {tuple(wt.shape)}")
        finite = torch.isfinite(wt)
        if not torch.equal(finite, torch.isfinite(gt)):
            raise RuntimeError(f"{kernel} {case[0]}: non-finite values differ")
        if c.bf16:  # one bf16 ulp of each plain value plus 1e-5 of max|plain|
            diff = (gt[finite].float() - wt[finite].float()).abs()
            scale = wt[finite].float().abs().max().item() if finite.any() else 0.0
            over = diff - bf16_slack(wt[finite]) - BF16_REL_TOL * scale
            if finite.any() and over.max().item() > 0:
                raise RuntimeError(
                    f"{kernel} {case[0]} output {i}: {int((over > 0).sum())} elements beyond "
                    "one bf16 "
                    f"ulp + {BF16_REL_TOL} of max|plain| = {scale} (worst by "
                    f"{over.max().item()})")
            d = diff.max().item() if finite.any() else 0.0
            if c.exact and not torch.equal(gt, wt):
                raise RuntimeError(f"{kernel} {case[0]}: not equal to the plain version "
                                   f"bit for bit (max|kernel - plain| = {d})")
            err, rel = max(err, d), max(rel, d / scale if scale else d)
            continue
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
    if c.bf16 or kernel in HASHED:
        out["out_hash"] = output_hash(got)
    if c.library_label:
        out["library"] = c.library_label
    if c.library is not None and c.library_same:
        # the yardstick must compute the same function
        same = 1e-2 if c.bf16 else 1e-3
        for lt, wt in zip(_outputs(c.as_plain(c.library())), want[c.library_covers],
                          strict=True):
            scale = wt.float().abs().max().item()
            if (lt.float() - wt.float()).abs().max().item() > same * scale:
                raise RuntimeError(f"{kernel} {case[0]}: the library call computes "
                                   "another function")
    if timing:
        out["ms"] = median_ms(c.timed[0])
        out["plain_ms"] = median_ms(c.timed[1], reps=c.plain_reps)
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
