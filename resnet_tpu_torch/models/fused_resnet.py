"""The fused engines' training forward (``ExecutionConfig.kernels`` in
'fused', 'hybrid', 'fusedxla'): the port of resnet_tpu.models.fused_resnet.

Every activation is written once by the conv that produces it and read once
by the op that consumes it: each block conv is a ``fused_conv`` site whose
prologue applies the previous layer's BN affine and ReLU to its input and
whose epilogue gives this layer's BN statistics [Σy, Σy²]; each residual
join applies both pending BN affines (``fused_join``). The stem is a plain
conv, the K4 statistics and one K5 pass (``bias_act``, the max pool cannot
host a prologue: gamma may be negative), then the max pool; the head is the
plain global pool and ``ops.linear``. The same batch-statistics BN, centred
windows and zero padding as ``models.resnet.forward(train=True)``.

Engines, per conv site (``_conv_site``):
  * 'fused': K8 at every site;
  * 'fusedxla': ``conv_chain`` (the contract in torch ops) at every site,
    and the stem statistics, the stem affine and the joins in torch ops:
    the fused dataflow with no hand kernel;
  * 'hybrid': K8 at the sites of ``FUSED_SITES``, ``conv_chain`` elsewhere;
    joins and stem as 'fused'. The table is empty, as the JAX package's is
    by default (fused_resnet.py:53): a site enters it only on an in-step
    measurement on the card that shows a gain.

``models.resnet.forward`` routes here in training with NHWC, bn_mode
'batch' and no ghost BN; every other case runs the standard path.

Inside ``kernels.bn.sync_stats`` (the data-parallel 'auto' step across
ranks) every BN layer's statistics are the global batch's, as the JAX
package's pjit step computes them: each conv site's [Σy, Σy²] and its row
count go through ``kernels.bn.sum_stats`` (one float64 all-reduce of the
group, the sums' cotangents summed in the backward) before the statistics
and the next prologue's (scale, shift) are taken from them; K8 itself does
not change, its sums being complete when the launch ends. The stems take
``kernels.bn.moments`` (K4's raw sums) or ``ops.batch_moments`` (the plain
sums), which sum over the group themselves.

Inside ``parallel.spatial.partition`` (the data x spatial step, whose
statistics group is the whole grid) the activations are this rank's rows
of the images, as on the standard path: the stem conv, every site and the
max pool run on the rank's haloed tile with the row plan's explicit
padding (``parallel.spatial.conv``), K8 and the chain with that padding.
The halo carries a site's raw input, the previous conv's y, so K8's
prologue runs on the neighbours' real rows, and only the image's edges are
padding, 0 after the prologue as on the whole image; the backward returns
the halo rows' cotangent to their owner, and the prologue's dscale, dshift
of those rows stay with the rank that applied it. Each site's statistics
are its sums over the rank's own output rows, summed over the grid. K4
and K5 at the stem and K9 at every join run on the rank's rows unchanged
(the row plan puts both operands of a join on the same rows); the pool
before the head is the group's sum (``spatial.global_avg_pool``).

Dtypes as in resnet_tpu/models/fused_resnet.py:100-239: the images are
cast to the compute dtype at the stem (:110); the stem's statistics are
K4's fp32 ones and its affine rows fp32 from the upcast γ and β
(:150-151); each site's weight is cast to the activation's dtype inside
K8 or the chain, and its (scale, shift) rows are fp32
(``bn_affine_from_sums``); the identity join's rows are fp32 ones and
zeros (:193, :228); the logits are fp32 (:238). So under bf16 compute the
stem runs K4, K5 and the max pool on bf16, every site K8 on bf16 (or the
chain in bf16) and every join K9 on bf16; with bf16 parameters the
weights are cast where JAX casts them.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import ExecutionConfig, ModelConfig
from ..kernels import bn as _kbn
from ..kernels.fused import bias_act
from ..kernels.fused_conv import (
    bn_affine_from_sums,
    conv_chain,
    fused_conv,
    fused_join,
    fused_join_reference,
)
from ..ops import batch_moments, conv2d, linear
from ..parallel import spatial
from ..parallel.tensor_parallel import head_in, head_out
from .resnet import _avg_pool, _max_pool

# (input H, Cin, Cout, k, stride) of the sites where 'hybrid' takes K8
FUSED_SITES: frozenset = frozenset()


def _stats(sums, m):
    """Detached (mean, biased var) from [Σy, Σy²] over m rows."""
    sums = sums.detach()
    return _kbn.mean_var_from_sums(sums[0], sums[1], m)


def _conv_site(x, w, scale, shift, stride, prologue, relu, cap, ecfg: ExecutionConfig):
    """(y, sums) of one site; inside a spatial partition on the rank's
    haloed tile of the raw x (the prologue runs on the neighbours' real
    rows), with the tile's padding, and the site keyed by the global input
    height, the same on every rank."""
    part = spatial.active()
    height = x.shape[1] if part is None else part.plan(x, "NHWC")[0]
    chain = ecfg.kernels == "fusedxla" or (
        ecfg.kernels == "hybrid"
        and (height, x.shape[3], w.shape[3], w.shape[0], stride) not in FUSED_SITES)

    def run(t, padding=None):
        if chain:
            return conv_chain(t, w, scale, shift, stride, prologue, relu, cap, padding)
        return fused_conv(t, w, scale, shift, stride, padding, prologue, relu, cap)

    if part is None:
        return run(x)
    return spatial.conv(x, w.shape[0], stride, "NHWC", run)


def _stem_conv(x, w, stride):
    """The stem's plain conv; inside a spatial partition on the rank's
    haloed tile with the tile's padding."""
    if spatial.active() is None:
        return conv2d(x, w, stride=stride)
    return spatial.conv(x, w.shape[0], stride, "NHWC",
                        lambda t, padding: conv2d(t, w, stride=stride, padding=padding))


def fused_forward(params, x: torch.Tensor, mcfg: ModelConfig,
                  ecfg: ExecutionConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Training forward of the fused engines on NHWC images: (fp32 logits,
    {"bn_stats": ...}) with the batch statistics of every BN layer, detached,
    in the tree of ``models.resnet.forward``."""
    if mcfg.groups > 1:
        raise ValueError(f"kernels={ecfg.kernels!r}: the fused engines have no grouped conv "
                         f"(groups={mcfg.groups}); JAX's fail on it too")
    eps = mcfg.bn_eps
    cap = ecfg.relu_cap
    all_plain = ecfg.kernels == "fusedxla"
    x = x.to(ecfg.cdtype)
    ones = torch.ones((1,), dtype=torch.float32, device=x.device)
    zeros = torch.zeros((1,), dtype=torch.float32, device=x.device)
    join = fused_join_reference if all_plain else fused_join

    def site(bp, conv, bn, inp, affine, stride, bstats):
        """Conv site ``conv`` of block bp: the prologue from ``affine``
        ((scale, shift) or None for none), then BN layer ``bn``'s statistics
        and its pending (scale, shift)."""
        scale, shift = affine if affine is not None else (ones, zeros)
        on = affine is not None
        y, sums = _conv_site(inp, bp[conv]["w"], scale, shift, stride, on, on,
                             cap if on else None, ecfg)
        # inside kernels.bn.sync_stats, the sums and rows of every rank (a
        # rank's own output rows under spatial partitioning: y is no tile)
        sums, m = _kbn.sum_stats(sums, y.shape[0] * y.shape[1] * y.shape[2])
        bstats[bn] = _stats(sums, m)
        return y, bn_affine_from_sums(sums, bp[bn]["gamma"], bp[bn]["beta"], m, eps)

    y0 = _stem_conv(x, params["init_conv"]["w"], mcfg.init_stride)
    if all_plain:
        mean0, var0 = batch_moments(y0)
    else:
        mean0, var0 = _kbn.moments(y0.reshape(-1, y0.shape[-1]))
    stats: Dict[str, Any] = {"init_bn": (mean0.detach(), var0.detach())}
    sc0 = params["init_bn"]["gamma"].float() * torch.rsqrt(var0 + eps)
    sh0 = params["init_bn"]["beta"].float() - sc0 * mean0
    if all_plain:
        act0 = _kbn.bn_apply_reference(y0, sc0, sh0, relu=True, cap=cap)
    else:
        act0 = bias_act(y0, sc0, sh0, True, cap)
    out = _max_pool(act0, mcfg=mcfg, ecfg=ecfg)

    block_stats = []
    for i, bp in enumerate(params["blocks"]):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        bstats: Dict[str, Any] = {}
        if mcfg.bottleneck:
            r, aff_r = site(bp, "reduce", "bn_reduce", out, None, 1, bstats)
            s_, aff_s = site(bp, "spatial", "bn_spatial", r, aff_r, stride, bstats)
            e, aff_e = site(bp, "expand", "bn_expand", s_, aff_s, 1, bstats)
        else:  # basic block (resnet18/34)
            c1, aff_1 = site(bp, "conv1", "bn1", out, None, stride, bstats)
            e, aff_e = site(bp, "conv2", "bn2", c1, aff_1, 1, bstats)
        if "proj" in bp:
            p, aff_p = site(bp, "proj", "bn_proj", out, None, stride, bstats)
            out = join(e, *aff_e, p, *aff_p, cap)
        else:
            c = out.shape[-1]
            out = join(e, *aff_e, out, torch.ones((c,), device=x.device),
                       torch.zeros((c,), device=x.device), cap)
        block_stats.append(bstats)
    stats["blocks"] = block_stats

    logits = linear(head_in(_avg_pool(out, ecfg=ecfg)), params["fc"]["w"],
                    params["fc"].get("b"))
    return head_out(logits.to(torch.float32)), {"bn_stats": stats}
