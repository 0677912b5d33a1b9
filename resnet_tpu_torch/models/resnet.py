"""ResNet forward (bottleneck and basic blocks), NHWC or NCHW
(``ExecutionConfig.layout``), fp32 or bf16 (``compute_dtype``), in training
and eval mode.

The port of resnet_tpu.models.resnet.forward:

  stem conv -> BN+ReLU -> 3x3/s2 maxpool
  -> blocks [1x1 reduce -> BN+ReLU -> 3x3 (stride here) -> BN+ReLU
     -> 1x1 expand -> BN -> (+ projected residual) -> ReLU]
  -> global avg pool -> FC (no bias in the reference)

In training mode BN normalizes with the batch statistics
(``bn_mode='batch'``) or the running ones (``'frozen'``); in eval mode always
with the running statistics (``bn_state``); ``bn_mode='off'`` skips the
normalization as in the JAX package. With ``bn_stats_batch = k`` below the
batch (ghost BN) a training BN takes its statistics from the first k images
(``ops.batchnorm.batch_norm_ghost``), ahead of the engine dispatch, as JAX's
``_bn_apply`` does (models/resnet.py:95-108). Inside
``kernels.bn.sync_stats`` (the data-parallel 'auto' step) every batch
statistic is the global batch's, whatever computes it (K4, the plain sums,
K8, ``conv_chain``, K10, ghost BN), and k is compared with the global
batch. The FC head goes through ``parallel.tensor_parallel``'s
``head_in`` and ``head_out``, the identity outside its ``fc_head`` (the
composite grid's split head). ``forward`` trains by default
(``train=True``), as the JAX package's does. ``ExecutionConfig.conv_kernels``
picks the conv engine and ``ExecutionConfig.kernels`` the BN statistics,
join and FC engine (``ops.dispatch``). The fused engines (``kernels``
'fused', 'hybrid', 'fusedxla') take the training forward with batch
statistics and no ghost BN to ``models.fused_resnet``
(models/resnet.py:275-288), ahead of remat, which they ignore as JAX's do;
in every other mode they run this path with plain ops, as in the JAX
package. ``kernels='blockfused'`` sends each stride-1 identity bottleneck of
that forward to the whole-block kernel (``kernels.block_fused``,
models/resnet.py:122-168) and runs every other block, the stem and the FC
here with plain ops. Every hand kernel is differentiable, so the same
forward serves the training step's autograd.

A grouped conv (ResNeXt, ``ModelConfig.groups > 1``) is the plain conv
under every ``conv_kernels``, as JAX's ``_conv`` sends it to XLA
(models/resnet.py:49-58); the other convs keep their engine, and the
whole-block kernel skips grouped blocks. With ``space_to_depth`` the stem
is ``ops.space_to_depth.s2d_stem_conv`` (the plain conv on the folded
image) wherever JAX takes that route (NHWC, a 7x7/s2 stem, even H and W,
models/resnet.py:300-314), whatever ``conv_kernels`` says; elsewhere, and
on the fused engines' route, which JAX takes first, the standard stem.

Remat (``ExecutionConfig.remat``, models/resnet.py:331-373), on this path in
a training forward without the tape:

* ``'block'`` runs each block, and ``'stage'`` each stage, under
  ``torch.utils.checkpoint`` (non-reentrant): autograd keeps the block's
  (stage's) input and outputs only and reruns it in the backward, every
  kernel in it included. The stem and the head run once.
* ``'elementwise'`` keeps the conv outputs and the BN batch statistics and
  recomputes BN apply, ReLU and the residual join, the policy of JAX's
  ``_SAVE_CONVS`` (models/resnet.py:34-46). Torch's selective checkpointing
  sees only dispatcher ops, and the hand kernels are ctypes launches inside
  autograd Functions, so the policy is built by hand: each conv and each
  layer's statistics (K4 under ``kernels='pallas'``) run outside any
  checkpoint, and each elementwise segment runs under one: BN apply (+ReLU)
  after each ReLU'd BN, and the last BN apply(s) with the join. What autograd
  keeps of a block is then its input, the conv outputs, the statistics and
  the convs' own inputs (the ReLU'd activations, which the conv backward
  needs for dW); what it drops and recomputes are the join's inputs and
  the elementwise ops' masks. The rerun join launches K2 again; no conv and
  no K4 launch is repeated. JAX's policy saves the outputs of XLA's
  ``conv_general_dilated`` and ``dot_general`` only: it does not see a
  Pallas conv (a ``pallas_call``) as a conv, so with
  ``conv_kernels='pallas'`` JAX recomputes those convs too; here the conv
  outputs are kept on both engines. A whole-block kernel has no elementwise
  segment of its own, so under ``'elementwise'`` it is checkpointed whole,
  as JAX's policy recomputes its ``pallas_call``.

Every checkpointed function enters ``ops.precision.precision_scope`` itself,
so that the rerun's plain convs keep the config's TF32 setting when the
backward runs outside ``forward``'s scope. The BN statistics of a
checkpointed block are its outputs, so the rerun's are dropped and the
running-statistics merge sees each once.

Layout and dtype follow the JAX package: the images are cast to the compute
dtype at the stem (models/resnet.py:294), the BN statistics are fp32 and
the normalization runs in fp32 before its cast, ReLU and the cap run in the
compute dtype, and the logits go to fp32 after the FC's bias. NCHW runs
the plain ops on the NCHW tensors; the hand conv kernel takes them through
a transpose to NHWC and back, and K4 is NHWC-only (``ops.dispatch``). The
fused and whole-block routes need NHWC; they run in bf16 on the bf16
entries of K4, K5, K8, K9 and K10, with the casts of JAX's routes
(``models.fused_resnet``; the whole block's input cast to the compute
dtype, its weights to it and its γ, β to fp32 inside ``block_fused``).
Runs that JAX sends down the standard path (NCHW, eval, ghost BN, frozen
BN) do so here too, in bf16 as well.

Inside ``parallel.spatial.partition`` (the data x spatial step) the
activations are this rank's rows of the images: the stem, every conv
(grouped ones too), the max pool and the pool before the head run on the
rank's haloed tile with the row plan's explicit padding (``_conv``,
``_max_pool``, ``_avg_pool``), K1 with JAX's padding under
``conv_kernels='pallas'``; the space-to-depth stem folds and convolves the
rank's rows through the plan (``ops.space_to_depth.s2d_stem_conv``), its
test on the images' global height; the fused engines run their sites on the
rank's tiles (``models.fused_resnet``). The whole-block engine raises
there with JAX's message (``config.check_spatial``).

``capture=True`` returns the reference's activation tape in
``aux["activations"]``, keyed as JAX keys it (models/resnet.py:174-216,
:318-391): it turns off the fused route, the whole-block kernel and remat,
as JAX's does.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ExecutionConfig, ModelConfig, check_spatial
from ..kernels.bn import sample_rows
from ..ops import global_avg_pool, max_pool, relu, softmax
from ..ops.batchnorm import batch_norm_ghost
from ..ops.conv import channel_dim, conv2d
from ..ops.dispatch import bn_act, bn_stats, conv as _dispatch_conv, fc, residual_join
from ..ops.precision import precision_scope
from ..ops.space_to_depth import s2d_stem_conv
from ..parallel import spatial
from ..parallel.tensor_parallel import head_in, head_out

_FUSED_ENGINES = ("fused", "hybrid", "fusedxla")


def _conv(x, w, *, stride, ecfg, groups=1):
    """The conv of the config's engine; inside a spatial partition on the
    rank's haloed tile with the plan's padding."""
    def run(t, padding=None):
        if groups > 1:
            # a grouped conv (ResNeXt) is the plain conv under every
            # conv_kernels, as JAX sends it to XLA (models/resnet.py:49-58)
            return conv2d(t, w, stride=stride, groups=groups, layout=ecfg.layout,
                          padding=padding)
        return _dispatch_conv(t, w, stride=stride, engine=ecfg.conv_kernels,
                              layout=ecfg.layout, padding=padding)

    if spatial.active() is None:
        return run(x)
    return spatial.conv(x, w.shape[0], stride, ecfg.layout, run)


def _max_pool(x, *, mcfg, ecfg):
    if spatial.active() is None:
        return max_pool(x, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride,
                        layout=ecfg.layout)
    return spatial.max_pool(x, mcfg.maxpool_kernel, mcfg.maxpool_stride, ecfg.layout)


def _avg_pool(x, *, ecfg):
    if spatial.active() is None:
        return global_avg_pool(x, layout=ecfg.layout)
    return spatial.global_avg_pool(x, ecfg.layout)


def _use_s2d(x, mcfg, ecfg) -> bool:
    """JAX's test for the space-to-depth stem (models/resnet.py:300-307):
    asked for, NHWC, a 7x7/s2 stem and even H and W; inside a spatial
    partition the images' global H, as JAX tests the global shape."""
    if not (ecfg.space_to_depth and ecfg.layout == "NHWC" and mcfg.init_kernel == 7
            and mcfg.init_stride == 2):
        return False
    part = spatial.active()
    height = x.shape[1] if part is None else part.plan(x, ecfg.layout)[0]
    return height % 2 == 0 and x.shape[2] % 2 == 0


def _checkpoint(fn, *args, ecfg):
    """fn(*args) under ``torch.utils.checkpoint`` (non-reentrant), rerun in
    the backward inside the config's precision scope."""
    def scoped(*a):
        with precision_scope(ecfg):
            return fn(*a)

    return checkpoint(scoped, *args, use_reentrant=False)


def _taped(tape, name, t):
    """t, recorded (detached) in the activation tape under ``name`` when
    there is one."""
    if tape is not None:
        tape[name] = t.detach()
    return t


def _bn_batch(x) -> int:
    """The images BN's batch statistics are over: x's, or inside
    ``kernels.bn.sync_stats`` those of the group's global batch."""
    return sample_rows(x.shape[0])[0]


def _bn_stats(x, state, *, ecfg, train):
    """The statistics a BN layer normalizes with, ahead of its apply: the
    running ones in eval and frozen mode, else the batch's (K4 under
    kernels='pallas'), differentiable; None where the apply takes its own
    (ghost BN, bn_mode='off')."""
    if ecfg.bn_mode == "off":
        return None
    if not train or ecfg.bn_mode == "frozen":
        if state is None:
            raise ValueError("eval-mode/frozen BN requires running statistics")
        return state["mean"], state["var"]
    if 0 < ecfg.bn_stats_batch < _bn_batch(x):
        return None  # ghost BN
    return bn_stats(x, engine=ecfg.kernels, layout=ecfg.layout)


def _bn_apply(x, stats, bn_params, *, eps, ecfg, relu_fused=False):
    """BN (+ the following ReLU) with the statistics of ``_bn_stats``.
    Returns (y, the statistics it normalized with, detached)."""
    relu_cap = ecfg.relu_cap if relu_fused else None
    if stats is None:
        if ecfg.bn_mode == "off":
            y = x
            zero = torch.zeros((x.shape[channel_dim(ecfg.layout)],), device=x.device,
                               dtype=torch.float32)
            mean, var = zero, zero + 1.0
        else:
            # ghost BN: its own closed-form VJP, whatever the engine
            y, (mean, var) = batch_norm_ghost(x, bn_params["gamma"], bn_params["beta"],
                                              ecfg.bn_stats_batch, eps=eps,
                                              layout=ecfg.layout)
        if relu_fused:
            y = relu(y)
            if relu_cap is not None:
                y = torch.clamp_max(y, relu_cap)
        return y, (mean.detach(), var.detach())
    y, (mean, var) = bn_act(
        x, bn_params["gamma"], bn_params["beta"], eps=eps, relu=relu_fused,
        relu_cap=relu_cap, engine=ecfg.kernels, layout=ecfg.layout, mean=stats[0],
        var=stats[1],
    )
    return y, (mean.detach(), var.detach())


def _block_fused_eligible(bp, stride, mcfg, ecfg, train) -> bool:
    """The JAX package's test for the whole-block kernel
    (models/resnet.py:122-131). Its two further conditions, a block width
    4C that is a multiple of 128 and a batch tiling of 8-sublane row blocks
    (:132-141), exist only for Mosaic's tiles; the CUDA kernel masks any
    width and row count, so they are dropped."""
    return (ecfg.kernels == "blockfused" and stride == 1 and "proj" not in bp
            and ecfg.layout == "NHWC" and train and ecfg.bn_mode == "batch"
            and not ecfg.bn_stats_batch and mcfg.groups == 1)


def _whole_block(bp, x, *, mcfg, ecfg):
    """One stride-1 identity bottleneck through ``block_fused`` in the
    compute dtype; its batch statistics from the kernel's sums over the rows
    they count (inside ``kernels.bn.sync_stats``, the group's), detached
    (models/resnet.py:143-168)."""
    from ..kernels.block_fused import block_fused, bn_stats_from_sums

    w1, w3 = bp["reduce"]["w"], bp["expand"]["w"]
    out, *sums, m = block_fused(
        x.to(ecfg.cdtype), w1.reshape(w1.shape[-2], w1.shape[-1]), bp["spatial"]["w"],
        w3.reshape(w3.shape[-2], w3.shape[-1]),
        bp["bn_reduce"]["gamma"], bp["bn_reduce"]["beta"],
        bp["bn_spatial"]["gamma"], bp["bn_spatial"]["beta"],
        bp["bn_expand"]["gamma"], bp["bn_expand"]["beta"], mcfg.bn_eps, ecfg.relu_cap, True)
    return out, {name: bn_stats_from_sums(s.detach(), m)
                 for name, s in zip(("bn_reduce", "bn_spatial", "bn_expand"), sums)}


class _Layers:
    """A block's BN layers and its join. With ``save_convs`` (remat
    'elementwise') each layer's statistics run here and its apply under a
    checkpoint; the join's BN apply(s) and the join run under one."""

    def __init__(self, bp, state, *, mcfg, ecfg, train, save_convs, tape):
        self.bp, self.state, self.ecfg, self.train = bp, state, ecfg, train
        self.eps, self.save_convs, self.tape = mcfg.bn_eps, save_convs, tape

    def _segment(self, fn, *args):
        if self.save_convs:
            return _checkpoint(fn, *args, ecfg=self.ecfg)
        return fn(*args)

    def _stats(self, y, name):
        return _bn_stats(y, self.state.get(name), ecfg=self.ecfg, train=self.train)

    def bn(self, y, name, relu_fused=False):
        """(BN(+ReLU) of y, its statistics) for layer ``name``."""
        apply = functools.partial(_bn_apply, bn_params=self.bp[name], eps=self.eps,
                                  ecfg=self.ecfg, relu_fused=relu_fused)
        return self._segment(apply, y, self._stats(y, name))

    def join(self, e, e_name, r, r_name=None):
        """relu(BN(e) + r), r through its own BN where ``r_name`` names one;
        returns (out, the statistics of e's BN and of r's, or None)."""
        ecfg = self.ecfg

        def fn(e, e_stats, r, r_stats):
            z, e_out = _bn_apply(e, e_stats, self.bp[e_name], eps=self.eps, ecfg=ecfg)
            r_out = None
            if r_name is not None:
                r, r_out = _bn_apply(r, r_stats, self.bp[r_name], eps=self.eps,
                                     ecfg=ecfg)
                _taped(self.tape, "transformed_residual", r)
            out = residual_join(z, r, engine=ecfg.kernels, relu_cap=ecfg.relu_cap)
            return out, e_out, r_out

        r_stats = self._stats(r, r_name) if r_name is not None else None
        return self._segment(fn, e, self._stats(e, e_name), r, r_stats)


def _bottleneck_block(bp, x, *, state, stride, mcfg, ecfg, train, tape=None,
                      save_convs=False):
    if tape is None and _block_fused_eligible(bp, stride, mcfg, ecfg, train):
        if save_convs:
            return _checkpoint(functools.partial(_whole_block, bp, mcfg=mcfg, ecfg=ecfg),
                               x, ecfg=ecfg)
        return _whole_block(bp, x, mcfg=mcfg, ecfg=ecfg)
    layers = _Layers(bp, state, mcfg=mcfg, ecfg=ecfg, train=train,
                     save_convs=save_convs, tape=tape)
    stats: Dict[str, Any] = {}
    out = _taped(tape, "post_reduced", _conv(x, bp["reduce"]["w"], stride=1, ecfg=ecfg))
    out, stats["bn_reduce"] = layers.bn(out, "bn_reduce", relu_fused=True)
    out = _taped(tape, "post_spatial", _conv(out, bp["spatial"]["w"], stride=stride,
                                             ecfg=ecfg, groups=mcfg.groups))
    out, stats["bn_spatial"] = layers.bn(out, "bn_spatial", relu_fused=True)
    out = _taped(tape, "post_expanded", _conv(out, bp["expand"]["w"], stride=1, ecfg=ecfg))
    if "proj" in bp:
        residual = _conv(x, bp["proj"]["w"], stride=stride, ecfg=ecfg)
        out, stats["bn_expand"], stats["bn_proj"] = layers.join(
            out, "bn_expand", residual, "bn_proj")
    else:
        out, stats["bn_expand"], _ = layers.join(out, "bn_expand", x)
    _taped(tape, "output_activated", out)
    return out, stats


def _basic_block(bp, x, *, state, stride, mcfg, ecfg, train, tape=None, save_convs=False):
    """The basic block; JAX's keeps no tape entries for it, nor does this."""
    layers = _Layers(bp, state, mcfg=mcfg, ecfg=ecfg, train=train,
                     save_convs=save_convs, tape=None)
    stats: Dict[str, Any] = {}
    out = _conv(x, bp["conv1"]["w"], stride=stride, ecfg=ecfg)
    out, stats["bn1"] = layers.bn(out, "bn1", relu_fused=True)
    out = _conv(out, bp["conv2"]["w"], stride=1, ecfg=ecfg)
    if "proj" in bp:
        residual = _conv(x, bp["proj"]["w"], stride=stride, ecfg=ecfg)
        out, stats["bn2"], stats["bn_proj"] = layers.join(out, "bn2", residual, "bn_proj")
    else:
        out, stats["bn2"], _ = layers.join(out, "bn2", x)
    return out, stats


def forward(
    params,
    x: torch.Tensor,
    mcfg: ModelConfig,
    ecfg: Optional[ExecutionConfig] = None,
    *,
    train: bool = True,
    bn_state=None,
    capture: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the network on NHWC (or, under ``ecfg.layout='NCHW'``, NCHW)
    images. Returns (fp32 logits, aux) with
    aux["bn_stats"] the per-layer (mean, var) the forward normalized with,
    detached (in training with bn_mode='batch', the batch statistics), and
    with ``capture`` aux["activations"], the reference's activation tape
    (detached tensors keyed after its Activations struct, resnet.h:99-152).
    The plain convs and the FC run at ``ecfg.matmul_precision``
    (``ops.precision.precision_scope``)."""
    ecfg = ecfg or ExecutionConfig()
    with precision_scope(ecfg):
        return _forward(params, x, mcfg, ecfg, train, bn_state, capture)


def _forward(params, x, mcfg, ecfg, train, bn_state, capture):
    if spatial.active() is not None:
        check_spatial(ecfg)
    if (train and not capture and ecfg.kernels in _FUSED_ENGINES
            and ecfg.layout == "NHWC" and ecfg.bn_mode == "batch"
            and not ecfg.bn_stats_batch):
        from .fused_resnet import fused_forward

        return fused_forward(params, x, mcfg, ecfg)
    needs_state = ecfg.bn_mode == "frozen" or (not train and ecfg.bn_mode != "off")
    if bn_state is None and needs_state:
        raise ValueError("eval-mode/frozen BN requires running statistics (bn_state)")
    block_fn = _bottleneck_block if mcfg.bottleneck else _basic_block
    remat = ecfg.remat if train and not capture else "none"
    tape: Optional[Dict[str, Any]] = {} if capture else None
    # bn_mode='off' reads no statistics, so bn_state may be None there
    state = bn_state or {"blocks": [{}] * mcfg.num_blocks}
    stats: Dict[str, Any] = {}
    x = x.to(ecfg.cdtype)
    if _use_s2d(x, mcfg, ecfg):
        stem = s2d_stem_conv(x, params["init_conv"]["w"])
    else:
        stem = _conv(x, params["init_conv"]["w"], stride=mcfg.init_stride, ecfg=ecfg)
    out = _taped(tape, "init_conv_applied", stem)
    out, stats["init_bn"] = _bn_apply(
        out, _bn_stats(out, state.get("init_bn"), ecfg=ecfg, train=train),
        params["init_bn"], eps=mcfg.bn_eps, ecfg=ecfg, relu_fused=True)
    _taped(tape, "init_conv_activated", out)
    out = _taped(tape, "init_convblock_input", _max_pool(out, mcfg=mcfg, ecfg=ecfg))

    block_tapes = [{} if capture else None for _ in range(mcfg.num_blocks)]

    def run_blocks(h, start, count):
        """Blocks [start, start + count): (h, their statistics)."""
        block_stats = []
        for i in range(start, start + count):
            run = functools.partial(
                block_fn, params["blocks"][i], state=state["blocks"][i],
                stride=2 if mcfg.is_reduction_block(i) else 1, mcfg=mcfg, ecfg=ecfg,
                train=train, tape=block_tapes[i], save_convs=remat == "elementwise")
            if remat == "block":
                h, bstats = _checkpoint(run, h, ecfg=ecfg)
            else:
                h, bstats = run(h)
            block_stats.append(bstats)
        return h, block_stats

    if remat == "stage":
        stats["blocks"], start = [], 0
        for n in mcfg.block_sizes:
            out, stage_stats = _checkpoint(
                functools.partial(run_blocks, start=start, count=n), out, ecfg=ecfg)
            stats["blocks"].extend(stage_stats)
            start += n
    else:
        out, stats["blocks"] = run_blocks(out, 0, mcfg.num_blocks)

    pooled = _avg_pool(out, ecfg=ecfg)
    logits = head_out(fc(head_in(pooled), params["fc"]["w"], params["fc"].get("b"),
                         engine=ecfg.kernels).to(torch.float32))
    aux: Dict[str, Any] = {"bn_stats": stats}
    if capture:
        for i, bt in enumerate(block_tapes):
            tape[f"block_{i:02d}"] = bt
        tape["final_avg_pool"] = pooled.detach()
        tape["linear_output"] = logits.detach()
        tape["pred"] = softmax(logits.detach(), stable=ecfg.stable_softmax)
        aux["activations"] = tape
    return logits, aux


def predict(params, x, mcfg, ecfg=None, *, bn_state=None, stable_softmax=True):
    """Inference probabilities using running BN statistics."""
    logits, _ = forward(params, x, mcfg, ecfg, train=False, bn_state=bn_state)
    return softmax(logits, stable=stable_softmax)
