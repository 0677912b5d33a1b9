"""Train and eval steps: the port of resnet_tpu.train.step.

One train step: forward in training mode, the summed cross-entropy (the
reference's gradient convention: summed over the batch, not averaged), its
gradient by autograd, then the optimizer. The reported loss is the batch
mean. PyTorch runs eagerly, so ``make_train_step`` only binds the config;
nothing between the phases waits for the host: the learning rate, the
metrics and the step stay device scalars until the caller reads them.

With ``OptimizerConfig(name='adam', fused=True, wd_mask='all')`` the update
is the one-launch Adam kernel, in place: the state passed in is consumed
and the returned state shares its tensors. Every other optimizer path
returns new tensors. ``grad_accum > 1`` sums the gradients of the
microbatches in a Python loop and merges the BN running statistics after
each one (train/step.py:175-252 in the JAX package).

Data parallelism (``mesh``, the data group of ``parallel.make_mesh``): the
step is JAX's pjit ('auto') step on the global batch, with each rank given
its own rows (``parallel.shard_batch``). Where the group has more than one
rank and BN takes batch statistics, the statistics are the global batch's
on every engine and under ghost BN (``kernels.bn.sync_stats`` with the data
group, ``stats_sum``: each layer's raw sums and row count summed over the
ranks, and the statistics' cotangents in the backward). After the backward
one all-reduce SUM of a flat bucket adds the gradients, the summed loss and
the correct count over the ranks: the gradient is the summed CE's over the
global batch, as one process on that batch gives it (not a mean: the
reference sums, resnet.cu:1806-1811). ``grad_accum > 1`` reduces once after
its microbatches. The running statistics merge from the global statistics,
so every rank keeps the same ones. With ``state_shardings`` (a ZeRO plan,
``state.zero_plan``) the state holds this rank's shards of the planned
parameters and of their optimizer buffers: the step all-gathers the whole
parameters for the forward, takes each summed gradient's shard, and the
optimizer (fused Adam, per-tensor Adam or SGD) updates the shards alone.

On the data x model grid (``parallel.make_mesh_2d``) with
``parallel.composite_shardings``'s plan, the step is JAX's composite one:
the state holds this rank's slices of the FC head (weights, bias, optimizer
buffers) on the class dimension; each data index's model ranks run the
trunk on the same rows, K3 (or the plain product) on the class slice, and
gather the fp32 logit slices over the model group
(``parallel.tensor_parallel``), so the loss is the whole row's and
replicated there; the features' cotangent is summed over the model group.
The BN statistics, the gradients, the summed loss and the correct count are
summed over the data group only (summing over every rank would count each
row ``model`` times); ``grad_norm`` counts each FC slice's squares summed
over the model group and every other leaf once; the optimizer updates each
rank's own leaves.

The head is split only where the plan splits an FC leaf: where
``composite_shardings`` replicated the FC (the model size does not divide
the class count) the grid is plain data parallelism with a replicated
head, each model rank computing the whole logits of its data index's rows,
everything summed over the data group.

On the data x spatial grid (``make_mesh_2d(data, spatial, axes=("data",
"spatial"))``, 'auto' only) the step is JAX's pjit step on images whose
height is split over the spatial group (``parallel.spatial_shard_batch``):
the forward and backward run inside ``parallel.spatial.partition``, each
conv and pool on the rank's rows with halo rows from its neighbours; the
parameters stay replicated. The BN statistics are the global batch's,
summed over data x spatial (ghost BN's sample goes by the data index, the
rows of one image being split); the gradients of every leaf the trunk
reaches are partial on each spatial rank and are summed over data x
spatial, while the FC head after the pool sees the same pooled features on
every spatial rank, so its gradients, the summed loss and the correct count
are summed over the data group only (one bucket over the grid, to which
only spatial rank 0 brings them); ``batch_n`` counts the global batch
once. A ZeRO plan shards over the data group and replicates over spatial.

With ``cfg.parallel.mode == 'shard_map'`` the same step is JAX's
explicit-collective one (``parallel.make_shard_map_train_step``): each rank
normalizes with its own statistics (local BN), the bucket is summed as
above, each rank merges its own statistics into the running statistics
(whatever the BN mode, as JAX's shard_map step does) and these are then
averaged over the ranks so the replicas stay equal. Since no statistic
crosses ranks inside the forward, that mode runs on every engine.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ..bridge import flatten, leaves, tree_map, unflatten
from ..config import TrainConfig
from ..kernels.bn import StatsGroup, sync_stats
from ..models import forward
from ..ops import cross_entropy, top1_accuracy, topk_accuracy, update_running_stats
from ..ops.precision import precision_scope
from ..optim import adam_update, adam_update_fused, make_schedule, sgd_update
from ..parallel import spatial
from ..parallel.mesh import Mesh2D
from ..parallel.tensor_parallel import fc_head
from .state import TrainState


def _on(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's images and labels as tensors on ``device``."""
    out = {}
    for key in ("images", "labels"):
        v = batch[key]
        v = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[key] = v.to(device)
    return out


def loss_and_grads(params, batch, bn_state, cfg: TrainConfig):
    """(summed CE, logits, aux, gradient tree) of one forward and backward
    in training mode. The returned tensors hold no graph. The backward runs
    inside the config's precision scope too: JAX's precision covers the
    VJP's convs."""
    pairs = flatten(params)
    leaves_ = [p.detach().requires_grad_(True) for _, p in pairs]
    with torch.enable_grad(), precision_scope(cfg.execution):
        logits, aux = forward(unflatten((path, t) for (path, _), t in zip(pairs, leaves_)),
                              batch["images"], cfg.model, cfg.execution, train=True,
                              bn_state=bn_state)
        loss = cross_entropy(logits, batch["labels"], reduction="sum",
                             label_smoothing=cfg.optimizer.label_smoothing)
        grads = torch.autograd.grad(loss, leaves_, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves_, grads)]
    return (loss.detach(), logits.detach(), aux,
            unflatten((path, g) for (path, _), g in zip(pairs, grads)))


def _merge_running_stats(bn_state, bn_stats, momentum: float):
    """EMA update of the running statistics, layer by layer."""
    if bn_state is None:
        return None

    def upd(state_leaf, mean, var):
        new_mean, new_var = update_running_stats(state_leaf["mean"], state_leaf["var"],
                                                 mean, var, momentum)
        return {"mean": new_mean, "var": new_var}

    return {
        "init_bn": upd(bn_state["init_bn"], *bn_stats["init_bn"]),
        "blocks": [{k: upd(sb[k], *bb[k]) for k in sb}
                   for sb, bb in zip(bn_state["blocks"], bn_stats["blocks"])],
    }


def _wd_mask_tree(params, mode: str):
    """Per-tensor weight-decay multiplier; 'no_bn' exempts BN gamma/beta and
    biases (the path test of train/step.py:64-78)."""
    if mode == "all":
        return None
    return unflatten(
        (path, 0.0 if any(t in path for t in ("gamma", "beta", "/b")) else 1.0)
        for path, _ in flatten(params))


def _apply_optimizer(grads, state: TrainState, cfg: TrainConfig):
    ocfg = cfg.optimizer
    lr = make_schedule(ocfg)(state.opt_state.step)
    if ocfg.name == "adam" and ocfg.fused and ocfg.wd_mask == "all":
        # the kernel has no per-tensor mask; masked configs take the path below
        new_params, new_opt = adam_update_fused(
            grads, state.opt_state, state.params, learning_rate=lr,
            weight_decay=ocfg.weight_decay, beta1=ocfg.beta1, beta2=ocfg.beta2,
            eps=ocfg.eps, nonfinite_guard=ocfg.nonfinite_guard)
    elif ocfg.name == "adam":
        new_params, new_opt = adam_update(
            grads, state.opt_state, state.params, learning_rate=lr,
            weight_decay=ocfg.weight_decay, beta1=ocfg.beta1, beta2=ocfg.beta2,
            eps=ocfg.eps, nonfinite_guard=ocfg.nonfinite_guard,
            wd_mask=_wd_mask_tree(state.params, ocfg.wd_mask))
    elif ocfg.name == "sgd":
        new_params, new_opt = sgd_update(
            grads, state.opt_state, state.params, learning_rate=lr,
            momentum=ocfg.momentum, weight_decay=ocfg.weight_decay,
            wd_mask=_wd_mask_tree(state.params, ocfg.wd_mask))
    else:
        raise ValueError(f"unknown optimizer {ocfg.name!r}")
    return new_params, new_opt, lr


def _accum_grads(state: TrainState, batch, cfg: TrainConfig, params=None):
    """Summed loss, correct count and gradients over grad_accum microbatches,
    with the running statistics merged after each; ``params`` (default
    ``state.params``) are the whole parameters the forward takes."""
    params = state.params if params is None else params
    a = cfg.execution.grad_accum
    n = batch["labels"].shape[0]
    if n % a != 0:
        raise ValueError(f"batch size {n} is not divisible by grad_accum={a}")
    m = n // a
    device = state.step.device
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    correct_acc = torch.zeros((), dtype=torch.float32, device=device)
    grads_acc = tree_map(torch.zeros_like, params)
    bn_state = state.bn_state
    for i in range(a):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss_sum, logits, aux, grads = loss_and_grads(params, mb, bn_state, cfg)
        grads_acc = tree_map(torch.add, grads_acc, grads)
        if cfg.execution.bn_mode == "batch":
            bn_state = _merge_running_stats(bn_state, aux["bn_stats"],
                                            cfg.model.bn_momentum)
        correct_acc = correct_acc + top1_accuracy(logits, mb["labels"], mean=False)
        loss_acc = loss_acc + loss_sum
    return loss_acc, correct_acc, grads_acc, bn_state


def train_step(state: TrainState, batch, cfg: TrainConfig, mesh=None, plan=None):
    """(state, batch) -> (new_state, metrics); batch holds NHWC "images" and
    integer "labels" as tensors or numpy arrays (with a mesh, this rank's
    rows); ``plan`` is a ZeRO plan of the state."""
    with precision_scope(cfg.execution):
        return _train_step(state, batch, cfg, mesh, plan)


def _groups(mesh):
    """(data group, model group or None, spatial group or None) of a mesh: a
    ``Mesh`` is the data group; a ``Mesh2D`` (``parallel.make_mesh_2d``)
    the data group and its second, a model group or, on a data x spatial
    grid (``Mesh2D.kind``), a spatial group."""
    if mesh is None:
        return None, None, None
    if not isinstance(mesh, Mesh2D):
        return mesh, None, None
    return (mesh.data, None, mesh.model) if mesh.is_spatial else (mesh.data, mesh.model, None)


def _local_bn(cfg: TrainConfig, mesh) -> bool:
    """True where each rank keeps its own BN statistics ('shard_map')."""
    return mesh is not None and cfg.parallel.mode == "shard_map"


def stats_sum(cfg: TrainConfig, mesh):
    """The statistics group that BN's batch statistics are summed over in
    the 'auto' step (``kernels.bn.StatsGroup``): the data group, where it
    has more than one rank and BN normalizes with batch statistics, else
    None (this rank's own statistics, as under 'shard_map'). On a data x
    model grid the data group only: a model group's ranks hold the same
    rows. On a data x spatial grid every rank of the grid, whose rows make
    the batch, with this rank's data index for ghost BN's sample."""
    data, _, sp = _groups(mesh)
    if data is None or cfg.execution.bn_mode != "batch" or _local_bn(cfg, data):
        return None
    if sp is not None:
        return StatsGroup(mesh.sum_, data.rank, data.size)
    if data.size == 1:
        return None
    return StatsGroup(data.sum_, data.rank, data.size)


def reduce_grads(mesh, grads, *scalars):
    """(gradient tree, *scalars) summed over the ranks in one bucket."""
    pairs = flatten(grads)
    summed = mesh.sum_tree([g for _, g in pairs] + list(scalars))
    return (unflatten((path, g) for (path, _), g in zip(pairs, summed)),
            *summed[len(pairs):])


def _is_head(path: str) -> bool:
    """A leaf of the FC head (after the pool)."""
    return path.split("/", 1)[0] == "fc"


def reduce_spatial(mesh: Mesh2D, grads, *scalars):
    """(gradient tree, *scalars) of a data x spatial grid in one bucket over
    the grid: the trunk's gradients, partial on each spatial rank, summed
    over data x spatial; the head's gradients and the scalars, the same on
    every rank of a spatial group, summed over the data group (spatial rank
    0 alone brings them)."""
    lead = mesh.spatial.rank == 0
    pairs = flatten(grads)
    own = [g if lead or not _is_head(path) else torch.zeros_like(g) for path, g in pairs]
    rest = [t if lead else torch.zeros_like(t) for t in scalars]
    summed = mesh.world.sum_tree(own + rest)
    return (unflatten((path, g) for (path, _), g in zip(pairs, summed)),
            *summed[len(pairs):])


def _splits_head(plan) -> bool:
    """Whether a plan splits an FC leaf (``composite_shardings`` replicates
    the FC where the model size does not divide the class count)."""
    return plan is not None and any(dim is not None and _is_head(path)
                                    for path, dim in flatten(plan.params))


def _whole(params, mesh, plan):
    """The whole parameters: the state's own, or gathered from its shards."""
    if plan is None:
        return params
    from ..parallel.multihost import fetch_global

    return fetch_global(params, plan.params, mesh)


def _grad_norm(grads, head=None, plan=None):
    """The norm of the whole gradient: with a split FC ``head`` (the model
    group) each sliced leaf's squares summed over it, every other leaf's
    once."""
    squares = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(grads)]
    if head is not None:
        split = [dim is not None for _, dim in flatten(plan.params)]
        parts = torch.stack([q for q, s in zip(squares, split) if s])
        head.sum_(parts)
        it = iter(parts.unbind(0))
        squares = [next(it) if s else q for q, s in zip(squares, split)]
    return torch.sqrt(sum(squares))


def _train_step(state: TrainState, batch, cfg: TrainConfig, mesh=None, plan=None):
    batch = _on(batch, state.step.device)
    data, model, sp = _groups(mesh)
    # on a grid with a plan that splits the FC, its slices stay on their
    # model ranks; a grid whose plan replicates the FC is data parallelism
    head = model if _splits_head(plan) else None
    if model is not None and head is None:
        plan = None
    params = state.params if head is not None else _whole(state.params, mesh, plan)
    with sync_stats(stats_sum(cfg, mesh)), fc_head(head), spatial.partition(sp):
        if cfg.execution.grad_accum > 1:
            loss_sum, n_correct, grads, new_bn = _accum_grads(state, batch, cfg, params)
        else:
            loss_sum, logits, aux, grads = loss_and_grads(params, batch, state.bn_state,
                                                          cfg)
            n_correct = top1_accuracy(logits, batch["labels"], mean=False)
            # only batch statistics are worth merging: 'frozen' returns the
            # running statistics themselves and 'off' placeholders ('shard_map'
            # merges them all the same, as JAX's does)
            if cfg.execution.bn_mode == "batch" or _local_bn(cfg, mesh):
                new_bn = _merge_running_stats(state.bn_state, aux["bn_stats"],
                                              cfg.model.bn_momentum)
            else:
                new_bn = state.bn_state

    batch_n = batch["labels"].shape[0]
    if sp is not None:
        grads, loss_sum, n_correct = reduce_spatial(mesh, grads, loss_sum, n_correct)
        batch_n *= data.size
    elif data is not None:
        grads, loss_sum, n_correct = reduce_grads(data, grads, loss_sum, n_correct)
        batch_n *= data.size
    if _local_bn(cfg, mesh) and new_bn is not None:
        # each rank merged its own statistics: average them so the replicas
        # stay equal
        pairs = flatten(new_bn)
        summed = data.sum_tree([t for _, t in pairs])
        new_bn = unflatten((path, t / data.size) for (path, _), t in zip(pairs, summed))
    grad_norm = _grad_norm(grads, head, plan)
    if plan is not None and head is None:
        from ..parallel.multihost import shard_of

        grads = unflatten((path, shard_of(g, dim, mesh)) for (path, g), (_, dim)
                          in zip(flatten(grads), flatten(plan.params)))
    new_params, new_opt, lr = _apply_optimizer(grads, state, cfg)
    metrics = {
        "loss": loss_sum / batch_n,
        "loss_sum": loss_sum,
        "accuracy": n_correct / batch_n,
        "learning_rate": lr,
        "grad_norm": grad_norm,
    }
    return TrainState(params=new_params, opt_state=new_opt, bn_state=new_bn,
                      step=state.step + 1), metrics


def eval_step(state: TrainState, batch, cfg: TrainConfig, mesh=None,
              plan=None) -> Dict[str, Any]:
    """Eval-mode forward (running statistics) of this rank's rows (on a data
    x spatial grid, its slice of their height): mean loss, top-1 and
    top-5."""
    batch = _on(batch, state.step.device)
    with torch.no_grad(), precision_scope(cfg.execution), spatial.partition(
            _groups(mesh)[2]):
        logits, _ = forward(_whole(state.params, mesh, plan), batch["images"], cfg.model,
                            cfg.execution,
                            train=False, bn_state=state.bn_state)
        return {
            "loss": cross_entropy(logits, batch["labels"], reduction="mean"),
            "accuracy": top1_accuracy(logits, batch["labels"]),
            "top5": topk_accuracy(logits, batch["labels"], 5),
        }


def check_spatial_step(cfg: TrainConfig) -> None:
    """JAX's refusals of the data x spatial step, with its messages
    (resnet_tpu/train/trainer.py:98-102, resnet_tpu/train/step.py:304-331):
    'shard_map', and ``grad_accum > 1``. The Trainer calls it before it
    makes a group."""
    if cfg.parallel.mode != "auto":
        raise ValueError(
            "spatial_devices > 1 requires parallel.mode='auto' "
            "(the SPMD partitioner derives the halo exchanges)")
    if cfg.execution.grad_accum > 1:
        raise ValueError(
            "grad_accum > 1 cannot be combined with "
            "non-batch-dim sharding (batch['images'] spec "
            "PartitionSpec('data', 'spatial')): XLA SPMD miscompiles the "
            "microbatched gradient collectives for "
            "spatially-sharded inputs (see "
            "train/step.py:make_train_step). Use "
            "grad_accum=1 with spatial partitioning, or "
            "drop --spatial-devices.")


def make_train_step(cfg: TrainConfig, mesh=None, state_shardings=None):
    """The train step bound to ``cfg``: step(state, batch); with a mesh the
    data-parallel step of ``cfg.parallel.mode``, with ``state_shardings`` on
    a ZeRO-sharded state; with a data x model grid (``parallel.make_mesh_2d``,
    'auto' only) and ``parallel.composite_shardings``'s plan, the composite
    step on a state whose FC head is split over the model group; with a data
    x spatial grid (``Mesh2D.kind`` "spatial"), the spatial step, with JAX's
    refusals (``check_spatial_step``)."""
    if isinstance(mesh, Mesh2D) and mesh.is_spatial:
        check_spatial_step(cfg)
    if isinstance(mesh, Mesh2D) and cfg.parallel.mode != "auto":
        raise ValueError("the data x model mesh takes parallel.mode='auto' (JAX's "
                         "composite step is its pjit step)")
    return functools.partial(train_step, cfg=cfg, mesh=mesh, plan=state_shardings)


def make_eval_step(cfg: TrainConfig, mesh=None, state_shardings=None):
    """The eval step bound to ``cfg``: step(state, batch)."""
    return functools.partial(eval_step, cfg=cfg, mesh=mesh, plan=state_shardings)
