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
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch

from ..bridge import flatten, leaves, tree_map, unflatten
from ..config import TrainConfig
from ..models import forward
from ..ops import cross_entropy, top1_accuracy, topk_accuracy, update_running_stats
from ..ops.precision import precision_scope
from ..optim import adam_update, adam_update_fused, make_schedule, sgd_update
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


def _accum_grads(state: TrainState, batch, cfg: TrainConfig):
    """Summed loss, correct count and gradients over grad_accum microbatches,
    with the running statistics merged after each."""
    a = cfg.execution.grad_accum
    n = batch["labels"].shape[0]
    if n % a != 0:
        raise ValueError(f"batch size {n} is not divisible by grad_accum={a}")
    m = n // a
    device = state.step.device
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    correct_acc = torch.zeros((), dtype=torch.float32, device=device)
    grads_acc = tree_map(torch.zeros_like, state.params)
    bn_state = state.bn_state
    for i in range(a):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss_sum, logits, aux, grads = loss_and_grads(state.params, mb, bn_state, cfg)
        grads_acc = tree_map(torch.add, grads_acc, grads)
        if cfg.execution.bn_mode == "batch":
            bn_state = _merge_running_stats(bn_state, aux["bn_stats"],
                                            cfg.model.bn_momentum)
        correct_acc = correct_acc + top1_accuracy(logits, mb["labels"], mean=False)
        loss_acc = loss_acc + loss_sum
    return loss_acc, correct_acc, grads_acc, bn_state


def train_step(state: TrainState, batch, cfg: TrainConfig):
    """(state, batch) -> (new_state, metrics); batch holds NHWC "images" and
    integer "labels" as tensors or numpy arrays."""
    with precision_scope(cfg.execution):
        return _train_step(state, batch, cfg)


def _train_step(state: TrainState, batch, cfg: TrainConfig):
    batch = _on(batch, state.step.device)
    if cfg.execution.grad_accum > 1:
        loss_sum, n_correct, grads, new_bn = _accum_grads(state, batch, cfg)
    else:
        loss_sum, logits, aux, grads = loss_and_grads(state.params, batch,
                                                      state.bn_state, cfg)
        n_correct = top1_accuracy(logits, batch["labels"], mean=False)
        # only batch statistics are worth merging: 'frozen' returns the
        # running statistics themselves and 'off' placeholders
        if cfg.execution.bn_mode == "batch":
            new_bn = _merge_running_stats(state.bn_state, aux["bn_stats"],
                                          cfg.model.bn_momentum)
        else:
            new_bn = state.bn_state

    grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in leaves(grads)))
    new_params, new_opt, lr = _apply_optimizer(grads, state, cfg)
    batch_n = batch["labels"].shape[0]
    metrics = {
        "loss": loss_sum / batch_n,
        "loss_sum": loss_sum,
        "accuracy": n_correct / batch_n,
        "learning_rate": lr,
        "grad_norm": grad_norm,
    }
    return TrainState(params=new_params, opt_state=new_opt, bn_state=new_bn,
                      step=state.step + 1), metrics


def eval_step(state: TrainState, batch, cfg: TrainConfig) -> Dict[str, Any]:
    """Eval-mode forward (running statistics): mean loss, top-1 and top-5."""
    batch = _on(batch, state.step.device)
    with torch.no_grad(), precision_scope(cfg.execution):
        logits, _ = forward(state.params, batch["images"], cfg.model, cfg.execution,
                            train=False, bn_state=state.bn_state)
        return {
            "loss": cross_entropy(logits, batch["labels"], reduction="mean"),
            "accuracy": top1_accuracy(logits, batch["labels"]),
            "top5": topk_accuracy(logits, batch["labels"], 5),
        }


def make_train_step(cfg: TrainConfig):
    """The train step bound to ``cfg``: step(state, batch)."""
    return functools.partial(train_step, cfg=cfg)


def make_eval_step(cfg: TrainConfig):
    """The eval step bound to ``cfg``: step(state, batch)."""
    return functools.partial(eval_step, cfg=cfg)
