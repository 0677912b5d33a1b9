"""SGD with momentum: the port of resnet_tpu.optim.sgd (functional: returns
new tensors)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..bridge import flatten, leaves, tree_map, unflatten
from .adam import f32


class SGDState(NamedTuple):
    momentum_buf: Any
    step: torch.Tensor  # int32 scalar


def sgd_init(params) -> SGDState:
    return SGDState(
        momentum_buf=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                              params),
        step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
    )


def sgd_update(grads, state: SGDState, params, *, learning_rate,
               momentum: float = 0.9, weight_decay: float = 0.0,
               nesterov: bool = False, wd_mask=None):
    """One step: buf = mu * buf + (g + wd * p); p -= lr * buf (or, with
    nesterov, lr * (g' + mu * buf)). Returns (new_params, new_state)."""
    lr = learning_rate
    if isinstance(lr, torch.Tensor):
        lr = lr.to(torch.float32)
    else:
        lr = f32(lr)
    mu, wd = f32(momentum), f32(weight_decay)
    pairs = flatten(params)
    w_l = leaves(wd_mask) if wd_mask is not None else [1.0] * len(pairs)
    new_p, new_b = [], []
    for (path, p), g, buf, w in zip(pairs, leaves(grads), leaves(state.momentum_buf),
                                    w_l):
        pf = p.to(torch.float32)
        gf = g.to(torch.float32) + (wd * w) * pf
        nb = mu * buf + gf
        step_dir = gf + mu * nb if nesterov else nb
        new_p.append((path, (pf - lr * step_dir).to(p.dtype)))
        new_b.append((path, nb))
    return unflatten(new_p), SGDState(momentum_buf=unflatten(new_b),
                                      step=state.step + 1)
