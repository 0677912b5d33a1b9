"""Adam with per-element non-finite guards, matching the reference optimizer.

The port of resnet_tpu.optim.adam (semantics at adam.py:1-25 there):

  g'  = g + wd * theta                  (weight decay folded into grad)
  m   = b1 * m + (1 - b1) * g'          (element SKIPPED if g non-finite)
  v   = b2 * v + (1 - b2) * g'^2        (element SKIPPED if g non-finite)
  theta <- theta - (lr * m^ / (sqrt(v^) + eps) + wd * theta)
                                        (element ROLLED BACK if non-finite)

with m^ = m / (1 - b1^t), v^ = v / (1 - b2^t). The decay products b1^t and
b2^t are carried in the state as fp32 device scalars, advanced before the
update, so they round as JAX's do (a float64 product on the host drifts).

``adam_update`` is the per-tensor version: it returns new tensors.
``adam_update_fused`` runs the one-launch kernel (``kernels.adam``) and
updates params and moments IN PLACE: the trees it returns hold the tensors
it was given. It has no per-tensor weight-decay mask.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..bridge import flatten, leaves, leaves_of, tree_map, unflatten
from ..kernels import adam as _kadam


class GuardedAdamState(NamedTuple):
    means: Any  # first-moment tree
    vars: Any  # second-moment tree
    mean_decay_prod: torch.Tensor  # b1^t, fp32 scalar
    var_decay_prod: torch.Tensor  # b2^t, fp32 scalar
    step: torch.Tensor  # int32 scalar


def f32(x: float) -> float:
    """The float32 value nearest x, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def adam_init(params) -> GuardedAdamState:
    device = leaves(params)[0].device
    return GuardedAdamState(
        means=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        vars=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        mean_decay_prod=torch.ones((), dtype=torch.float32, device=device),
        var_decay_prod=torch.ones((), dtype=torch.float32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _advance(state: GuardedAdamState, beta1: float, beta2: float):
    # as update_parameters does: step t uses b1^t with t starting at 1
    return state.mean_decay_prod * f32(beta1), state.var_decay_prod * f32(beta2)


def adam_update(grads, state: GuardedAdamState, params, *, learning_rate,
                weight_decay: float = 0.0, beta1: float = 0.9, beta2: float = 0.999,
                eps: float = 1e-7, nonfinite_guard: bool = True, wd_mask=None):
    """One Adam step, tensor by tensor. Returns (new_params, new_state).

    learning_rate may be a float or a device scalar (schedules); wd_mask an
    optional tree of per-tensor 0/1 multipliers on the weight decay."""
    cmd, cvd = _advance(state, beta1, beta2)
    pairs = flatten(params)
    device = pairs[0][1].device
    h = _kadam.hyper_row(learning_rate, weight_decay, beta1, beta2, eps, cmd, cvd,
                         nonfinite_guard, device)
    g_l, m_l, v_l = leaves(grads), leaves(state.means), leaves(state.vars)
    w_l = leaves(wd_mask) if wd_mask is not None else [1.0] * len(pairs)
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v, w in zip(pairs, g_l, m_l, v_l, w_l):
        np_, nm, nv = _kadam.adam_leaf_reference(p, g, m, v, h, w)
        new_p.append((path, np_.to(p.dtype)))
        new_m.append((path, nm))
        new_v.append((path, nv))
    return unflatten(new_p), GuardedAdamState(
        means=unflatten(new_m), vars=unflatten(new_v), mean_decay_prod=cmd,
        var_decay_prod=cvd, step=state.step + 1)


def adam_update_fused(grads, state: GuardedAdamState, params, *, learning_rate,
                      weight_decay: float = 0.0, beta1: float = 0.9,
                      beta2: float = 0.999, eps: float = 1e-7,
                      nonfinite_guard: bool = True):
    """The same step as ``adam_update`` (without a mask) in one launch of
    the Adam kernel, in place on params, means and vars. The kernel is fp32:
    bf16 parameters and gradients go to it as fp32 copies and the updated
    parameters are cast back into the bf16 tensors, as JAX casts around
    its flat fp32 buffer (optim/adam.py:145-166)."""
    cmd, cvd = _advance(state, beta1, beta2)
    ps, gs, ms, vs = leaves_of(params, grads, state.means, state.vars)
    h = _kadam.hyper_row(learning_rate, weight_decay, beta1, beta2, eps, cmd, cvd,
                         nonfinite_guard, ps[0].device)
    masters = [p if p.dtype is torch.float32 else p.float() for p in ps]
    _kadam.fused_adam(masters, [g.to(torch.float32).contiguous() for g in gs], ms, vs, h)
    with torch.no_grad():
        for p, master in zip(ps, masters):
            if master is not p:
                p.copy_(master)
    return params, GuardedAdamState(
        means=state.means, vars=state.vars, mean_decay_prod=cmd,
        var_decay_prod=cvd, step=state.step + 1)
