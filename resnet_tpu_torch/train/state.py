"""Training state: the port of resnet_tpu.train.state.

Parameters, optimizer state (Adam moments and decay products, or the SGD
momentum), BN running statistics and the global step, as nested dicts and
lists of tensors on one device.

Under ZeRO the same ``TrainState`` holds this rank's shards: ``zero_plan``
is the plan the port applies (a ``TrainState`` of sharded dimensions). Its
parameters follow JAX's rule (``parallel.zero_shardings``); each optimizer
buffer follows its parameter's plan (the two differ only where a bf16
parameter is under ``min_bytes`` and its fp32 moment is not), and the BN
running statistics stay whole: every rank updates them from the same
statistics, and at ResNet-50 each is under the default 64 KiB.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..bridge import leaves
from ..config import TrainConfig
from ..models import init_bn_state, init_params
from ..optim import GuardedAdamState, SGDState, adam_init, sgd_init


class TrainState(NamedTuple):
    params: Any
    opt_state: Any  # GuardedAdamState | SGDState
    bn_state: Optional[Any]  # running BN statistics, or None
    step: torch.Tensor  # int32 scalar


def init_train_state(cfg: TrainConfig, gen: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """A fresh state from ``gen`` (default: seeded with ``cfg.seed``), on the
    card unless ``device`` says otherwise."""
    if gen is None:
        gen = torch.Generator().manual_seed(cfg.seed)
    params = init_params(gen, cfg.model, device=device, dtype=cfg.execution.pdtype)
    if cfg.optimizer.name == "adam":
        opt_state = adam_init(params)
    elif cfg.optimizer.name == "sgd":
        opt_state = sgd_init(params)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer.name!r}")
    bn_state = (init_bn_state(cfg.model, device=device)
                if cfg.model.track_running_stats else None)
    return TrainState(params=params, opt_state=opt_state, bn_state=bn_state,
                      step=torch.zeros((), dtype=torch.int32, device=device))


def zero_plan(state: TrainState, mesh, min_bytes: int = 2 ** 16) -> TrainState:
    """The ZeRO plan the step and the checkpoints apply to ``state`` (whole):
    the parameters' dimensions by ``parallel.zero_shardings``, the optimizer
    buffers their parameters', None everywhere else."""
    from ..parallel import zero_shardings

    pp = zero_shardings(state.params, mesh, min_bytes=min_bytes)
    opt = state.opt_state
    if isinstance(opt, GuardedAdamState):
        opt_plan = GuardedAdamState(means=pp, vars=pp, mean_decay_prod=None,
                                    var_decay_prod=None, step=None)
    elif isinstance(opt, SGDState):
        opt_plan = SGDState(momentum_buf=pp, step=None)
    else:
        raise ValueError(f"unknown optimizer state {type(opt).__name__}")
    return TrainState(params=pp, opt_state=opt_plan, bn_state=None, step=None)


def state_bytes(state: TrainState) -> int:
    """Bytes of every tensor the state holds (on this rank)."""
    return sum(t.numel() * t.element_size()
               for t in leaves([state.params, list(state.opt_state), state.bn_state,
                                state.step]) if isinstance(t, torch.Tensor))
