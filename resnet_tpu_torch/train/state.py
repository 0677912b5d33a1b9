"""Training state: the port of resnet_tpu.train.state.

Parameters, optimizer state (Adam moments and decay products, or the SGD
momentum), BN running statistics and the global step, as nested dicts and
lists of tensors on one device.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..config import TrainConfig
from ..models import init_bn_state, init_params
from ..optim import adam_init, sgd_init


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
