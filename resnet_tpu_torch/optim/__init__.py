"""Optimizers and schedules, one module per resnet_tpu.optim module."""

from .adam import GuardedAdamState, adam_init, adam_update, adam_update_fused
from .schedules import make_schedule
from .sgd import SGDState, sgd_init, sgd_update

__all__ = [
    "GuardedAdamState",
    "SGDState",
    "adam_init",
    "adam_update",
    "adam_update_fused",
    "make_schedule",
    "sgd_init",
    "sgd_update",
]
