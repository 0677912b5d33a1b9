"""The training step, one module per resnet_tpu.train module ported so far."""

from .state import TrainState, init_train_state
from .step import eval_step, loss_and_grads, make_eval_step, make_train_step, train_step

__all__ = [
    "TrainState",
    "init_train_state",
    "eval_step",
    "loss_and_grads",
    "make_eval_step",
    "make_train_step",
    "train_step",
]
