"""Training: the port of resnet_tpu.train (step, state, checkpoints, the
Trainer and, in ``train.cli``, the command line)."""

from .checkpoint import (
    FINAL_DUMP_ID,
    NAN_DUMP_ID,
    AsyncCheckpointer,
    discover_latest_dump,
    restore_checkpoint,
    restore_npz,
    save_checkpoint,
    save_npz,
)
from .state import TrainState, init_train_state
from .step import eval_step, loss_and_grads, make_eval_step, make_train_step, train_step
from .trainer import NonFiniteError, Trainer

__all__ = [
    "TrainState",
    "init_train_state",
    "eval_step",
    "loss_and_grads",
    "make_eval_step",
    "make_train_step",
    "train_step",
    "Trainer",
    "NonFiniteError",
    "FINAL_DUMP_ID",
    "NAN_DUMP_ID",
    "AsyncCheckpointer",
    "discover_latest_dump",
    "restore_checkpoint",
    "restore_npz",
    "save_checkpoint",
    "save_npz",
]
