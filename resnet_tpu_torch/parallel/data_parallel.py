"""Explicit-collective data parallelism: the port of
resnet_tpu.parallel.data_parallel (JAX's shard_map step).

Each rank runs the local forward and backward on its own rows with its own
BN statistics ("local BN", the standard DP choice), then one all-reduce SUM
of a flat bucket adds the gradients, the summed loss and the correct count
over the ranks: the sum of gradients over the global batch, the reference's
summed (not averaged) CE gradient (resnet.cu:1806-1811) extended across
ranks. The metrics divide by the global row count. Each rank merges its own
statistics into the running statistics, which are then averaged over the
ranks so the replicas stay equal. Since each rank's BN is its own, the step
runs on every engine, the fused and whole-block ones included. The step is
``train.make_train_step``'s under ``parallel.mode='shard_map'``; the Trainer
refuses ``grad_accum > 1`` with it, as in JAX.
"""

from __future__ import annotations

import dataclasses

from ..config import TrainConfig
from .mesh import Mesh


def make_shard_map_train_step(cfg: TrainConfig, mesh: Mesh):
    """The explicit-collective step: step(state, batch) with batch this
    rank's rows."""
    # train imports parallel; importing train at module scope would be circular
    from ..train.step import make_train_step

    return make_train_step(dataclasses.replace(
        cfg, parallel=dataclasses.replace(cfg.parallel, mode="shard_map")), mesh)
