"""Training loop: the port of resnet_tpu.train.trainer — the analogue of
main()'s epoch/iter loop (resnet.cu:3222-3429).

Per iteration the reference does: load_new_batch -> sync -> forward_pass ->
host loss/accuracy -> backwards_pass -> update_parameters(+dump). Here the
input pipeline stages batches on the device ahead of the step
(``data.prefetch``), the step is enqueued, and its metrics are read one
step behind: a ``.item()`` on a CUDA tensor waits for the device, so each
step's metrics are read only after the next step has been enqueued, and
only when ``record_metrics`` is on.

Failure handling mirrors the reference: optional per-step finite scan of the
parameters (check_errors, resnet.cu:2879-2907); on a non-finite hit, the
state dumps to sentinel id 99999999 and training aborts with a forensic
report. Periodic checkpoints every cfg.checkpoint_every steps, before the
update (resnet.cu:2947), final dump at sentinel 77777777
(resnet.cu:3424-3425), resume from cfg.resume_from (LOAD_FROM_DUMP_ID,
resnet.cu:3299-3304).

Data parallelism: with a process group of more than one rank (torchrun, or
``parallel.initialize_distributed``), or ``num_devices > 1``, the Trainer
runs on the data group (``parallel.make_mesh``), one rank per device (under
NCCL ``cuda:<local rank>``, under gloo the device the caller names), with
JAX's rejections and messages: ZeRO without a group, ZeRO with
``kernels='blockfused'``, ZeRO under 'shard_map', 'shard_map' with
``grad_accum > 1``. ``cfg.data.batch_size``
is one host's batch, as in JAX; a host's ranks split it evenly, so the
global batch is ``batch_size`` x hosts and images/sec counts it (the JAX
trainer counts one host's batch). From shards each rank reads a stream of
its own, ``num_shards / ranks`` shards after the previous rank's; other
sources give each rank its rows of the host batch (``parallel.rows_of``).
A dump holds rank 0's cursor, and each rank derives its own stream position
from it on resume (the JAX trainer offsets only a fresh cursor, so its
resumed hosts read one stream: ROADMAP.md, "Faults in the reference").
Rank 0 alone logs and writes dumps; every rank joins their gathers.

Spatial partitioning (``spatial_devices`` s > 1): the ranks form JAX's data
x spatial grid (``parallel.make_mesh_2d(ranks / s, s, axes=(data_axis,
spatial_axis))``), with JAX's refusals and messages (no mesh, 'shard_map',
``grad_accum > 1``, a device count, ``input_dim`` or global batch the axes
do not divide, several hosts where s does not divide a host's ranks). A
host's ranks are its data ranks times s; each data rank takes its share of
the host batch (from shards, a stream per data rank), and each of its s
spatial ranks the same rows and its slice of their height
(``rank_batch``). ZeRO shards over the data group and replicates over
spatial. The step and eval run on the grid; images/sec count the global
batch once.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import replace
from typing import Any, Dict, Iterator, Optional

import torch

from ..config import BLOCKFUSED_SHARDED, RESUME_LATEST, TrainConfig
from ..data import (
    ShardCursor,
    ShardDataset,
    ShardIterator,
    SyntheticDataset,
    prefetch_to_device,
)
from ..parallel import distributed, make_mesh, make_mesh_2d, replicate
from ..parallel.mesh import Mesh2D, height_slice, rows_of
from ..parallel.multihost import fetch_global, put_global
from ..utils import MetricsLogger, check_state_finite, nonfinite_report
from .checkpoint import (
    FINAL_DUMP_ID,
    NAN_DUMP_ID,
    AsyncCheckpointer,
    discover_latest_dump,
    restore_checkpoint,
    save_checkpoint,
)
from .state import init_train_state, zero_plan
from .step import check_spatial_step, make_eval_step, make_train_step


class NonFiniteError(RuntimeError):
    pass


class Trainer:
    """Train ``cfg`` on the card unless ``device`` says otherwise, from
    ``data_source`` (host batches) or the data ``cfg.data`` names; across
    the ranks of a process group when ``use_mesh`` (by default: more than
    one rank, or ``num_devices > 1``)."""

    def __init__(
        self,
        cfg: TrainConfig,
        *,
        data_source: Optional[Iterator] = None,
        use_mesh: Optional[bool] = None,
        device="cuda",
    ):
        self.cfg = cfg
        pcfg = cfg.parallel
        ranks = distributed.world_size()
        if use_mesh is None:
            use_mesh = ranks > 1 or pcfg.num_devices > 1
        if not use_mesh and (pcfg.spatial_devices > 1 or pcfg.zero_sharding):
            # fail loudly: a user validating spatial/ZeRO configs must not
            # get a silently-unsharded run
            raise ValueError(
                "spatial_devices/zero_sharding need a device mesh, but "
                "use_mesh is off (single device or --no-mesh)"
            )
        if pcfg.zero_sharding and cfg.execution.kernels == "blockfused":
            # JAX's refusal, with its message (spatial_devices > 1 with
            # blockfused the config refuses, config.check_spatial)
            raise ValueError(BLOCKFUSED_SHARDED)
        if pcfg.spatial_devices > 1:
            check_spatial_step(cfg)  # 'shard_map', grad_accum > 1
        if not use_mesh and ranks > 1:
            raise ValueError(f"use_mesh is off but {ranks} ranks are running: each would "
                             "train alone on its own batches")
        if use_mesh and pcfg.spatial_devices > 1:
            self.mesh = self._spatial_mesh(cfg, ranks)
        else:
            self.mesh = make_mesh(pcfg.num_devices, pcfg.data_axis) if use_mesh else None
        if self.mesh is not None:
            device = distributed.rank_device(torch.distributed.get_backend(), device)
            if pcfg.zero_sharding and pcfg.mode == "shard_map":
                raise ValueError(
                    "zero_sharding requires parallel.mode='auto' (the SPMD"
                    " partitioner derives the state all-gathers)"
                )
            if pcfg.mode == "shard_map" and cfg.execution.grad_accum > 1:
                # the explicit step is single-pass: it would silently IGNORE
                # the accumulation request
                raise ValueError(
                    "parallel.mode='shard_map' does not implement "
                    "grad_accum > 1 (its step computes single-pass "
                    "gradients); use parallel.mode='auto' for the "
                    "microbatch-accumulated step"
                )
        self.device = torch.device(device)
        self.state = init_train_state(cfg, device=self.device)
        self.cursor = ShardCursor()
        self.checkpointer = AsyncCheckpointer() if cfg.async_checkpoint else None
        resume_from = cfg.resume_from
        if resume_from == RESUME_LATEST:
            resume_from = discover_latest_dump(cfg.checkpoint_dir)
            if resume_from is None:
                raise FileNotFoundError(
                    f"resume_from=RESUME_LATEST but no complete dump exists "
                    f"under {cfg.checkpoint_dir!r}"
                )
        if resume_from is not None and resume_from >= 0:
            self.state, self.cursor = restore_checkpoint(
                cfg.checkpoint_dir, resume_from, self.state
            )
            print(f"resumed from dump {resume_from} at step {int(self.state.step)}")
        self._state_shardings = None
        if self.mesh is not None and pcfg.zero_sharding:
            # every rank holds the same whole state (seeded init, or the
            # restored dump): each keeps its shards of it
            self._state_shardings = zero_plan(self.state, self.mesh, pcfg.zero_min_bytes)
            self.state = put_global(self.state, self._state_shardings, self.mesh)
        elif self.mesh is not None:
            self.state = replicate(self.state, self._world())
        self.train_step = make_train_step(cfg, self.mesh, self._state_shardings)
        self.eval_step = make_eval_step(cfg, self.mesh, self._state_shardings)
        self.loader = "source" if data_source is not None else None
        self._host_iter = data_source or self._build_data()
        self._dev_iter = None  # built lazily, shared across run() calls
        lead = self.mesh is None or self.mesh.rank == 0
        self.logger = MetricsLogger(
            # the metrics are global (summed over the ranks in the step): one
            # writer is the whole record
            (cfg.checkpoint_dir or None) if lead else None,
            print_every=cfg.log_every if lead else 0,
            batch_size=cfg.data.batch_size * (
                distributed.host_count() if self.mesh is not None else 1),
        )

    @staticmethod
    def _spatial_mesh(cfg: TrainConfig, ranks: int) -> Mesh2D:
        """The data x spatial grid, after JAX's checks and with its messages
        (resnet_tpu/train/trainer.py:94-138)."""
        pcfg = cfg.parallel
        nd = pcfg.num_devices or ranks
        n_data = nd // pcfg.spatial_devices
        if nd % pcfg.spatial_devices:
            raise ValueError(
                f"{nd} devices not divisible by "
                f"spatial_devices={pcfg.spatial_devices}"
            )
        if cfg.model.input_dim % pcfg.spatial_devices:
            raise ValueError(
                f"input_dim {cfg.model.input_dim} not divisible by "
                f"spatial_devices={pcfg.spatial_devices}"
            )
        hosts = distributed.host_count()
        global_batch = cfg.data.batch_size * hosts
        if global_batch % n_data:
            raise ValueError(
                f"global batch {global_batch} (batch_size "
                f"{cfg.data.batch_size} x {hosts} hosts) "
                f"not divisible by the data-axis size {n_data} "
                f"({nd} devices / spatial_devices={pcfg.spatial_devices})"
            )
        if hosts > 1 and distributed.local_device_count() % pcfg.spatial_devices:
            raise ValueError(
                f"spatial_devices={pcfg.spatial_devices} must divide "
                f"the per-host device count "
                f"({distributed.local_device_count()}): an H-shard group "
                "straddling hosts would put conv halos on DCN"
            )
        return make_mesh_2d(n_data, pcfg.spatial_devices,
                            axes=(pcfg.data_axis, pcfg.spatial_axis), kind="spatial")

    def _world(self):
        """The group every rank of the mesh is in (the grid's, on a grid)."""
        return self.mesh.world if isinstance(self.mesh, Mesh2D) else self.mesh

    def _ckpt(self):
        """The checkpoint calls' group arguments."""
        return {"mesh": self.mesh, "plan": self._state_shardings}

    def _spatial(self) -> int:
        """The ranks that split an image's height (1: none)."""
        return self.mesh.spatial.size if isinstance(self.mesh, Mesh2D) else 1

    def _rows(self, rows: bool = True):
        """This rank's part of a host batch (None on one device): its rows
        (its share among the host's data ranks) and, on a spatial grid, its
        slice of their height; ``rows`` False: the height slice alone (a
        shard stream is already the data rank's own)."""
        if self.mesh is None:
            return None
        accum = self.cfg.execution.grad_accum if self.cfg.parallel.mode == "auto" else 1
        s = self._spatial()
        local = distributed.local_rank()
        split = functools.partial(rows_of, index=local // s,
                                  count=distributed.local_device_count() // s,
                                  grad_accum=accum)
        if s == 1:
            return split if rows else None
        layout = self.cfg.execution.layout

        def part(batch):
            batch = split(batch) if rows else batch
            return {k: (height_slice(v, local % s, s, layout)
                        if len(getattr(v, "shape", ())) >= 3 else v) for k, v in batch.items()}

        return part

    def rank_batch(self, batch):
        """This rank's part of a host batch (the batch itself on one
        device): what ``evaluate`` takes from its source."""
        rows = self._rows()
        return batch if rows is None else rows(batch)

    def _build_data(self):
        """The host iterator ``cfg.data`` names; sets ``self.loader`` to the
        one chosen (jpeg, synthetic, native or python) and logs it."""
        dcfg = self.cfg.data
        if dcfg.jpeg_dir:
            from ..data import JpegDataset

            self._chose("jpeg", dcfg.jpeg_dir)
            return JpegDataset(
                dcfg.jpeg_dir,
                dcfg.batch_size,
                out_dim=self.cfg.model.input_dim,
                train=True,
                layout=self.cfg.execution.layout,
                seed=self.cfg.seed,
            )
        if dcfg.synthetic or not dcfg.shard_dir:
            self._chose("synthetic", "SyntheticDataset")
            return SyntheticDataset(
                dcfg.batch_size,
                image_dim=self.cfg.model.input_dim,
                channels=self.cfg.model.in_channels,
                num_classes=self.cfg.model.num_classes,
                layout=self.cfg.execution.layout,
            )
        dataset = ShardDataset(
            dcfg.shard_dir,
            num_shards=dcfg.num_shards,
            shard_images=dcfg.shard_images,
            image_dim=self.cfg.model.input_dim,
            channels=self.cfg.model.in_channels,
            disk_layout=dcfg.layout,
        )
        batch, cursor = dcfg.batch_size, self.cursor
        if self.mesh is not None:
            # a stream per data rank, of its share of the host batch, from
            # its own position derived from the (rank 0) cursor; a spatial
            # group's ranks read one stream
            s = self._spatial()
            local = distributed.local_device_count() // s
            if batch % local:
                raise ValueError(f"batch_size {batch} (one host's batch) does not split "
                                 f"over the host's {local} data ranks")
            batch //= local
            cursor = rank_cursor(self.cursor, self.mesh.rank // s, self.mesh.size // s,
                                 dcfg.num_shards, dcfg.shard_images // batch)
        # prefer the native C++ read-ahead loader (csrc/shard_loader.cc);
        # the Python mmap iterator runs when it is not built or when
        # train-time flip augmentation is on (the flip runs host-side)
        from ..data.native import NativeShardIterator, native_available, native_status

        # the iterator gets a *copy* of the cursor: its worker thread runs
        # ahead of training by the prefetch depth, so the live cursor must
        # never be the one checkpoints record. self.cursor tracks the last
        # trained batch via the per-batch snapshots (run() below); dumping
        # it matches the reference's synchronous cursor-at-update semantics
        # (dump_trainer inside update_parameters, resnet.cu:2947-2950).
        if not dcfg.random_flip and native_available():
            self._chose("native", native_status())
            return NativeShardIterator(
                dataset,
                batch,
                layout=self.cfg.execution.layout,
                cursor=replace(cursor),
                prefetch_depth=max(2, dcfg.prefetch),
            )
        self._chose("python", "random_flip" if dcfg.random_flip else native_status())
        return ShardIterator(
            dataset,
            batch,
            layout=self.cfg.execution.layout,
            cursor=replace(cursor),
            random_flip=dcfg.random_flip,
            seed=self.cfg.seed,
        )

    def _chose(self, loader: str, why: str):
        if self.loader is None:  # the training stream's loader, not eval's
            self.loader = loader
        print(f"input: {loader} loader ({why})", flush=True)

    def _device_iter(self):
        # one persistent prefetcher: building a new one per run() would
        # leak worker threads that keep consuming the host iterator
        if self._dev_iter is not None:
            return self._dev_iter
        dcfg = self.cfg.data
        if dcfg.synthetic and dcfg.device_batches > 0:
            # device-resident rotation: K distinct synthetic batches staged
            # once, zero per-step host-to-device copies (the soak mode)
            staged = []
            it = iter(self._host_iter)
            rows = self._rows()
            for _ in range(dcfg.device_batches):
                b = dict(next(it))
                b.pop("cursor", None)  # meaningless for a cycled staging set
                if rows is not None:
                    b = rows(b)
                staged.append({k: torch.tensor(v, device=self.device)
                               for k, v in b.items()})
            self._dev_iter = itertools.cycle(staged)
            return self._dev_iter
        transfer = dcfg.transfer_dtype if dcfg.transfer_dtype != "float32" else None
        # a shard stream is already this data rank's own
        rows = self._rows(self.loader not in ("native", "python"))
        self._dev_iter = prefetch_to_device(
            self._host_iter, depth=dcfg.prefetch, device=self.device,
            transfer_dtype=transfer, rows=rows,
        )
        return self._dev_iter

    def _maybe_check_errors(self):
        if not self.cfg.check_errors:
            return
        plan = self._state_shardings
        # whole parameters: every rank reaches the same verdict
        params = fetch_global(self.state.params, plan.params if plan else None, self.mesh)
        if not bool(check_state_finite(params)):
            # order after any in-flight periodic write, then dump
            # synchronously — the forensic dump must be on disk before the
            # process dies (check_errors, resnet.cu:2879-2907)
            if self.checkpointer is not None:
                self.checkpointer.wait()
            save_checkpoint(
                self.cfg.checkpoint_dir, NAN_DUMP_ID, self.state, self.cursor,
                **self._ckpt()
            )
            report = nonfinite_report(params)
            raise NonFiniteError(
                "non-finite trainer state; dumped to sentinel "
                f"{NAN_DUMP_ID}:\n" + "\n".join(report)
            )

    def run(self, num_steps: int) -> Dict[str, Any]:
        """Train for num_steps. Returns the last metrics."""
        cfg = self.cfg
        it = self._device_iter()
        pending = None  # (step, metrics) logged one step behind
        last: Dict[str, Any] = {}
        # host-side step mirror: one read of the device step, then counted
        step_before = int(self.state.step)
        for _ in range(num_steps):
            batch = dict(next(it))
            # post-batch stream position of THIS batch; applied to
            # self.cursor only after the step trains on it
            batch_cursor = batch.pop("cursor", None)
            if (
                cfg.checkpoint_every
                and step_before % cfg.checkpoint_every == 0
                and cfg.checkpoint_dir
            ):
                # dump before the update, like update_parameters
                # (resnet.cu:2947-2950); async mode snapshots here and
                # overlaps the file write with the coming steps
                save = (
                    self.checkpointer.save
                    if self.checkpointer is not None
                    else save_checkpoint
                )
                save(
                    cfg.checkpoint_dir, step_before, self.state, self.cursor,
                    metadata={"loss_history": self.logger.loss_history[-100:]},
                    **self._ckpt()
                )
            self.state, metrics = self.train_step(self.state, batch)
            if batch_cursor is not None:
                self.cursor = batch_cursor
            if pending is not None and cfg.record_metrics:
                s, m = pending
                self.logger.log_step(s, {k: float(v) for k, v in m.items()},
                                     epoch=self.cursor.epoch)
            pending = (step_before, metrics)
            step_before += 1
            self._maybe_check_errors()
        if pending is not None:
            s, m = pending
            last = {k: float(v) for k, v in m.items()}
            self.logger.log_step(s, last, epoch=self.cursor.epoch)
        return last

    def run_epochs(self, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.epochs
        if hasattr(self._host_iter, "batches_per_epoch"):
            # ShardIterator and NativeShardIterator both expose this
            steps_per_epoch = self._host_iter.batches_per_epoch
        else:
            steps_per_epoch = max(
                1,
                (self.cfg.data.shard_images * self.cfg.data.num_shards)
                // self.cfg.data.batch_size,
            )
        for e in range(epochs):
            self.run(steps_per_epoch)
            self.logger.epoch_summary(e, steps_per_epoch)
        self.finalize()

    def evaluate(self, data: Iterator, num_batches: int) -> Dict[str, float]:
        """Mean loss, top-1 and top-5 of the eval forward over num_batches
        (``data`` yields this rank's part of each batch, ``rank_batch``;
        across ranks, the means over all ranks' batches, a spatial group's
        ranks holding one batch's replicated metrics)."""
        sums: Dict[str, float] = {}
        it = prefetch_to_device(data, depth=self.cfg.data.prefetch, device=self.device)
        try:
            for _ in range(num_batches):
                batch = next(it)
                batch.pop("cursor", None)
                for k, v in self.eval_step(self.state, batch).items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        finally:
            # without this the prefetcher's thread keeps draining the eval
            # iterator and holding device batches after return
            it.stop()
        n = num_batches
        if self.mesh is not None:
            total = torch.tensor(list(sums.values()), dtype=torch.float64, device=self.device)
            self.mesh.sum_(total)
            sums = dict(zip(sums, total.tolist()))
            n *= self.mesh.size
        return {k: v / n for k, v in sums.items()}

    def evaluate_quantized(self, data: Iterator, num_batches: int,
                           calib_images=None) -> Dict[str, float]:
        """The W8A8 post-training-quantized model (``quantize``) from the
        current state: BN folded, calibrated on ``calib_images`` (ideally
        training batches) or else on the first eval batch, then int8
        inference over ``num_batches`` (on the card, the int8 kernels).
        Returns the same loss, accuracy and top5 means as ``evaluate``.
        NHWC only: quantized inference takes (N, d, d, C) images, as the
        JAX package's does."""
        from ..ops import cross_entropy, top1_accuracy, topk_accuracy
        from ..quantize import forward_sites, prepare_sites, quantize_model

        if self.cfg.execution.layout != "NHWC":
            raise ValueError("quantized inference takes NHWC images; this config's "
                             f"layout is {self.cfg.execution.layout}")
        mcfg, relu_cap = self.cfg.model, self.cfg.execution.relu_cap
        it = prefetch_to_device(data, depth=self.cfg.data.prefetch, device=self.device)
        try:
            first = dict(next(it))
            first.pop("cursor", None)
            calib = calib_images if calib_images is not None else first["images"]
            qparams, scales = quantize_model(self.state.params, self.state.bn_state, mcfg,
                                             calib, relu_cap=relu_cap)
            sites = prepare_sites(qparams, scales, mcfg)
            sums: Dict[str, float] = {}
            batches = itertools.chain([first], it)
            for _ in range(num_batches):
                batch = dict(next(batches))
                images = batch["images"].to(torch.float32)
                labels = batch["labels"]
                logits = forward_sites(sites, images, mcfg, relu_cap=relu_cap)
                m = {"loss": cross_entropy(logits, labels, reduction="mean"),
                     "accuracy": top1_accuracy(logits, labels),
                     "top5": topk_accuracy(logits, labels, 5)}
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
        finally:
            it.stop()
        return {k: v / num_batches for k, v in sums.items()}

    def finalize(self):
        if self._dev_iter is not None:
            if hasattr(self._dev_iter, "stop"):  # cycle() has no worker
                self._dev_iter.stop()
            self._dev_iter = None
        if self.checkpointer is not None:
            self.checkpointer.close()  # drain pending writes (re-raises errors)
        if self.cfg.checkpoint_dir:
            save_checkpoint(
                self.cfg.checkpoint_dir, FINAL_DUMP_ID, self.state, self.cursor,
                **self._ckpt()
            )
        self.logger.close()

    def __del__(self):
        try:
            if getattr(self, "_dev_iter", None) is not None and hasattr(
                    self._dev_iter, "stop"):
                self._dev_iter.stop()
        except Exception:
            pass
        try:
            # best-effort drain; ThreadPoolExecutor threads are also joined
            # at interpreter exit, so in-flight dumps land either way
            if getattr(self, "checkpointer", None) is not None:
                self.checkpointer.close()
        except Exception:
            pass


def rank_cursor(cursor: ShardCursor, rank: int, ranks: int, num_shards: int,
                batches_per_shard: int) -> ShardCursor:
    """The position of rank ``rank``'s stream when rank 0's is at
    ``cursor``: every rank starts ``num_shards // ranks`` shards after the
    one before and reads as many batches a step, so its stream runs that
    many shards ahead, epochs counted from its own start."""
    bps, n = batches_per_shard, num_shards
    at = ((cursor.epoch * n + cursor.shard) * bps + cursor.batch_in_shard
          + rank * (n // ranks) * bps)
    shard, batch = divmod(at, bps)
    return ShardCursor(shard=shard % n, batch_in_shard=batch, epoch=shard // n)
