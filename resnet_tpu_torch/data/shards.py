"""Binary shard reader/writer — the reference's on-disk training format. A
copy of resnet_tpu.data.shards (numpy only): one shard directory gives both
packages the same batches and the same cursors.

Format (build_training_shards.c:148-160): per shard ``%03d.images`` is a raw
float32 blob of shard_n_images x image and ``%03d.labels`` is raw int32.
Images are 224x224x3, already crop-augmented, BGR->RGB swapped, and
per-channel mean-subtracted offline (build_training_shards.c:115-131).
Layout on disk is NCHW as build_training_shards.c writes it (:133-147); the naive trainers
read an NHWC variant and the fast trainer reads ``nchw/`` shards
(resnet_cudnn_fast.cu:975-981) — both layouts are supported here.

Unlike the reference's load_new_batch (resnet.cu:1235-1325), which freads an
entire multi-GB shard into RAM synchronously on the training thread, shards
here are memory-mapped and batches sliced lazily, with the host-to-device
copy overlapped by prefetch.DevicePrefetcher (the reference's own comment at
resnet.cu:1233 concedes the synchronous load should have been overlapped).

The shard cursor (shard index, batch-within-shard, global step) reproduces
the reference's resume bookkeeping (cur_shard/cur_batch_in_shard/
cur_dump_id, resnet.cu:1266-1323) so checkpoints restore mid-epoch position
exactly (overwrite_trainer_hyperparams, resnet.cu:2796-2813).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class ShardCursor:
    """Input-stream position; serialized into every checkpoint."""

    shard: int = 0
    batch_in_shard: int = 0
    epoch: int = 0


@dataclass
class ShardDataset:
    """A directory of %03d.images / %03d.labels shards."""

    directory: str
    num_shards: int = 40
    shard_images: int = 32768  # SHARD_N_IMAGES (resnet.cu:3277)
    image_dim: int = 224
    channels: int = 3
    disk_layout: str = "NCHW"  # build_training_shards.c writes NCHW

    def image_path(self, shard: int) -> str:
        return os.path.join(self.directory, f"{shard:03d}.images")

    def label_path(self, shard: int) -> str:
        return os.path.join(self.directory, f"{shard:03d}.labels")

    @property
    def image_size(self) -> int:
        return self.image_dim * self.image_dim * self.channels

    def shard_shape(self) -> Tuple[int, ...]:
        d, c = self.image_dim, self.channels
        if self.disk_layout == "NCHW":
            return (self.shard_images, c, d, d)
        return (self.shard_images, d, d, c)

    def open_shard(self, shard: int) -> Tuple[np.ndarray, np.ndarray]:
        """Memory-map one shard; returns (images, labels) views."""
        n_avail = os.path.getsize(self.image_path(shard)) // (4 * self.image_size)
        n = min(self.shard_images, n_avail)
        shape = (n,) + self.shard_shape()[1:]
        images = np.memmap(self.image_path(shard), dtype=np.float32, mode="r", shape=shape)
        labels = np.fromfile(self.label_path(shard), dtype=np.int32, count=n)
        return images, labels


class ShardIterator:
    """Batch iterator with reference cursor semantics.

    Yields dicts {'images': (B, ...) float32 in ``layout``, 'labels': (B,)
    int32}. Advances shard->shard like load_new_batch: when a shard is
    exhausted the next is opened (wrapping to shard 0 increments the epoch).
    """

    def __init__(
        self,
        dataset: ShardDataset,
        batch_size: int,
        *,
        layout: str = "NHWC",
        cursor: Optional[ShardCursor] = None,
        random_flip: bool = False,
        seed: int = 1234,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.layout = layout
        self.cursor = cursor or ShardCursor()
        # train-time horizontal flip (new capability: the reference bakes a
        # random crop offline and has no online augmentation)
        self.random_flip = random_flip
        self._rng = np.random.default_rng(seed)
        self._images: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None
        self._open = -1

    @property
    def batches_per_shard(self) -> int:
        return self.dataset.shard_images // self.batch_size

    @property
    def batches_per_epoch(self) -> int:
        return self.batches_per_shard * self.dataset.num_shards

    def _ensure_shard(self):
        if self._open != self.cursor.shard:
            self._images, self._labels = self.dataset.open_shard(self.cursor.shard)
            self._open = self.cursor.shard

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        self._ensure_shard()
        b = self.batch_size
        start = self.cursor.batch_in_shard * b
        if start + b > len(self._labels):
            # shard exhausted -> advance (resnet.cu:1266-1274)
            self.cursor.batch_in_shard = 0
            self.cursor.shard += 1
            if self.cursor.shard >= self.dataset.num_shards:
                self.cursor.shard = 0
                self.cursor.epoch += 1
            self._ensure_shard()
            start = 0
        images = np.asarray(self._images[start : start + b], dtype=np.float32)
        labels = np.asarray(self._labels[start : start + b], dtype=np.int32)
        if self.layout != self.dataset.disk_layout:
            perm = (0, 2, 3, 1) if self.layout == "NHWC" else (0, 3, 1, 2)
            images = np.ascontiguousarray(images.transpose(perm))
        if self.random_flip:
            if not images.flags.writeable:  # still a read-only memmap view
                images = images.copy()
            w_axis = 2 if self.layout == "NHWC" else 3
            mask = self._rng.random(len(images)) < 0.5
            images[mask] = np.flip(images[mask], axis=w_axis)
        self.cursor.batch_in_shard += 1
        # each batch carries its own post-batch cursor so a checkpoint can
        # record the position of the last *trained* batch rather than the
        # (prefetch-skewed) live cursor; resuming from it yields the next
        # unseen batch (cur_shard/cur_batch_in_shard, resnet.cu:1266-1323)
        return {"images": images, "labels": labels, "cursor": replace(self.cursor)}


def write_shard(
    directory: str,
    shard: int,
    images: np.ndarray,
    labels: np.ndarray,
    *,
    layout: str = "NCHW",
):
    """Write one shard in the reference binary format (test fixtures and the
    shard-building pipeline; build_training_shards.c:148-160)."""
    os.makedirs(directory, exist_ok=True)
    images = np.ascontiguousarray(images, dtype=np.float32)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    images.tofile(os.path.join(directory, f"{shard:03d}.images"))
    labels.tofile(os.path.join(directory, f"{shard:03d}.labels"))
