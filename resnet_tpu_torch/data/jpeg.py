"""Host-side JPEG decode / augment pipeline: a copy of resnet_tpu.data.jpeg.

The reference does all decode/crop work offline (organize_input.ipynb +
build_training_shards.c) and trains from pre-cropped float shards with no
train-time augmentation beyond the baked random crop. The BASELINE north
star (SURVEY.md section 7) additionally mandates an online host-side
JPEG pipeline: decode -> random-resized-crop -> random horizontal flip ->
BGR-free RGB -> per-channel mean subtraction, feeding the same batch dict
the shard loaders produce. Standard ImageNet recipe (Goyal et al. 2017)
augmentation, required to reach 76% top-1.

Decoding uses PIL on a true multiprocess pool (spawn context — decode is
GIL-bound work, threads do not scale it): workers ship uint8 crops back
(4x less IPC than float32) and the parent does the mean-subtract
vectorized. A thread pool remains available (``use_processes=False``) for
tests and small runs where process startup dominates. For the 24k img/s
8-chip target the shard path (pre-decoded floats, zero host decode cost)
remains the fast path; this pipeline is for training straight from a raw
ImageNet directory tree.
"""

from __future__ import annotations

import os
import random
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ._jpeg_worker import (  # noqa: F401  (re-exported API)
    IMAGENET_MEANS,
    _decode_worker,
    decode_and_augment,
)


def list_imagefolder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Scan an ImageNet-style tree root/<synset>/<img>.JPEG.

    Returns (paths, labels, class_names) with classes sorted by synset."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    paths, labels = [], []
    for i, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith((".jpeg", ".jpg", ".png")):
                paths.append(os.path.join(cdir, f))
                labels.append(i)
    return paths, labels, classes


class JpegDataset:
    """Batch iterator over an ImageFolder tree with multiprocess decoding."""

    def __init__(
        self,
        root: str,
        batch_size: int,
        *,
        out_dim: int = 224,
        train: bool = True,
        layout: str = "NHWC",
        seed: int = 1234,
        num_workers: int = 0,
        use_processes: bool = True,
        drop_remainder: bool = True,
    ):
        self.paths, self.labels, self.classes = list_imagefolder(root)
        if not self.paths:
            raise ValueError(f"no images under {root}")
        self.batch_size = batch_size
        self.out_dim = out_dim
        self.train = train
        self.layout = layout
        self.rng = random.Random(seed)
        self.epoch = 0
        self._order = list(range(len(self.paths)))
        if train:
            self.rng.shuffle(self._order)
        self._pos = 0
        workers = num_workers or min(32, (os.cpu_count() or 8))
        if use_processes:
            # spawn, not fork: the parent holds a live torch (and CUDA)
            # runtime whose internal threads make fork() unsafe. Per-task dependencies
            # are PIL/numpy only (the task fn lives in the leaf module
            # _jpeg_worker), but spawn semantics re-execute the parent's
            # __main__ module in each worker at startup — so workers pay a
            # one-time import of whatever the driving script imports
            # (usually torch), exactly like a torch DataLoader. Startup cost,
            # not per-task cost; amortized over the epoch.
            import multiprocessing as mp

            self._pool = ProcessPoolExecutor(
                max_workers=workers, mp_context=mp.get_context("spawn")
            )
            self._chunk = max(1, batch_size // (4 * workers))
        else:
            self._pool = ThreadPoolExecutor(max_workers=workers)
            self._chunk = 1

    @property
    def batches_per_epoch(self) -> int:
        return len(self.paths) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_size
        if self._pos + b > len(self._order):
            self._pos = 0
            self.epoch += 1
            if self.train:
                self.rng.shuffle(self._order)
        idx = self._order[self._pos : self._pos + b]
        self._pos += b
        tasks = [
            (self.paths[i], self.out_dim, self.train, self.rng.getrandbits(32))
            for i in idx
        ]
        crops = list(self._pool.map(_decode_worker, tasks, chunksize=self._chunk))
        # mean-subtract vectorized on the full batch (workers shipped uint8)
        images = np.stack(crops).astype(np.float32) - np.asarray(
            IMAGENET_MEANS, np.float32
        )
        if self.layout == "NCHW":
            images = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        labels = np.asarray([self.labels[i] for i in idx], np.int32)
        return {"images": images, "labels": labels}

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
