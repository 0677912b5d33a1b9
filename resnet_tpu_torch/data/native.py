"""ctypes binding to the native C++ shard loader (csrc/shard_loader.cc): the
port of resnet_tpu.data.native.

The native loader runs disk reads + layout repack on background threads
with a bounded read-ahead ring, replacing the reference's synchronous
whole-shard fread (load_new_batch, resnet.cu:1235-1325).

The library lives in the repo-root ``csrc/build/`` that both packages
share. It is built at first use with the one make target it needs
(``make -C csrc build/libshard_loader.so``): ``make -C csrc`` alone would
also link the JPEG decoder against libjpeg, and on a machine without its
headers that one failure would leave the shard loader unbuilt too.
``native_available()`` says whether the library loaded; ``native_status()``
says why not. The Trainer falls back to the Python ``ShardIterator`` and
logs which loader runs.

The two loaders report different (equivalent) cursors at a shard's end:
this one reports the position already wrapped to the next shard,
``ShardIterator`` the position past the shard's last batch. Both resume to
the same next batch; each is kept as the JAX package writes it, so dumps
are equal byte for byte under the same loader.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Dict, Iterator, Optional

import numpy as np

from .shards import ShardCursor, ShardDataset

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
_LIB_PATH = os.path.join(CSRC, "build", "libshard_loader.so")
_lib = None
_status = "not loaded yet"


def build_native(name: str) -> Optional[str]:
    """Path of ``csrc/build/<name>``, built with its own make target when it
    is missing; None (and the reason in ``native_status()``) when it cannot
    be built. Builds are serialized across processes by a lock file, so a
    process never loads a library another one is still writing."""
    global _status
    path = os.path.join(CSRC, "build", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(os.path.join(CSRC, "build", ".build-lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            try:
                subprocess.run(["make", "-C", CSRC, f"build/{name}"], check=True,
                               capture_output=True, text=True, timeout=300)
            except subprocess.CalledProcessError as e:
                _status = f"make build/{name} failed: {e.stderr.strip()[-400:]}"
                return None
            except (FileNotFoundError, subprocess.TimeoutExpired) as e:
                _status = f"make build/{name} did not run: {e}"
                return None
    return path


def _load_lib():
    global _lib, _status
    if _lib is not None:
        return _lib
    if build_native("libshard_loader.so") is None:
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.loader_error.restype = ctypes.c_char_p
    lib.loader_error.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    _status = f"loaded {os.path.relpath(_LIB_PATH, os.path.dirname(CSRC))}"
    return lib


def native_available() -> bool:
    """True when the shard loader's library is built (or builds) and loads."""
    return _load_lib() is not None


def native_status() -> str:
    """What the last attempt to build or load a native library found."""
    return _status


class NativeShardIterator:
    """Drop-in replacement for ShardIterator backed by the C++ loader."""

    def __init__(
        self,
        dataset: ShardDataset,
        batch_size: int,
        *,
        layout: str = "NHWC",
        cursor: Optional[ShardCursor] = None,
        prefetch_depth: int = 4,
        num_workers: int = 0,  # 0 = auto (2 if >=2 cores else 1, capped at depth — shard_loader.cc's measured default)
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable ({_status}); use ShardIterator")
        self.dataset = dataset
        self.batch_size = batch_size
        self.layout = layout
        self.cursor = cursor or ShardCursor()
        self._lib = lib
        self._handle = lib.loader_create(
            dataset.directory.encode(),
            dataset.num_shards,
            dataset.shard_images,
            dataset.image_dim,
            dataset.channels,
            batch_size,
            1 if dataset.disk_layout == "NCHW" else 0,
            1 if layout == "NHWC" else 0,
            prefetch_depth,
            self.cursor.shard,
            self.cursor.batch_in_shard,
            self.cursor.epoch,
            num_workers,
        )
        d, c = dataset.image_dim, dataset.channels
        self._img_shape = (
            (batch_size, d, d, c) if layout == "NHWC" else (batch_size, c, d, d)
        )

    @property
    def batches_per_shard(self) -> int:
        return self.dataset.shard_images // self.batch_size

    @property
    def batches_per_epoch(self) -> int:
        return self.batches_per_shard * self.dataset.num_shards

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        images = np.empty(self._img_shape, np.float32)
        labels = np.empty((self.batch_size,), np.int32)
        cur = (ctypes.c_int64 * 3)()
        rc = self._lib.loader_next(
            self._handle,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cur,
        )
        if rc != 0:
            err = self._lib.loader_error(self._handle).decode()
            raise RuntimeError(f"native shard loader: {err}")
        self.cursor.shard = int(cur[0])
        self.cursor.batch_in_shard = int(cur[1])
        self.cursor.epoch = int(cur[2])
        # post-batch cursor rides with the batch (see ShardIterator.__next__)
        return {
            "images": images,
            "labels": labels,
            "cursor": ShardCursor(int(cur[0]), int(cur[1]), int(cur[2])),
        }

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
