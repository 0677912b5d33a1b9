"""Synthetic data source for benchmarks and tests (no reference equivalent;
the reference always trains from real shards). Produces batches with the
same statistics as mean-subtracted ImageNet pixels. A copy of
resnet_tpu.data.synthetic (numpy only): one seed gives both packages the
same batches."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticDataset:
    def __init__(
        self,
        batch_size: int,
        *,
        image_dim: int = 224,
        channels: int = 3,
        num_classes: int = 1000,
        layout: str = "NHWC",
        seed: int = 1234,
        distinct_batches: int = 8,
    ):
        rng = np.random.default_rng(seed)
        shape = (
            (distinct_batches, batch_size, image_dim, image_dim, channels)
            if layout == "NHWC"
            else (distinct_batches, batch_size, channels, image_dim, image_dim)
        )
        # mean-subtracted pixel scale (~ +-128 after build_training_shards.c
        # normalization), scaled down to keep activations tame
        self._images = rng.normal(0.0, 50.0, size=shape).astype(np.float32)
        self._labels = rng.integers(
            0, num_classes, size=(distinct_batches, batch_size)
        ).astype(np.int32)
        self._i = 0
        self._n = distinct_batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        i = self._i % self._n
        self._i += 1
        return {"images": self._images[i], "labels": self._labels[i]}
