"""Structured procedural classification dataset: a copy of
resnet_tpu.data.procedural (numpy only; one seed, the same stream).

ImageNet is not available on the build box, so the convergence-at-scale
proxy needs a dataset that is (a) generated deterministically on the fly,
(b) hard enough that a ResNet takes thousands of steps — exercising the
LR schedule / warmup / weight-decay-mask / smoothing / BN-running-stats
machinery in the regime where step-5k bugs live, and (c) cleanly split
into train and held-out eval instances.

Each class c is a parametric texture+shape recipe:
  - two sinusoidal gratings with class-specific frequencies and phases,
  - a class-specific shape mask (disk / square / diagonal stripes) with
    class-specific size and position,
  - a class-specific 3x3 color mixing matrix.
Each INSTANCE perturbs the prototype with a random cyclic translation,
horizontal flip, amplitude jitter, and additive Gaussian noise at
sigma comparable to the signal — so memorizing single images doesn't
work and eval (disjoint instance stream) measures real generalization.

Pixel scale matches mean-subtracted ImageNet shards (~[-120, 120],
build_training_shards.c:115-131) so the same model/recipe constants
apply unchanged.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class ProceduralDataset:
    """Deterministic per-class prototypes + per-instance augmentation."""

    def __init__(self, num_classes: int = 100, image_dim: int = 64,
                 seed: int = 1234, noise: float = 35.0):
        self.num_classes = num_classes
        self.image_dim = image_dim
        self.noise = noise
        rng = np.random.default_rng(seed)
        d = image_dim
        yy, xx = np.meshgrid(np.arange(d), np.arange(d), indexing="ij")
        protos = np.empty((num_classes, d, d, 3), np.float32)
        for c in range(num_classes):
            fx, fy = rng.uniform(0.15, 1.2, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            gx = 40.0 * np.sin(fx * xx + px)
            gy = 40.0 * np.sin(fy * yy + py)
            kind = c % 3
            cy, cx = rng.uniform(0.25, 0.75, 2) * d
            r = rng.uniform(0.12, 0.3) * d
            if kind == 0:  # disk
                mask = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            elif kind == 1:  # square
                mask = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
            else:  # diagonal stripes through the patch
                mask = (((xx + yy) // max(2, int(r / 2))) % 2 == 0) & (
                    ((yy - cy) ** 2 + (xx - cx) ** 2) < (1.8 * r) ** 2
                )
            # three channel COMPONENTS (x-grating, y-grating, shape) mixed
            # by the class's 3x3 matrix — each output channel is a genuine
            # linear combination of the structural components, so color is
            # itself a class cue. (Columns are abs-normalized: amplitude
            # stays at component scale regardless of the draw.)
            comp = np.stack(
                [gx, gy, 65.0 * mask.astype(np.float32)], axis=-1
            ).astype(np.float32)
            mix = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
            mix /= np.abs(mix).sum(axis=0, keepdims=True)
            protos[c] = np.einsum("hwc,cb->hwb", comp, mix)
        self.protos = protos

    def batch(self, labels: np.ndarray, instance_rng: np.random.Generator):
        """Materialize one augmented batch for the given labels."""
        n = len(labels)
        d = self.image_dim
        # cyclic translation + optional h-flip as ONE gather:
        # imgs[i,y,x] = proto[label_i, (y+shy_i)%d, (±x+shx_i)%d]
        sh = instance_rng.integers(0, d, (n, 2))
        flip = instance_rng.random(n) < 0.5
        ar = np.arange(d)
        ry = (ar[None, :] + sh[:, :1]) % d                    # (n, d)
        base_x = np.where(flip[:, None], d - 1 - ar[None, :], ar[None, :])
        rx = (base_x + sh[:, 1:]) % d                         # (n, d)
        imgs = self.protos[
            labels[:, None, None], ry[:, :, None], rx[:, None, :]
        ]                                                     # (n, d, d, 3)
        # amplitude jitter + noise (float32 throughout)
        amp = instance_rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(np.float32)
        noise = instance_rng.standard_normal(imgs.shape, dtype=np.float32)
        return imgs * amp + self.noise * noise


class ProceduralIterator:
    """Infinite {'images','labels'} NHWC batch stream.

    Stream derivation uses np.random.SeedSequence: the user seed spawns
    two children — child 0 is the train stream, child 1 the eval stream —
    so disjointness is a SeedSequence guarantee, not an ad-hoc arithmetic
    offset with collidable ranges. Each BATCH gets its own child keyed by
    its index, which makes the stream positional: `start_batch=k` (or
    `skip(k)`) resumes exactly after batch k-1 in O(1), without replaying
    k batches of rng draws — a resumed training run continues on fresh
    instances instead of replaying the stream from position 0."""

    def __init__(self, dataset: ProceduralDataset, batch_size: int,
                 *, seed: int = 0, evaluation: bool = False,
                 start_batch: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self._stream = np.random.SeedSequence(seed).spawn(2)[
            1 if evaluation else 0
        ]
        self._i = start_batch

    def skip(self, n_batches: int) -> None:
        """Fast-forward past n_batches (O(1): batches are index-keyed)."""
        self._i += n_batches

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        rng = np.random.default_rng(np.random.SeedSequence(
            entropy=self._stream.entropy,
            spawn_key=self._stream.spawn_key + (self._i,),
        ))
        self._i += 1
        labels = rng.integers(
            0, self.ds.num_classes, self.batch_size
        ).astype(np.int32)
        images = self.ds.batch(labels, rng)
        return {"images": images, "labels": labels}
