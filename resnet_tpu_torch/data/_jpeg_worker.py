"""Leaf decode module for the multiprocess JPEG pool: a copy of
resnet_tpu.data._jpeg_worker (PIL and numpy; the native fast path is this
package's own binding, native_jpeg).

Holds the per-task decode path with only PIL/numpy dependencies. The pool
worker unpickles its task function from here, so the task-time import
surface stays light; note that spawn-context workers additionally
re-execute the parent's __main__ module once at startup (standard
multiprocessing semantics — see data/jpeg.py).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

IMAGENET_MEANS = (123.68, 116.78, 103.94)  # RGB (build_training_shards.c:115)


def decode_and_augment(
    path: str,
    *,
    out_dim: int = 224,
    train: bool = True,
    rng: Optional[random.Random] = None,
    flip: bool = True,
    subtract_means: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """One image -> (out_dim, out_dim, 3) NHWC (float32, or uint8 when
    subtract_means=False and dtype=np.uint8 — the IPC-lean worker form).

    Train: random-resized-crop (scale 0.08-1.0, ratio 3/4-4/3) + optional
    horizontal flip. Eval: resize-short-side-256 + center crop.
    """
    from PIL import Image

    rng = rng or random
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if train:
            area = w * h
            for _ in range(10):
                target = rng.uniform(0.08, 1.0) * area
                ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(target * ratio)))
                ch = int(round(np.sqrt(target / ratio)))
                if cw <= w and ch <= h:
                    x0 = rng.randint(0, w - cw)
                    y0 = rng.randint(0, h - ch)
                    im = im.resize(
                        (out_dim, out_dim), Image.BILINEAR,
                        box=(x0, y0, x0 + cw, y0 + ch),
                    )
                    break
            else:  # fallback: center crop
                s = min(w, h)
                x0, y0 = (w - s) // 2, (h - s) // 2
                im = im.resize((out_dim, out_dim), Image.BILINEAR,
                               box=(x0, y0, x0 + s, y0 + s))
            if flip and rng.random() < 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            scale = 256 / min(w, h)
            im = im.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
            w2, h2 = im.size
            x0, y0 = (w2 - out_dim) // 2, (h2 - out_dim) // 2
            im = im.crop((x0, y0, x0 + out_dim, y0 + out_dim))
        arr = np.asarray(im, dtype=dtype)
    if subtract_means:
        arr = arr.astype(np.float32) - np.asarray(IMAGENET_MEANS, np.float32)
    return arr


def _decode_worker(task) -> np.ndarray:
    """Pool worker: decode one image to a uint8 crop (mean-subtract happens
    vectorized in the parent — uint8 is 4x less pipe traffic).

    Fast path: the native libjpeg decoder (csrc/jpeg_decode.cc, DCT-scaled
    decode sized to the crop); PIL fallback for PNGs, corrupt files, or an
    unbuilt library. Both paths draw the crop box with the same RNG
    protocol, so the augmentation distribution is identical."""
    path, out_dim, train, seed = task
    import os as _os

    try:
        from .native_jpeg import available, decode_and_augment_native

        if available() and _os.environ.get("RESNET_TPU_JPEG_PIL") != "1":
            return decode_and_augment_native(
                path, out_dim=out_dim, train=train, rng=random.Random(seed),
            )
    except (ValueError, OSError):
        pass  # non-JPEG or decode failure: PIL handles it below
    return decode_and_augment(
        path, out_dim=out_dim, train=train, rng=random.Random(seed),
        subtract_means=False, dtype=np.uint8,
    )
