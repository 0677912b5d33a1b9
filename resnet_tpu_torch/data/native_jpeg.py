"""ctypes binding for the native JPEG decoder (csrc/jpeg_decode.cc): the
port of resnet_tpu.data.native_jpeg, which builds the library at first use.

Same augmentation semantics as the PIL path (_jpeg_worker.py): the
random-resized-crop / center-crop BOX is computed here in Python with
the same RNG protocol, and the native side does header parse ->
DCT-scaled decode -> crop -> bilinear resample -> optional flip,
returning the uint8 RGB crop. libjpeg's scale_num/8 decode means large
sources pay only the IDCT work the crop actually needs — the lever that
moves the 24k img/s input budget from ~100 PIL workers toward a
realistic core count (docs/inputtable_r3.json weak spot).

Falls back cleanly: available() is False when the library cannot be
built (make -C csrc build/libresnet_jpeg.so needs libjpeg's headers), and
non-JPEG bytes (PNG in the tree) raise for the caller to fall back to PIL.
"""

from __future__ import annotations

import ctypes
import random
from typing import Optional

import numpy as np

from .native import build_native

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build_native("libresnet_jpeg.so")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.rtpu_jpeg_dims.restype = ctypes.c_int
    lib.rtpu_jpeg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rtpu_decode_crop.restype = ctypes.c_int
    lib.rtpu_decode_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_ulong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[:3] == b"\xff\xd8\xff"


def _rrc_box(w, h, rng, out_dim, train):
    """Crop box with the SAME protocol as _jpeg_worker.decode_and_augment
    (RNG draw order preserved so seeds line up across paths)."""
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
                return x0, y0, cw, ch
        s = min(w, h)
        return (w - s) // 2, (h - s) // 2, s, s
    # eval: resize-short-256 + center-crop == center box of
    # out_dim*min(w,h)/256 in source coords; clamp to the image so
    # out_dim > 256 (box would exceed min(w,h), negative origin) keeps
    # the native path instead of tripping libjpeg's crop bounds check
    s = min(w, h)
    c = min(int(round(out_dim * s / 256.0)), s)
    return (w - c) // 2, (h - c) // 2, c, c


def decode_and_augment_native(
    path: str,
    *,
    out_dim: int = 224,
    train: bool = True,
    rng: Optional[random.Random] = None,
    flip: bool = True,
) -> np.ndarray:
    """Native analogue of _jpeg_worker.decode_and_augment(dtype=uint8).

    Raises ValueError for non-JPEG or corrupt inputs (caller falls back
    to the PIL path)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libresnet_jpeg.so not built (make -C csrc build/libresnet_jpeg.so)")
    rng = rng or random
    with open(path, "rb") as f:
        data = f.read()
    if not _is_jpeg(data):
        raise ValueError(f"not a JPEG: {path}")
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.rtpu_jpeg_dims(data, len(data), ctypes.byref(w),
                          ctypes.byref(h)):
        raise ValueError(f"JPEG header parse failed: {path}")
    x0, y0, cw, ch = _rrc_box(w.value, h.value, rng, out_dim, train)
    do_flip = 1 if (train and flip and rng.random() < 0.5) else 0
    out = np.empty((out_dim, out_dim, 3), np.uint8)
    rc = lib.rtpu_decode_crop(
        data, len(data), out_dim, x0, y0, cw, ch, do_flip,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc:
        raise ValueError(f"JPEG decode failed: {path}")
    return out
