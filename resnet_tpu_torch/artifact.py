"""The serving artifact's loader: runs a model that ``export.save_inference``
wrote, with no model code.

The counterpart of resnet_tpu.export's ``load_inference``: JAX's artifact is
a ``jax.export`` program over a symbolic batch, and so is this one, a
``torch.export`` program saved with ``torch.export.save``. The file holds
the program (the served forward, its hand kernels as the custom ops of
``kernels.ops``), its weights, and a JSON record of what was exported
(``meta.json``: the kind, 'fp' or 'int8', the model and execution configs
as plain dicts, the image shape, the batch, the device and the
``matmul_precision``). This module imports ``torch``, ``numpy`` and
``resnet_tpu_torch.kernels``, which registers the ops' CPU and CUDA
implementations, and nothing of the model code: a server that loads an
artifact runs it without ``models``, ``quantize``, ``train`` or the configs.

``load_inference(path_or_bytes, device="cuda")`` returns a ``Served``:
``.call(images)`` checks the images' shape and runs the program under
``torch.inference_mode()`` (a ValueError for another image shape, or for
another batch where the export pinned one); ``.image_dims``, ``.device``,
``.kind`` and ``.meta`` describe it. An artifact runs on the device it was exported on
and nowhere else: asked for another, the loader raises ``ValueError``
(export it again there). TF32: an exported graph does not record cuDNN's
and cuBLAS's TF32 flags, which are process-wide, so each call sets both
from the export's ``matmul_precision`` ('highest' off, else on) and puts
the caller's values back after, as ``ops.precision.precision_scope`` does
around the eager forward.
"""

from __future__ import annotations

import contextlib
import io
import json
from typing import Any, Dict, Iterator

import numpy as np
import torch

from . import kernels  # noqa: F401  (registers the resnet_tpu_torch custom ops)

META = "meta.json"
FORMAT = "resnet_tpu_torch.artifact/1"


@contextlib.contextmanager
def tf32_scope(allow: bool) -> Iterator[None]:
    """Both TF32 flags set to ``allow`` inside, the caller's values after
    (the lines of ``ops.precision.precision_scope``)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def check_images(images, dims, batch=None) -> None:
    """ValueError unless ``images`` is (N, *dims), N = ``batch`` where one
    is pinned."""
    if (tuple(images.shape[1:]) != tuple(dims) or len(images.shape) != 4
            or batch not in (None, images.shape[0])):
        n = "N" if batch is None else str(batch)
        raise ValueError(f"expected images of shape ({n}, {', '.join(map(str, dims))}), got "
                         f"{tuple(images.shape)}")


def as_input(images, device) -> torch.Tensor:
    """fp32 contiguous images on ``device`` from a numpy array or a tensor."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.array(images, dtype=np.float32))
    return images.to(device=device, dtype=torch.float32).contiguous()


def indexed(device) -> torch.device:
    """``device`` with its index: a bare 'cuda' is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Served:
    """A loaded artifact: ``call`` maps fp32 images (N, *image_dims) to fp32
    logits (N, classes) on ``device``."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict[str, Any],
                 device: torch.device):
        self.program, self.meta, self.device = program, meta, device
        self.kind = meta["kind"]
        self.image_dims = tuple(meta["image_dims"])
        self._module = program.module()
        self._tf32 = meta["matmul_precision"] != "highest"

    def call(self, images) -> torch.Tensor:
        """Logits for a numpy array or tensor of images, on the artifact's
        device. Raises ValueError on a shape the program does not take."""
        check_images(images, self.image_dims, self.meta["batch"])
        x = as_input(images, self.device)
        with torch.inference_mode(), tf32_scope(self._tf32):
            return self._module(x)


def load_inference(path_or_bytes, device="cuda") -> Served:
    """Restore an artifact from a path or its bytes, to run on ``device``
    (the card unless the caller asks for the CPU). Raises ValueError when
    ``device`` is not the one it was exported on."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    extra = {META: ""}
    program = torch.export.load(io.BytesIO(data), extra_files=extra)
    meta = json.loads(extra[META])
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact (format {meta.get('format')!r})")
    have, want = torch.device(meta["device"]), torch.device(device)
    if want.type != have.type or (want.type == "cuda" and indexed(want) != have):
        raise ValueError(f"the artifact was exported on {have} and runs only there; "
                         f"export it again on {want}")
    return Served(program, meta, have)
