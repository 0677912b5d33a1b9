"""Serving export: freeze the eval forward over trained weights.

The counterpart of resnet_tpu.export: ``export_inference`` closes the eval
forward (running-stats BN) over (params, bn_state) and returns an
``nn.Module`` whose weights are buffers on one device and whose ``.call``
maps NHWC fp32 images (any batch size) to fp32 logits.
``save_inference`` / ``load_inference`` write and read one file holding the
model and execution configs and the tensors.

Unlike the JAX package's StableHLO artifact, the file holds no program: the
loader needs this package's model code. A self-contained artifact
(``torch.export``) is later work (ROADMAP.md queue A, item A9).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from .bridge import flatten, unflatten
from .config import ExecutionConfig, ModelConfig
from .models import forward
from .ops.precision import precision_scope


def _buffer_name(path: str) -> str:
    return path.replace("/", "__")  # buffer names may not hold '.'


class InferenceModel(nn.Module):
    """Frozen eval forward: images (N, d, d, C) -> fp32 logits (N, classes)."""

    def __init__(self, params, bn_state, mcfg: ModelConfig, ecfg: ExecutionConfig):
        super().__init__()
        self.mcfg, self.ecfg = mcfg, ecfg
        self._trees = {"params": [], "bn_state": []}
        for tree_name, tree in (("params", params), ("bn_state", bn_state)):
            for path, t in flatten(tree) if tree is not None else []:
                name = _buffer_name(f"{tree_name}/{path}")
                self.register_buffer(name, t.detach().clone())
                self._trees[tree_name].append((path, name))

    def _tree(self, tree_name):
        pairs = self._trees[tree_name]
        if not pairs:
            return None
        return unflatten((path, getattr(self, name)) for path, name in pairs)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        logits, _ = forward(self._tree("params"), images, self.mcfg, self.ecfg,
                            train=False, bn_state=self._tree("bn_state"))
        return logits

    def call(self, images) -> torch.Tensor:
        """Logits for a numpy array or tensor of images, on the model's
        device, at the config's ``matmul_precision``. Raises ValueError on
        a shape the model does not take."""
        d, c = self.mcfg.input_dim, self.mcfg.in_channels
        if tuple(images.shape[1:]) != (d, d, c) or len(images.shape) != 4:
            raise ValueError(
                f"expected images of shape (N, {d}, {d}, {c}), got "
                f"{tuple(images.shape)}"
            )
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.array(images, dtype=np.float32))
        x = images.to(device=self.device, dtype=torch.float32).contiguous()
        with torch.inference_mode(), precision_scope(self.ecfg):
            return self(x)


def export_inference(
    params,
    mcfg: ModelConfig,
    *,
    bn_state=None,
    ecfg: Optional[ExecutionConfig] = None,
    device=None,
) -> InferenceModel:
    """Freeze (params, bn_state) into an ``InferenceModel`` on ``device``
    (default: the device the parameters are on)."""
    model = InferenceModel(params, bn_state, mcfg, ecfg or ExecutionConfig())
    return model.to(device) if device is not None else model


def save_inference(path: str, model: InferenceModel) -> str:
    blob = {
        "model_config": dataclasses.asdict(model.mcfg),
        "execution_config": dataclasses.asdict(model.ecfg),
        "params": {p: getattr(model, n).cpu() for p, n in model._trees["params"]},
        "bn_state": {p: getattr(model, n).cpu() for p, n in model._trees["bn_state"]},
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_inference(path: str, device="cuda") -> InferenceModel:
    """Restore a saved model on ``device`` (the card unless the caller asks
    for the CPU); run it with ``.call(images)``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    mcfg = blob["model_config"]
    mcfg = ModelConfig(**{**mcfg, "block_sizes": tuple(mcfg["block_sizes"])})
    ecfg = ExecutionConfig(**blob["execution_config"])
    params = unflatten(blob["params"].items())
    bn_state = unflatten(blob["bn_state"].items()) if blob["bn_state"] else None
    return export_inference(params, mcfg, bn_state=bn_state, ecfg=ecfg,
                            device=device)
