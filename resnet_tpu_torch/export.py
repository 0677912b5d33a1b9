"""Serving export: freeze the eval forward over trained weights.

The counterpart of resnet_tpu.export: ``export_inference`` closes the eval
forward (running-stats BN) over (params, bn_state) and returns an
``nn.Module`` whose weights are buffers on one device and whose ``.call``
maps fp32 images (any batch size; NHWC, or NCHW under the execution
config's ``layout``, as JAX's export.py:69-70) to fp32 logits.
``weights_dtype`` casts the parameters and the BN running statistics
(export.py:57-61 there), e.g. to bfloat16.
``export_quantized_inference`` is the W8A8 counterpart (resnet_tpu.export
there): BN folded, per-channel int8 weights, per-tensor int8 activations
calibrated on ``calib_images`` (``quantize.quantize_model``), served by a
``QuantizedInferenceModel`` with the same ``call``, ``image_dims`` and
``device``, whose forward runs the two int8 kernels (``kernels.quant``) on
the card. Its int8 weights, in the packed layout Q1 (or, at a grouped
site, Q3) reads, the scales and the dequantization rows are buffers made
once, at construction.

``save_inference`` / ``load_inference`` write and read one file holding the
configs and the tensors, with a ``kind`` field ('fp' or 'int8') from which
``load_inference`` restores either model; ``serve.py`` serves both.

Unlike the JAX package's StableHLO artifact, the file holds no program: the
loader needs this package's model code. A self-contained artifact
(``torch.library`` custom ops and ``torch.export``) is later work
(ROADMAP.md queue A, item A9b).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from .bridge import flatten, tree_map, unflatten
from .config import ExecutionConfig, ModelConfig, resolve_dtype
from .models import forward
from .ops.precision import precision_scope
from .quantize import forward_sites, prepare_sites, quantize_model, site_qparams


def _buffer_name(path: str) -> str:
    # buffer names may not hold '.'
    return path.replace("/", "__").replace(".", "_")


class InferenceModel(nn.Module):
    """Frozen eval forward: images (N, d, d, C), or (N, C, d, d) under an
    NCHW layout, -> fp32 logits (N, classes)."""

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
    def image_dims(self):
        """The shape of one image: (d, d, C), or (C, d, d) under NCHW."""
        d, c = self.mcfg.input_dim, self.mcfg.in_channels
        return (d, d, c) if self.ecfg.layout == "NHWC" else (c, d, d)

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
        _check_images(images, self.image_dims)
        x = _as_input(images, self.device)
        with torch.inference_mode(), precision_scope(self.ecfg):
            return self(x)


def export_inference(
    params,
    mcfg: ModelConfig,
    *,
    bn_state=None,
    ecfg: Optional[ExecutionConfig] = None,
    device=None,
    weights_dtype=None,
) -> InferenceModel:
    """Freeze (params, bn_state) into an ``InferenceModel`` on ``device``
    (default: the device the parameters are on); ``weights_dtype`` (a name
    or a torch dtype) casts the parameters and the running statistics."""
    if weights_dtype is not None:
        wd = resolve_dtype(weights_dtype)
        params = tree_map(lambda t: t.to(wd), params)
        if bn_state is not None:
            bn_state = tree_map(lambda t: t.to(wd), bn_state)
    model = InferenceModel(params, bn_state, mcfg, ecfg or ExecutionConfig())
    return model.to(device) if device is not None else model


class QuantizedInferenceModel(nn.Module):
    """Frozen W8A8 forward: NHWC fp32 images (N, d, d, C) -> fp32 logits
    (N, classes) through ``quantize.forward_sites``. Every tensor a site's
    kernels read (``quantize.prepare_sites``) is a buffer."""

    def __init__(self, qparams, scales, mcfg: ModelConfig, relu_cap=None):
        super().__init__()
        self.mcfg, self.relu_cap = mcfg, relu_cap
        self.scales = {k: float(v) for k, v in scales.items()}
        # site -> ({key: buffer name}, {key: the float inv, the weight's kshape})
        self._sites = {}
        for name, site in prepare_sites(qparams, self.scales, mcfg).items():
            bufs, consts = {}, {}
            for key, v in site.items():
                if isinstance(v, torch.Tensor):
                    bufs[key] = _buffer_name(f"sites/{name}/{key}")
                    self.register_buffer(bufs[key], v.detach().clone())
                else:
                    consts[key] = v
            self._sites[name] = (bufs, consts)

    def sites(self):
        """``prepare_sites``'s dict over this model's buffers."""
        return {name: {**{k: getattr(self, b) for k, b in bufs.items()}, **consts}
                for name, (bufs, consts) in self._sites.items()}

    def qparams(self):
        """The quantized tree (``wq``, ``ws``, ``b``; the FC's wq (K, N))."""
        return site_qparams(self.sites())

    @property
    def image_dims(self):
        """The shape of one image: (d, d, C)."""
        d = self.mcfg.input_dim
        return (d, d, self.mcfg.in_channels)

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward_sites(self.sites(), images, self.mcfg, relu_cap=self.relu_cap)

    def call(self, images) -> torch.Tensor:
        """Logits for a numpy array or tensor of images, on the model's
        device. Raises ValueError on a shape the model does not take."""
        _check_images(images, self.image_dims)
        x = _as_input(images, self.device)
        with torch.inference_mode():
            return self(x)


def _check_images(images, dims):
    if tuple(images.shape[1:]) != dims or len(images.shape) != 4:
        raise ValueError(f"expected images of shape (N, {', '.join(map(str, dims))}), got "
                         f"{tuple(images.shape)}")


def _as_input(images, device) -> torch.Tensor:
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.array(images, dtype=np.float32))
    return images.to(device=device, dtype=torch.float32).contiguous()


def export_quantized_inference(params, mcfg: ModelConfig, calib_images, *, bn_state,
                               relu_cap=None, device=None) -> QuantizedInferenceModel:
    """The W8A8 serving model (quantize.py): BN folded from ``bn_state``,
    weights per-channel int8, activations per-tensor int8 calibrated on
    ``calib_images`` (NHWC, numpy or a tensor) where the parameters lie; on
    ``device`` (default: the parameters' device)."""
    qparams, scales = quantize_model(params, bn_state, mcfg, calib_images, relu_cap=relu_cap)
    model = QuantizedInferenceModel(qparams, scales, mcfg, relu_cap)
    return model.to(device) if device is not None else model


def save_inference(path: str, model) -> str:
    """Write an ``InferenceModel`` or a ``QuantizedInferenceModel`` to one
    file (its tensors on the host)."""
    if isinstance(model, QuantizedInferenceModel):
        blob = {"kind": "int8", "model_config": dataclasses.asdict(model.mcfg),
                "relu_cap": model.relu_cap, "scales": dict(model.scales),
                "qparams": {p: t.cpu() for p, t in flatten(model.qparams())}}
    else:
        blob = {
            "kind": "fp",
            "model_config": dataclasses.asdict(model.mcfg),
            "execution_config": dataclasses.asdict(model.ecfg),
            "params": {p: getattr(model, n).cpu() for p, n in model._trees["params"]},
            "bn_state": {p: getattr(model, n).cpu() for p, n in model._trees["bn_state"]},
        }
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_inference(path: str, device="cuda"):
    """Restore a saved model, fp or int8 by the file's ``kind``, on
    ``device`` (the card unless the caller asks for the CPU); run it with
    ``.call(images)``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    mcfg = blob["model_config"]
    mcfg = ModelConfig(**{**mcfg, "block_sizes": tuple(mcfg["block_sizes"])})
    if blob.get("kind", "fp") == "int8":
        model = QuantizedInferenceModel(unflatten(blob["qparams"].items()), blob["scales"],
                                        mcfg, blob["relu_cap"])
        return model.to(device)
    ecfg = ExecutionConfig(**blob["execution_config"])
    params = unflatten(blob["params"].items())
    bn_state = unflatten(blob["bn_state"].items()) if blob["bn_state"] else None
    return export_inference(params, mcfg, bn_state=bn_state, ecfg=ecfg,
                            device=device)
