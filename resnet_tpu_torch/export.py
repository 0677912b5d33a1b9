"""Serving export: freeze the eval forward into a self-contained artifact.

The counterpart of resnet_tpu.export. ``export_inference`` closes the eval
forward (running-stats BN) over (params, bn_state) and returns an
``InferenceModel``, an ``nn.Module`` whose weights are buffers on one
device and whose ``.call`` maps fp32 images (NHWC, or NCHW under the
execution config's ``layout``, as JAX's export.py:69-70) to fp32 logits.
``weights_dtype`` casts the parameters and the BN running statistics
(export.py:57-61 there), e.g. to bfloat16. ``export_quantized_inference``
is the W8A8 counterpart: BN folded, per-channel int8 weights, per-tensor
int8 activations calibrated on ``calib_images`` (``quantize.quantize_model``),
served by a ``QuantizedInferenceModel`` with the same ``call``,
``image_dims`` and ``device``, whose forward runs the int8 kernels
(``kernels.quant``) on the card. Its int8 weights, in the packed layout Q1
(or, at a grouped site, Q3) reads, the scales and the dequantization rows
are buffers made once, at construction. ``export_inference_from_state``
exports a ``TrainState`` under its ``TrainConfig``.

Both models are the eager modules that ``save_inference`` traces. As JAX's
take ``batch``, so do these: None (the default) traces a symbolic batch
(``torch.export.Dim``; one artifact serves any batch size), an int pins
it. ``save_inference(path, model)`` runs ``torch.export.export`` on the
model over that batch, so the program calls the hand kernels as the custom
ops of ``kernels.ops``, and writes it with its weights and a JSON record
(the kind, 'fp' or 'int8', the configs as plain dicts, the device, the
``matmul_precision``) to one file with ``torch.export.save``, atomically.
``load_inference`` (``artifact.py``) restores it without the model code;
``serve.py`` serves it. An artifact runs on the device it was exported on.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Optional

import torch
from torch import nn

from .artifact import FORMAT, META, as_input, check_images, indexed, load_inference
from .bridge import flatten, tree_map, unflatten
from .config import ExecutionConfig, ModelConfig, resolve_dtype
from .models import forward
from .ops.precision import precision_scope
from .quantize import forward_sites, prepare_sites, quantize_model, site_qparams

__all__ = ["InferenceModel", "QuantizedInferenceModel", "export_inference",
           "export_inference_from_state", "export_quantized_inference", "export_program",
           "load_inference", "save_inference"]
# the example batch a symbolic batch is traced at: torch.export specializes
# the sizes 0 and 1
TRACE_BATCH = 2


def _buffer_name(path: str) -> str:
    # buffer names may not hold '.'
    return path.replace("/", "__").replace(".", "_")


class InferenceModel(nn.Module):
    """Frozen eval forward: images (N, d, d, C), or (N, C, d, d) under an
    NCHW layout, -> fp32 logits (N, classes)."""

    def __init__(self, params, bn_state, mcfg: ModelConfig, ecfg: ExecutionConfig,
                 batch: Optional[int] = None):
        super().__init__()
        self.mcfg, self.ecfg, self.batch = mcfg, ecfg, batch
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
        check_images(images, self.image_dims)
        x = as_input(images, self.device)
        with torch.inference_mode(), precision_scope(self.ecfg):
            return self(x)

    def meta(self):
        """What ``save_inference`` records beside the program."""
        return {"kind": "fp", "model_config": dataclasses.asdict(self.mcfg),
                "execution_config": dataclasses.asdict(self.ecfg),
                "matmul_precision": self.ecfg.matmul_precision}


def export_inference(
    params,
    mcfg: ModelConfig,
    *,
    bn_state=None,
    ecfg: Optional[ExecutionConfig] = None,
    device=None,
    weights_dtype=None,
    batch: Optional[int] = None,
) -> InferenceModel:
    """Freeze (params, bn_state) into an ``InferenceModel`` on ``device``
    (default: the device the parameters are on); ``weights_dtype`` (a name
    or a torch dtype) casts the parameters and the running statistics;
    ``batch`` None exports a symbolic batch, an int pins it."""
    if weights_dtype is not None:
        wd = resolve_dtype(weights_dtype)
        params = tree_map(lambda t: t.to(wd), params)
        if bn_state is not None:
            bn_state = tree_map(lambda t: t.to(wd), bn_state)
    model = InferenceModel(params, bn_state, mcfg, ecfg or ExecutionConfig(), batch)
    return model.to(device) if device is not None else model


def export_inference_from_state(state, cfg, **kwargs) -> InferenceModel:
    """Export a ``TrainState`` under its ``TrainConfig``: its parameters and
    running statistics, its model and execution configs."""
    return export_inference(state.params, cfg.model, bn_state=state.bn_state,
                            ecfg=cfg.execution, **kwargs)


class QuantizedInferenceModel(nn.Module):
    """Frozen W8A8 forward: NHWC fp32 images (N, d, d, C) -> fp32 logits
    (N, classes) through ``quantize.forward_sites``. Every tensor a site's
    kernels read (``quantize.prepare_sites``) is a buffer."""

    def __init__(self, qparams, scales, mcfg: ModelConfig, relu_cap=None,
                 batch: Optional[int] = None):
        super().__init__()
        self.mcfg, self.relu_cap, self.batch = mcfg, relu_cap, batch
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
        check_images(images, self.image_dims)
        x = as_input(images, self.device)
        with torch.inference_mode():
            return self(x)

    def meta(self):
        """What ``save_inference`` records beside the program; the int8
        forward's plain ops are fp32 with TF32 off."""
        return {"kind": "int8", "model_config": dataclasses.asdict(self.mcfg),
                "relu_cap": self.relu_cap, "scales": dict(self.scales),
                "matmul_precision": "highest"}


def export_quantized_inference(params, mcfg: ModelConfig, calib_images, *, bn_state,
                               relu_cap=None, device=None, batch: Optional[int] = None
                               ) -> QuantizedInferenceModel:
    """The W8A8 serving model (quantize.py): BN folded from ``bn_state``,
    weights per-channel int8, activations per-tensor int8 calibrated on
    ``calib_images`` (NHWC, numpy or a tensor) where the parameters lie; on
    ``device`` (default: the parameters' device); ``batch`` as
    ``export_inference``'s."""
    qparams, scales = quantize_model(params, bn_state, mcfg, calib_images, relu_cap=relu_cap)
    model = QuantizedInferenceModel(qparams, scales, mcfg, relu_cap, batch)
    return model.to(device) if device is not None else model


def export_program(model) -> torch.export.ExportedProgram:
    """``torch.export`` of an ``InferenceModel`` or a
    ``QuantizedInferenceModel`` over its batch: symbolic (traced at
    TRACE_BATCH images, valid from 1 up) unless the model pins one."""
    n = model.batch or TRACE_BATCH
    x = torch.zeros((n, *model.image_dims), dtype=torch.float32, device=model.device)
    dynamic = None if model.batch else {"images": {0: torch.export.Dim("batch", min=1)}}
    with torch.no_grad():
        return torch.export.export(model, (x,), dynamic_shapes=dynamic, strict=False)


def save_inference(path: str, model) -> str:
    """Trace an ``InferenceModel`` or a ``QuantizedInferenceModel``
    (``export_program``) and write the program, its weights and its record
    to one file, atomically; ``load_inference`` runs it."""
    meta = {"format": FORMAT, **model.meta(), "image_dims": list(model.image_dims),
            "batch": model.batch, "device": str(indexed(model.device)),
            "torch": torch.__version__}
    buf = io.BytesIO()
    torch.export.save(export_program(model), buf, extra_files={META: json.dumps(meta)})
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)
    return path
