"""Activation dumps, the fidelity harness's data channel: the port of
resnet_tpu.analysis.dump on tensors.

The reference's dump_trainer writes every forward activation and BN cache
as raw float32 .buffer files (resnet.cu:2350-2679), which its analysis
notebook reloads for numpy cross-checks (analyze_trainer_dump.ipynb).
``models.forward(..., capture=True)`` gives a tape keyed after the
reference's Activations struct (resnet.h:99-152); this module writes it in
the same raw-buffer style with a manifest, in the JAX package's format, so
that the reference's dumps, the JAX package's and the port's compare tensor
by tensor.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def _flatten_tape(tape: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tape.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_tape(v, prefix=name + "/"))
        else:
            flat[name] = v.detach().cpu().numpy()
    return flat


def dump_activations(out_dir: str, params, images, mcfg, ecfg=None, *, bn_state=None,
                     train: bool = True) -> Dict[str, np.ndarray]:
    """Run a captured forward pass and dump every intermediate tensor.

    ``images`` is an NHWC tensor, or a numpy array that goes to the
    parameters' device. Writes <out_dir>/<name>.buffer (raw float32,
    reference style) and manifest.json with shapes and dtypes. Returns the
    tape as numpy arrays."""
    from ..bridge import leaves
    from ..models import forward

    if not isinstance(images, torch.Tensor):
        device = leaves(params)[0].device
        images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    with torch.no_grad():
        logits, aux = forward(params, images, mcfg, ecfg, train=train, bn_state=bn_state,
                              capture=True)
    tape = _flatten_tape(aux["activations"])
    tape["logits"] = logits.cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    manifest = {}
    for name, arr in tape.items():
        fname = name.replace("/", "__") + ".buffer"
        arr.astype(np.float32).tofile(os.path.join(out_dir, fname))
        manifest[name] = {"file": fname, "shape": list(arr.shape), "dtype": "float32"}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return tape


def load_activation_dump(dump_dir: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(dump_dir, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, meta in manifest.items():
        arr = np.fromfile(os.path.join(dump_dir, meta["file"]), dtype=np.float32)
        out[name] = arr.reshape(meta["shape"])
    return out
