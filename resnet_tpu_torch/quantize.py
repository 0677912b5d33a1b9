"""Post-training int8 quantization for serving (W8A8): the port of
resnet_tpu.quantize.

1. ``fold_bn_inference``: eval-mode BN is a per-channel affine with fixed
   running statistics, folded into the conv before it (w' = w * a,
   b' = beta - mean * a, a = gamma / sqrt(var + eps)).
2. ``calibrate``: the folded fp32 model (``folded_forward``) over
   representative batches, each quantization site's input absmax recorded:
   scale[site] = max(absmax, 1e-8) / 127, the largest over the batches.
3. ``quantize_weights``: per-output-channel symmetric int8 weights, with
   the keys of the JAX tree: ``wq`` (int8, HWIO; the FC (K, N)), ``ws``
   (fp32, one per output channel) and the folded bias ``b``.
4. ``quantized_forward``: at every site the input is quantized (Q2,
   ``kernels.quant.quant_act``), convolved in int8 with int32 accumulation
   and dequantized with bias (and ReLU and the cap) in one epilogue (Q1,
   ``kernels.quant.qconv``); activations and joins in bf16; the FC gives
   fp32 logits. NHWC only, as JAX's (its export takes (b, d, d, 3)).

Site names match JAX's: ``init``, ``b{i}.reduce|spatial|expand`` (bottleneck)
or ``b{i}.conv1|conv2`` (basic), ``b{i}.proj``, ``fc``; the reduce and the
proj site quantize the same input twice, as JAX's do.

On the card ``quantized_forward`` launches 54 Q1 and 54 Q2 for ResNet-50,
and for ResNeXt-50 38 Q1, 16 Q3 (the grouped 3x3s) and 54 Q2; on the CPU
the wrappers run their plain versions. ``forward_sites(...,
plain=True)`` runs the plain versions on any device: tests and
``chip_smoke.py`` hold the kernels to them with it. ``folded_forward`` and
the calibration are plain fp32 torch ops with TF32 off
(``ops.precision``), as JAX's are XLA convs at HIGHEST.
The geometry is the training path's: the reference's centred windows
(``ops.padding``; the stem pads (3, 2)). The stem is the 7x7 conv whatever
``ExecutionConfig.space_to_depth`` says: JAX's folded and quantized
forwards have no s2d route either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig
from .kernels import quant
from .ops import global_avg_pool, max_pool
from .ops.conv import conv2d
from .ops.precision import precision_scope

relu = quant.relu_reference


# ---------------------------------------------------------------- folding

def _fold(conv_w, bn, state, eps):
    a = bn["gamma"].float() / torch.sqrt(state["var"].float() + eps)
    b = bn["beta"].float() - state["mean"].float() * a
    return {"w": conv_w.float() * a, "b": b}


def _bn_name(conv: str, bottleneck: bool) -> str:
    return "bn_" + conv if bottleneck or conv == "proj" else "bn" + conv[-1]


def fold_bn_inference(params, bn_state, mcfg: ModelConfig):
    """Fold eval-mode BN (running statistics) into the convs: the tree
    {'init': {w, b}, 'blocks': [{conv: {w, b}}], 'fc': {w[, b]}}."""
    eps = mcfg.bn_eps
    out: Dict[str, Any] = {
        "init": _fold(params["init_conv"]["w"], params["init_bn"], bn_state["init_bn"], eps),
        "blocks": [],
    }
    names = ("reduce", "spatial", "expand") if mcfg.bottleneck else ("conv1", "conv2")
    for bp, bs in zip(params["blocks"], bn_state["blocks"]):
        fb = {}
        for n in (*names, "proj"):
            if n in bp:
                bn = _bn_name(n, mcfg.bottleneck)
                fb[n] = _fold(bp[n]["w"], bp[bn], bs[bn], eps)
        out["blocks"].append(fb)
    out["fc"] = {k: v.float() for k, v in params["fc"].items()}
    return out


# ------------------------------------------------------- fp folded forward

def _observe(observe, site, x):
    if observe is not None:
        observe[site] = x.float().abs().max()


def folded_forward(iparams, x, mcfg: ModelConfig, *, relu_cap=None,
                   observe: Optional[Dict[str, Any]] = None, dtype=torch.float32):
    """Eval forward over BN-folded params (NHWC), in true fp32 (TF32 off).
    With ``observe`` (a dict), records each quantization site's input absmax
    under the names of ``quantized_forward``'s scales."""
    with torch.no_grad(), precision_scope(None):
        return _folded(iparams, x, mcfg, relu_cap, observe, dtype)


def _folded(iparams, x, mcfg, relu_cap, observe, dtype):
    def conv(h, leaf, stride, groups=1):
        return conv2d(h, leaf["w"].to(dtype), stride=stride, groups=groups) + leaf["b"].to(dtype)

    x = x.to(dtype)
    _observe(observe, "init", x)
    h = relu(conv(x, iparams["init"], mcfg.init_stride), relu_cap)
    h = max_pool(h, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride)
    for i, fb in enumerate(iparams["blocks"]):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        if mcfg.bottleneck:
            _observe(observe, f"b{i}.reduce", h)
            o = relu(conv(h, fb["reduce"], 1), relu_cap)
            _observe(observe, f"b{i}.spatial", o)
            o = relu(conv(o, fb["spatial"], stride, mcfg.groups), relu_cap)
            _observe(observe, f"b{i}.expand", o)
            o = conv(o, fb["expand"], 1)
        else:
            _observe(observe, f"b{i}.conv1", h)
            o = relu(conv(h, fb["conv1"], stride), relu_cap)
            _observe(observe, f"b{i}.conv2", o)
            o = conv(o, fb["conv2"], 1)
        if "proj" in fb:
            _observe(observe, f"b{i}.proj", h)
            r = conv(h, fb["proj"], stride)
        else:
            r = h
        h = relu(o + r, relu_cap)
    pooled = global_avg_pool(h)
    _observe(observe, "fc", pooled)
    logits = pooled @ iparams["fc"]["w"].to(dtype)
    if "b" in iparams["fc"]:
        logits = logits + iparams["fc"]["b"].to(dtype)
    return logits.to(torch.float32)


# ------------------------------------------------------------ calibration

def calibrate(iparams, images, mcfg: ModelConfig, *, relu_cap=None,
              batch_size: int = 0) -> Dict[str, float]:
    """Per-tensor symmetric activation scales from representative images
    (numpy or a tensor, NHWC): scale[site] = max(absmax, 1e-8) / 127 in
    fp32, the largest over batches of ``batch_size`` (0: one batch). The
    scales are Python floats that fp32 holds exactly."""
    images = torch.as_tensor(images).to(iparams["init"]["w"].device)
    n = images.shape[0]
    bs = batch_size or n
    scales: Dict[str, torch.Tensor] = {}
    for i in range(0, n, bs):
        obs: Dict[str, torch.Tensor] = {}
        folded_forward(iparams, images[i:i + bs], mcfg, relu_cap=relu_cap, observe=obs)
        for k, v in obs.items():
            v = torch.clamp_min(v, 1e-8) / 127.0
            scales[k] = v if k not in scales else torch.maximum(scales[k], v)
    return {k: float(v) for k, v in scales.items()}


# ------------------------------------------------------- weight quantizing

def _quantize_w(leaf):
    w = leaf["w"].float()
    s = torch.clamp_min(w.abs().amax(dim=tuple(range(w.ndim - 1))), 1e-8) / 127.0
    out = {"wq": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "ws": s}
    if "b" in leaf:
        out["b"] = leaf["b"]
    return out


def quantize_weights(iparams, mcfg: ModelConfig):
    """Per-output-channel symmetric int8 weights for every conv and the FC."""
    return {"init": _quantize_w(iparams["init"]),
            "blocks": [{k: _quantize_w(v) for k, v in fb.items()} for fb in iparams["blocks"]],
            "fc": _quantize_w(iparams["fc"])}


# ------------------------------------------------------ quantized forward

def site_leaves(qparams) -> Dict[str, Dict[str, torch.Tensor]]:
    """The quantized tree's leaves by site name."""
    out = {"init": qparams["init"]}
    for i, qb in enumerate(qparams["blocks"]):
        out.update({f"b{i}.{k}": v for k, v in qb.items()})
    out["fc"] = qparams["fc"]
    return out


def site_tree(leaves: Dict[str, Dict[str, torch.Tensor]]):
    """``site_leaves``'s inverse."""
    blocks: Dict[int, Dict[str, Any]] = {}
    for name, leaf in leaves.items():
        if name.startswith("b") and "." in name:
            i, conv = name[1:].split(".")
            blocks.setdefault(int(i), {})[conv] = leaf
    return {"init": leaves["init"], "blocks": [blocks[i] for i in range(len(blocks))],
            "fc": leaves["fc"]}


def inverse_scale(scale: float) -> float:
    """1 / scale in fp32, as JAX computes it (quantize.py:214)."""
    return float(np.float32(1.0) / np.float32(scale))


def prepare_sites(qparams, scales: Dict[str, float], mcfg: ModelConfig):
    """What each site's kernels read, by site name: ``groups`` (the model's
    at the bottleneck's spatial sites, else 1), ``wk``, the int8 weight as
    Q1 or, grouped, Q3 reads it (``quant.pack_weight`` of the HWIO ``wq``;
    the FC's as (1, 1, K, N)), ``kshape`` = (kh, kw, Cin / groups) to
    recover ``wq`` from it (``quant.unpack_weight``), ``ws``, ``b`` (where
    the site has one), ``dq`` = ws * scale in fp32 (JAX's order) and
    ``inv`` = 1 / scale in fp32 (a float)."""
    sites = {}
    for name, q in site_leaves(qparams).items():
        scale = float(np.float32(scales[name]))
        wq = q["wq"] if q["wq"].dim() == 4 else q["wq"].reshape(1, 1, *q["wq"].shape)
        groups = mcfg.groups if name.endswith(".spatial") else 1
        site = {"wk": quant.pack_weight(wq, groups), "kshape": tuple(wq.shape[:3]),
                "groups": groups, "ws": q["ws"], "dq": q["ws"].float() * scale,
                "inv": inverse_scale(scale)}
        if "b" in q:
            site["b"] = q["b"].float().contiguous()
        sites[name] = site
    return sites


def forward_sites(sites, x: torch.Tensor, mcfg: ModelConfig, *, relu_cap=None,
                  plain: bool = False) -> torch.Tensor:
    """``quantized_forward`` over ``prepare_sites``'s tensors: NHWC images
    (fp32) -> fp32 logits. ``plain=True`` runs the kernels' plain versions
    on any device: tests and ``chip_smoke.py`` hold the kernels to them."""
    if x.dim() != 4 or x.shape[-1] != mcfg.in_channels:
        raise ValueError(f"quantized inference takes NHWC images (N, H, W, "
                         f"{mcfg.in_channels}); got {tuple(x.shape)}")

    def site(name, h, stride, act=False, out_dtype=torch.bfloat16):
        s = sites[name]
        w = quant.unpack_weight(s["wk"], s["kshape"], s["groups"])
        kw = dict(stride=stride, groups=s["groups"], relu=act, cap=relu_cap if act else None,
                  out_dtype=out_dtype)
        if plain:
            return quant.qconv_reference(quant.quant_act_reference(h, s["inv"]), w, s["dq"],
                                         s.get("b"), **kw)
        return quant.qconv(quant.quant_act(h, s["inv"]), w, s["dq"], s.get("b"), wk=s["wk"],
                           **kw)

    with torch.no_grad():
        h = site("init", x.contiguous(), mcfg.init_stride, act=True)
        h = max_pool(h, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride)
        for i in range(mcfg.num_blocks):
            stride = 2 if mcfg.is_reduction_block(i) else 1
            if mcfg.bottleneck:
                o = site(f"b{i}.reduce", h, 1, act=True)
                o = site(f"b{i}.spatial", o, stride, act=True)
                o = site(f"b{i}.expand", o, 1)
            else:
                o = site(f"b{i}.conv1", h, stride, act=True)
                o = site(f"b{i}.conv2", o, 1)
            r = site(f"b{i}.proj", h, stride) if f"b{i}.proj" in sites else h
            h = relu(o + r, relu_cap)
        pooled = global_avg_pool(h)
        n, k = pooled.shape
        logits = site("fc", pooled.view(n, 1, 1, k), 1, out_dtype=torch.float32)
        return logits.view(n, -1)


def site_qparams(sites):
    """The quantized tree (``wq`` HWIO, the FC's (K, N); ``ws``; ``b``) of
    ``prepare_sites``'s dict, ``wq`` recovered from ``wk``."""
    leaves = {}
    for name, s in sites.items():
        wq = quant.unpack_weight(s["wk"], s["kshape"], s["groups"]).contiguous()
        leaves[name] = {"wq": wq.view(wq.shape[2:]) if name == "fc" else wq, "ws": s["ws"],
                        **({"b": s["b"]} if "b" in s else {})}
    return site_tree(leaves)


def quantized_forward(qparams, scales, x: torch.Tensor, mcfg: ModelConfig, *,
                      relu_cap=None) -> torch.Tensor:
    """W8A8 inference (NHWC): every conv and the FC in int8 with int32
    accumulation, epilogues and joins in bf16, fp32 logits."""
    return forward_sites(prepare_sites(qparams, scales, mcfg), x, mcfg, relu_cap=relu_cap)


# ------------------------------------------------------------- one-shot

def quantize_model(params, bn_state, mcfg: ModelConfig, calib_images, *, relu_cap=None,
                   calib_batch_size: int = 0):
    """fold -> calibrate -> quantize. Returns (qparams, scales); serve with
    ``quantized_forward(qparams, scales, images, mcfg)``."""
    iparams = fold_bn_inference(params, bn_state, mcfg)
    scales = calibrate(iparams, calib_images, mcfg, relu_cap=relu_cap,
                       batch_size=calib_batch_size)
    return quantize_weights(iparams, mcfg), scales
