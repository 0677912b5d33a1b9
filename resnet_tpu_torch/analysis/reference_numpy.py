"""Pure-numpy transliteration of the reference's forward pass — the
adversarial fidelity oracle. A copy of resnet_tpu.analysis.reference_numpy
(numpy only), so the port needs nothing of the JAX package.

Every function here is written FROM the reference CUDA kernels' math, not
from this repo's model code, so a silent divergence in our BN semantics,
conv/pool window geometry, or head numerics fails the comparison even if
our own golden files were regenerated around the bug.

Transliterated semantics (file:line into the reference sources):
  conv_ref      doConvolution (resnet.cu:109-156): window centered at
                stride*out_pos, half-kernel k//2 reach each side, out-of-
                bounds taps contribute 0, out_dim = in_dim // stride.
  bn_ref        doBatchNormAndActivate (resnet.cu:289-342): per-channel
                mean and BIASED variance over N*H*W, y = gamma*(x-mean)/
                sqrt(var+eps) + beta, optional relu.
  maxpool_ref   doMaxPool (resnet.cu:433-472): centered window like conv,
                out-of-bounds taps SKIPPED (not zero-padded), running max
                seeded at -1024 with strictly-greater updates.
  avgpool_ref   doFilterAvgPool (resnet.cu:500-520): global spatial mean.
  softmax_unstable  softMax (resnet.cu:569-580): exp(z)/sum(exp(z)), no
                max subtraction — the reference's numerically naive form.
  forward_reference_numpy  forward_pass (resnet.cu:1526-1775): stem conv ->
                BN+ReLU -> maxpool -> 16 bottlenecks (reduce/BN+ReLU,
                spatial(stride)/BN+ReLU, expand/BN, [proj/BN], add, ReLU)
                -> global avgpool -> FC -> softmax.

All math in float32 (the reference is fp32 throughout), with float64 only
where numpy's BLAS would otherwise change the contraction dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np


def conv_ref(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """doConvolution: x (N,H,W,Ci) fp32, w (kh,kw,Ci,Co) [our HWIO layout
    of the same weights], window centered at stride*out_pos, zero padding.
    """
    x = np.asarray(x, np.float32)
    w = np.asarray(w, np.float32)
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    hk_h, hk_w = kh // 2, kw // 2
    ho, wo = h // stride, wd // stride
    # pad so every centered window index is in-bounds, then shift-accumulate
    xp = np.zeros((n, h + 2 * hk_h, wd + 2 * hk_w, ci), np.float32)
    xp[:, hk_h : hk_h + h, hk_w : hk_w + wd, :] = x
    out = np.zeros((n, ho, wo, co), np.float32)
    for r in range(kh):
        for c in range(kw):
            # input rows stride*o + (r - hk) in original coords = stride*o + r in padded
            win = xp[:, r : r + stride * (ho - 1) + 1 : stride,
                     c : c + stride * (wo - 1) + 1 : stride, :]
            out += np.tensordot(win, w[r, c], axes=([3], [0]))
    return out


def bn_ref(
    x: np.ndarray, gamma: np.ndarray, beta: np.ndarray, eps: float,
    relu: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """doBatchNormAndActivate: returns (y, mean, var) with biased variance
    over batch*space."""
    x = np.asarray(x, np.float32)
    mean = x.mean(axis=(0, 1, 2), dtype=np.float32)
    var = ((x - mean) ** 2).mean(axis=(0, 1, 2), dtype=np.float32)
    y = gamma.astype(np.float32) * (x - mean) / np.sqrt(var + np.float32(eps)) \
        + beta.astype(np.float32)
    if relu:
        y = np.maximum(y, 0.0)
    return y.astype(np.float32), mean, var


def maxpool_ref(x: np.ndarray, kern: int = 3, stride: int = 2) -> np.ndarray:
    """doMaxPool: centered window, OOB taps skipped, max seeded at -1024."""
    x = np.asarray(x, np.float32)
    n, h, w, c = x.shape
    hk = kern // 2
    ho, wo = h // stride, w // stride
    out = np.full((n, ho, wo, c), -1024.0, np.float32)
    for r_off in range(-hk, hk + 1):
        for c_off in range(-hk, hk + 1):
            # valid out positions: 0 <= stride*o + off <= dim-1
            lo_r = max(0, (-r_off + stride - 1) // stride) if r_off < 0 else 0
            hi_r = min(ho - 1, (h - 1 - r_off) // stride)
            lo_c = max(0, (-c_off + stride - 1) // stride) if c_off < 0 else 0
            hi_c = min(wo - 1, (w - 1 - c_off) // stride)
            if hi_r < lo_r or hi_c < lo_c:
                continue
            win = x[
                :,
                stride * lo_r + r_off : stride * hi_r + r_off + 1 : stride,
                stride * lo_c + c_off : stride * hi_c + c_off + 1 : stride,
                :,
            ]
            sub = out[:, lo_r : hi_r + 1, lo_c : hi_c + 1, :]
            np.maximum(sub, win, out=sub)
    return out


def avgpool_ref(x: np.ndarray) -> np.ndarray:
    """doFilterAvgPool: global spatial mean, (N,H,W,C) -> (N,C)."""
    return np.asarray(x, np.float32).mean(axis=(1, 2), dtype=np.float32)


def softmax_unstable(z: np.ndarray) -> np.ndarray:
    """softMax (resnet.cu:569-580): no max subtraction."""
    e = np.exp(np.asarray(z, np.float32))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


def forward_reference_numpy(
    params: Dict[str, Any],
    x: np.ndarray,
    mcfg,
    *,
    capture: bool = False,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """forward_pass (resnet.cu:1526-1775) on our param pytree (NHWC / HWIO).

    Returns (logits, preds, tape). Bottleneck-only — the reference has no
    basic-block variant.
    """
    eps = mcfg.bn_eps
    tape: Dict[str, Any] = {}

    def g(bn):
        return np.asarray(bn["gamma"]), np.asarray(bn["beta"])

    out = conv_ref(x, np.asarray(params["init_conv"]["w"]), mcfg.init_stride)
    out, _, _ = bn_ref(out, *g(params["init_bn"]), eps, relu=True)
    if capture:
        tape["init_conv_activated"] = out
    out = maxpool_ref(out, mcfg.maxpool_kernel, mcfg.maxpool_stride)
    if capture:
        tape["max_pooled"] = out

    for i, bp in enumerate(params["blocks"]):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        r = conv_ref(out, np.asarray(bp["reduce"]["w"]), 1)
        r, _, _ = bn_ref(r, *g(bp["bn_reduce"]), eps, relu=True)
        s = conv_ref(r, np.asarray(bp["spatial"]["w"]), stride)
        s, _, _ = bn_ref(s, *g(bp["bn_spatial"]), eps, relu=True)
        e = conv_ref(s, np.asarray(bp["expand"]["w"]), 1)
        e, _, _ = bn_ref(e, *g(bp["bn_expand"]), eps, relu=False)
        if "proj" in bp:
            p = conv_ref(out, np.asarray(bp["proj"]["w"]), stride)
            p, _, _ = bn_ref(p, *g(bp["bn_proj"]), eps, relu=False)
        else:
            p = out
        out = np.maximum(e + p, 0.0).astype(np.float32)
        if capture:
            tape[f"block_{i}_output_activated"] = out

    pooled = avgpool_ref(out)
    logits = (pooled @ np.asarray(params["fc"]["w"], np.float32)).astype(np.float32)
    if "b" in params["fc"]:
        logits = logits + np.asarray(params["fc"]["b"], np.float32)
    preds = softmax_unstable(logits)
    if capture:
        tape["final_avg_pool"] = pooled
        tape["linear_output"] = logits
        tape["pred"] = preds
    return logits, preds, tape
