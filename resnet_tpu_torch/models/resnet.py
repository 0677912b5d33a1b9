"""ResNet eval forward (bottleneck and basic blocks), NHWC.

The port of resnet_tpu.models.resnet.forward with ``train=False``:

  stem conv -> BN+ReLU -> 3x3/s2 maxpool
  -> blocks [1x1 reduce -> BN+ReLU -> 3x3 (stride here) -> BN+ReLU
     -> 1x1 expand -> BN -> (+ projected residual) -> ReLU]
  -> global avg pool -> FC (no bias in the reference)

BN uses the running statistics (``bn_state``); ``bn_mode='off'`` skips the
normalization as in the JAX package. ``ExecutionConfig.conv_kernels`` picks
the conv engine and ``ExecutionConfig.kernels`` the join and FC engine
(``ops.dispatch``). Training mode comes with ROADMAP.md queue A, item A2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import (
    ROADMAP_GROUPED,
    ROADMAP_TRAIN,
    ExecutionConfig,
    ModelConfig,
    not_ported,
)
from ..ops import global_avg_pool, max_pool, relu, softmax
from ..ops.conv import conv2d
from ..ops.dispatch import bn_act, conv as _dispatch_conv, fc, residual_join


def _conv(x, w, *, stride, ecfg, groups=1):
    if groups > 1:
        # grouped conv (ResNeXt): plain path only
        if ecfg.conv_kernels == "pallas":
            raise not_ported("groups > 1 with conv_kernels='pallas'",
                             ROADMAP_GROUPED)
        return conv2d(x, w, stride=stride, groups=groups)
    return _dispatch_conv(x, w, stride=stride, engine=ecfg.conv_kernels)


def _bn_apply(x, bn_params, state, *, eps, ecfg, relu_fused=False):
    """Eval BN with running stats (+ the following ReLU). Returns (y, stats)."""
    relu_cap = ecfg.relu_cap if relu_fused else None
    if ecfg.bn_mode == "off":
        y = x
        if relu_fused:
            y = relu(y)
            if relu_cap is not None:
                y = torch.clamp_max(y, relu_cap)
        c = x.shape[-1]
        zero = torch.zeros((c,), device=x.device, dtype=torch.float32)
        return y, (zero, zero + 1.0)
    return bn_act(
        x, bn_params["gamma"], bn_params["beta"], eps=eps, relu=relu_fused,
        relu_cap=relu_cap, mean=state["mean"], var=state["var"],
    )


def _bottleneck_block(bp, x, state, *, stride, mcfg, ecfg):
    eps = mcfg.bn_eps
    stats: Dict[str, Any] = {}
    out = _conv(x, bp["reduce"]["w"], stride=1, ecfg=ecfg)
    out, stats["bn_reduce"] = _bn_apply(out, bp["bn_reduce"], state.get("bn_reduce"),
                                        eps=eps, ecfg=ecfg, relu_fused=True)
    out = _conv(out, bp["spatial"]["w"], stride=stride, ecfg=ecfg,
                groups=mcfg.groups)
    out, stats["bn_spatial"] = _bn_apply(out, bp["bn_spatial"], state.get("bn_spatial"),
                                         eps=eps, ecfg=ecfg, relu_fused=True)
    out = _conv(out, bp["expand"]["w"], stride=1, ecfg=ecfg)
    out, stats["bn_expand"] = _bn_apply(out, bp["bn_expand"], state.get("bn_expand"),
                                        eps=eps, ecfg=ecfg)
    residual = x
    if "proj" in bp:
        residual = _conv(x, bp["proj"]["w"], stride=stride, ecfg=ecfg)
        residual, stats["bn_proj"] = _bn_apply(residual, bp["bn_proj"],
                                               state.get("bn_proj"), eps=eps, ecfg=ecfg)
    out = residual_join(out, residual, engine=ecfg.kernels, relu_cap=ecfg.relu_cap)
    return out, stats


def _basic_block(bp, x, state, *, stride, mcfg, ecfg):
    eps = mcfg.bn_eps
    stats: Dict[str, Any] = {}
    out = _conv(x, bp["conv1"]["w"], stride=stride, ecfg=ecfg)
    out, stats["bn1"] = _bn_apply(out, bp["bn1"], state.get("bn1"), eps=eps,
                                  ecfg=ecfg, relu_fused=True)
    out = _conv(out, bp["conv2"]["w"], stride=1, ecfg=ecfg)
    out, stats["bn2"] = _bn_apply(out, bp["bn2"], state.get("bn2"), eps=eps, ecfg=ecfg)
    residual = x
    if "proj" in bp:
        residual = _conv(x, bp["proj"]["w"], stride=stride, ecfg=ecfg)
        residual, stats["bn_proj"] = _bn_apply(residual, bp["bn_proj"],
                                               state.get("bn_proj"), eps=eps, ecfg=ecfg)
    out = residual_join(out, residual, engine=ecfg.kernels, relu_cap=ecfg.relu_cap)
    return out, stats


def forward(
    params,
    x: torch.Tensor,
    mcfg: ModelConfig,
    ecfg: Optional[ExecutionConfig] = None,
    *,
    train: bool = False,
    bn_state=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the network on NHWC images. Returns (fp32 logits, aux) with
    aux["bn_stats"] the per-layer (mean, var) the forward normalized with."""
    ecfg = ecfg or ExecutionConfig()
    if train:
        raise not_ported("forward(train=True)", ROADMAP_TRAIN)
    if bn_state is None and ecfg.bn_mode != "off":
        raise ValueError("eval-mode BN requires running statistics (bn_state)")
    block_fn = _bottleneck_block if mcfg.bottleneck else _basic_block
    eps = mcfg.bn_eps

    # bn_mode='off' reads no statistics, so bn_state may be None there
    state = bn_state or {"blocks": [{}] * mcfg.num_blocks}
    stats: Dict[str, Any] = {}
    out = _conv(x.to(ecfg.cdtype), params["init_conv"]["w"],
                stride=mcfg.init_stride, ecfg=ecfg)
    out, stats["init_bn"] = _bn_apply(out, params["init_bn"], state.get("init_bn"),
                                      eps=eps, ecfg=ecfg, relu_fused=True)
    out = max_pool(out, kernel=mcfg.maxpool_kernel, stride=mcfg.maxpool_stride)

    block_stats = []
    for i in range(mcfg.num_blocks):
        stride = 2 if mcfg.is_reduction_block(i) else 1
        out, bstats = block_fn(params["blocks"][i], out, state["blocks"][i],
                               stride=stride, mcfg=mcfg, ecfg=ecfg)
        block_stats.append(bstats)
    stats["blocks"] = block_stats

    pooled = global_avg_pool(out)
    logits = fc(pooled, params["fc"]["w"], params["fc"].get("b"),
                engine=ecfg.kernels).to(torch.float32)
    return logits, {"bn_stats": stats}


def predict(params, x, mcfg, ecfg=None, *, bn_state=None, stable_softmax=True):
    """Inference probabilities using running BN statistics."""
    logits, _ = forward(params, x, mcfg, ecfg, train=False, bn_state=bn_state)
    return softmax(logits, stable=stable_softmax)
