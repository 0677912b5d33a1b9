"""Parameter initialization with the reference's per-tensor variances.

Same tree structure, shapes and variances as resnet_tpu.models.init:
N(0, sqrt(var)) with var = 2 / (k^2 * (fan_in + fan_out)) for every conv
(HWIO), 1e-4 for the FC weight (in, out), BN gamma = 1 and beta = 0. The
draws come from a ``torch.Generator`` and so differ from JAX's; parity
tests take JAX's parameters through ``resnet_tpu_torch.bridge``.

Draws are made on the generator's device and then moved to ``device``, so
one seed gives the same weights on the CPU and on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..config import ModelConfig


def gaussian(gen: torch.Generator, shape, variance, *, device, dtype=torch.float32):
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * variance ** 0.5).to(device=device, dtype=dtype)


def _conv_init(gen, kh, kw, cin, cout, device, dtype):
    var = 2.0 / (kh * kw * (cin + cout))
    return gaussian(gen, (kh, kw, cin, cout), var, device=device, dtype=dtype)


def _bn_init(depth, device, dtype, zero_gamma=False):
    gamma = torch.zeros if zero_gamma else torch.ones
    return {
        "gamma": gamma((depth,), device=device, dtype=dtype),
        "beta": torch.zeros((depth,), device=device, dtype=dtype),
    }


def _block_widths(cfg: ModelConfig):
    """(incoming, width, out_ch, reduction) for each block."""
    incoming = cfg.init_filters
    for i in range(cfg.num_blocks):
        base = cfg.init_filters * (2 ** cfg.stage_of_block(i))
        width = int(base * cfg.width_multiplier)
        out_ch = base * cfg.expansion if cfg.bottleneck else width
        yield incoming, width, out_ch, cfg.is_reduction_block(i)
        incoming = out_ch


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device="cpu",
                dtype=torch.float32) -> Dict[str, Any]:
    """The parameter tree (see resnet_tpu.models.init.init_params)."""
    params: Dict[str, Any] = {
        "init_conv": {"w": _conv_init(gen, cfg.init_kernel, cfg.init_kernel,
                                      cfg.in_channels, cfg.init_filters,
                                      device, dtype)},
        "init_bn": _bn_init(cfg.init_filters, device, dtype),
    }
    blocks: List[Dict[str, Any]] = []
    out_ch = cfg.init_filters
    for incoming, width, out_ch, reduction in _block_widths(cfg):
        block: Dict[str, Any] = {}
        if cfg.bottleneck:
            block["reduce"] = {"w": _conv_init(gen, 1, 1, incoming, width, device, dtype)}
            block["bn_reduce"] = _bn_init(width, device, dtype)
            block["spatial"] = {"w": _conv_init(gen, 3, 3, width // cfg.groups,
                                                width, device, dtype)}
            block["bn_spatial"] = _bn_init(width, device, dtype)
            block["expand"] = {"w": _conv_init(gen, 1, 1, width, out_ch, device, dtype)}
            block["bn_expand"] = _bn_init(out_ch, device, dtype,
                                          zero_gamma=cfg.zero_init_residual)
        else:
            block["conv1"] = {"w": _conv_init(gen, 3, 3, incoming, width, device, dtype)}
            block["bn1"] = _bn_init(width, device, dtype)
            block["conv2"] = {"w": _conv_init(gen, 3, 3, width, width, device, dtype)}
            block["bn2"] = _bn_init(width, device, dtype,
                                    zero_gamma=cfg.zero_init_residual)
        if incoming != out_ch or reduction:
            pk = cfg.stride_projection_kernel if reduction else 1
            block["proj"] = {"w": _conv_init(gen, pk, pk, incoming, out_ch, device, dtype)}
            block["bn_proj"] = _bn_init(out_ch, device, dtype)
        blocks.append(block)
    params["blocks"] = blocks
    fc = {"w": gaussian(gen, (out_ch, cfg.num_classes), 1e-4,
                        device=device, dtype=dtype)}
    if cfg.fc_bias:
        fc["b"] = torch.zeros((cfg.num_classes,), device=device, dtype=dtype)
    params["fc"] = fc
    return params


def init_bn_state(cfg: ModelConfig, *, device="cpu") -> Dict[str, Any]:
    """Running statistics for eval BN: mean 0, var 1 per channel."""

    def stat(depth):
        return {
            "mean": torch.zeros((depth,), device=device, dtype=torch.float32),
            "var": torch.ones((depth,), device=device, dtype=torch.float32),
        }

    blocks = []
    for incoming, width, out_ch, reduction in _block_widths(cfg):
        b: Dict[str, Any] = {}
        if cfg.bottleneck:
            b["bn_reduce"] = stat(width)
            b["bn_spatial"] = stat(width)
            b["bn_expand"] = stat(out_ch)
        else:
            b["bn1"] = stat(width)
            b["bn2"] = stat(width)
        if incoming != out_ch or reduction:
            b["bn_proj"] = stat(out_ch)
        blocks.append(b)
    return {"init_bn": stat(cfg.init_filters), "blocks": blocks}
