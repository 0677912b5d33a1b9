"""Engine dispatch: plain torch ops vs the hand kernels.

Same rules as resnet_tpu.ops.dispatch:

* ``residual_join``: ``engine='pallas'`` and no ``relu_cap`` -> the add_relu
  kernel;
* ``fc``: ``engine='pallas'`` -> the matmul kernel;
* ``conv``: ``engine='pallas'`` (ExecutionConfig.conv_kernels) -> the conv
  kernel, with the reference's windows or an explicit padding;
* ``bn_act`` with batch statistics, ``engine='pallas'`` and NHWC -> the
  moments kernel on the (N*H*W, C) view (``bn_stats``), then normalize and
  ReLU in plain ops (dispatch.py:58-74); NCHW takes the plain statistics,
  as in the JAX package; in eval mode (given mean/var) it always runs the
  plain ops, as the JAX package sends it through XLA.

Otherwise plain torch ops run, which may use cuDNN or cuBLAS on the card,
as the JAX package runs them in XLA outside any Pallas kernel. The hand
conv kernel is NHWC: an NCHW activation is transposed to NHWC around it and
back (dispatch.py:102-106). The join and the FC do not depend on layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import bn as _kbn, conv as _kconv, fused as _kfused, matmul as _kmatmul
from .activation import relu as _relu
from .batchnorm import batch_moments, batch_norm
from .conv import conv2d
from .linear import linear


def bn_stats(x: torch.Tensor, *, engine: str = "xla", layout: str = "NHWC"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch (mean, var) of an NHWC or NCHW tensor, differentiable: the
    moments kernel under ``engine='pallas'`` for NHWC, else the plain sums."""
    if engine == "pallas" and layout == "NHWC":
        return _kbn.moments(x.reshape(-1, x.shape[-1]))
    return batch_moments(x, layout)


def bn_act(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float,
    relu: bool,
    relu_cap: Optional[float] = None,
    engine: str = "xla",
    layout: str = "NHWC",
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BN, with batch statistics unless mean and var are given, then ReLU
    (capped if relu_cap). Returns (y, (mean, var))."""
    if mean is None or var is None:
        # the one-read statistics kernel under 'pallas'; the normalization
        # stays in torch ops
        mean, var = bn_stats(x, engine=engine, layout=layout)
    y, stats = batch_norm(x, gamma, beta, eps=eps, layout=layout, mean=mean, var=var)
    if relu:
        y = _relu(y)
        if relu_cap is not None:
            y = torch.clamp_max(y, relu_cap)
    return y, stats


def residual_join(a: torch.Tensor, b: torch.Tensor, *, engine: str = "xla",
                  relu_cap: Optional[float] = None) -> torch.Tensor:
    """relu(a + b), the residual join (resnet.cu:1717-1723)."""
    if engine == "pallas" and relu_cap is None:
        return _kfused.add_relu(a, b)
    y = _relu(a + b)
    if relu_cap is not None:
        y = torch.clamp_max(y, relu_cap)
    return y


def conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
         engine: str = "xla", layout: str = "NHWC",
         padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None) -> torch.Tensor:
    """NHWC or NCHW convolution with reference-centered windows, or with
    JAX's explicit ``padding`` ((lo, hi) along H, then along W), which a
    rank's tile of rows takes under spatial partitioning."""
    if engine == "pallas":
        if layout == "NCHW":
            xh = x.permute(0, 2, 3, 1).contiguous()
            y = _kconv.conv2d(xh, w.to(x.dtype), stride, padding)
            return y.permute(0, 3, 1, 2).contiguous()
        return _kconv.conv2d(x, w.to(x.dtype), stride, padding)
    return conv2d(x, w, stride=stride, layout=layout, padding=padding)


def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
       engine: str = "xla") -> torch.Tensor:
    """Final fully-connected layer (resnet.cu:1759)."""
    if engine == "pallas":
        y = _kmatmul.matmul(x, w.to(x.dtype))
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    return linear(x, w, b)
