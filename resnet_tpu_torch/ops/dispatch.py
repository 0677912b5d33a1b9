"""Engine dispatch: plain torch ops vs the hand kernels.

Same rules as resnet_tpu.ops.dispatch:

* ``residual_join``: ``engine='pallas'`` and no ``relu_cap`` -> the add_relu
  kernel;
* ``fc``: ``engine='pallas'`` -> the matmul kernel;
* ``conv``: ``engine='pallas'`` (ExecutionConfig.conv_kernels) -> the conv
  kernel;
* ``bn_act`` with batch statistics and ``engine='pallas'`` -> the moments
  kernel on the (N*H*W, C) view, then normalize and ReLU in plain ops
  (dispatch.py:58-74); in eval mode (given mean/var) it always runs the
  plain ops, as the JAX package sends it through XLA.

Otherwise plain torch ops run, which may use cuDNN or cuBLAS on the card,
as the JAX package runs them in XLA outside any Pallas kernel. Layout is
NHWC throughout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels import bn as _kbn, conv as _kconv, fused as _kfused, matmul as _kmatmul
from .activation import relu as _relu
from .batchnorm import batch_norm
from .conv import conv2d
from .linear import linear


def bn_act(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float,
    relu: bool,
    relu_cap: Optional[float] = None,
    engine: str = "xla",
    mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BN, with batch statistics unless mean and var are given, then ReLU
    (capped if relu_cap). Returns (y, (mean, var))."""
    if engine == "pallas" and mean is None and var is None:
        # one-read statistics kernel; the normalization stays in torch ops
        mean, var = _kbn.moments(x.reshape(-1, x.shape[-1]))
    y, stats = batch_norm(x, gamma, beta, eps=eps, mean=mean, var=var)
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
         engine: str = "xla") -> torch.Tensor:
    """NHWC convolution with reference-centered windows."""
    if engine == "pallas":
        return _kconv.conv2d(x, w.to(x.dtype), stride)
    return conv2d(x, w, stride=stride)


def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
       engine: str = "xla") -> torch.Tensor:
    """Final fully-connected layer (resnet.cu:1759)."""
    if engine == "pallas":
        y = _kmatmul.matmul(x, w.to(x.dtype))
        if b is not None:
            y = y + b.to(y.dtype)
        return y
    return linear(x, w, b)
