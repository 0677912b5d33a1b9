"""Plain PyTorch ops of the port, one module per resnet_tpu.ops module.
Engine selection (plain ops vs hand kernels) lives in ``ops.dispatch``."""

from .activation import relu, relu_cap
from .batchnorm import batch_norm, batch_norm_inference
from .conv import conv2d
from .linear import linear
from .padding import reference_padding
from .pooling import global_avg_pool, max_pool
from .softmax import log_softmax, softmax

__all__ = [
    "relu",
    "relu_cap",
    "batch_norm",
    "batch_norm_inference",
    "conv2d",
    "linear",
    "reference_padding",
    "global_avg_pool",
    "max_pool",
    "log_softmax",
    "softmax",
]
