from .init import init_bn_state, init_params
from .resnet import forward, predict

__all__ = ["init_params", "init_bn_state", "forward", "predict"]
