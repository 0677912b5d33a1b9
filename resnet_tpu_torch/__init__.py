"""resnet_tpu_torch: the PyTorch / CUDA port of resnet_tpu for one NVIDIA H100.

It mirrors resnet_tpu's module names and public layouts (NHWC activations,
HWIO conv weights, (in, out) FC weight, {"mean", "var"} BN state) and never
imports JAX. This slice serves ResNet eval forwards: ``export.export_inference``
freezes parameters into an ``nn.Module``, ``serve`` puts it behind HTTP, and
with ``ExecutionConfig(kernels="pallas", conv_kernels="pallas")`` every conv,
residual join and the FC run in the hand-written CUDA kernels of
``resnet_tpu_torch.kernels``.
"""

from .config import ExecutionConfig, ModelConfig, model_config, tiny_model_config

__all__ = ["ExecutionConfig", "ModelConfig", "model_config", "tiny_model_config"]
