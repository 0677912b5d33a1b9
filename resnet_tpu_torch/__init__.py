"""resnet_tpu_torch: the PyTorch / CUDA port of resnet_tpu for one NVIDIA H100.

It mirrors resnet_tpu's module names and public layouts (NHWC activations,
HWIO conv weights, (in, out) FC weight, {"mean", "var"} BN state) and never
imports JAX. It serves ResNet eval forwards (``export.export_inference``
freezes parameters into an ``nn.Module``, ``export.save_inference`` writes it
as a self-contained ``torch.export`` artifact, ``artifact.load_inference``
runs that without the model code and ``serve`` puts it behind HTTP) and
trains (``train.init_train_state``, ``train.make_train_step``; from the
reference's shards with ``train.Trainer`` and ``python -m
resnet_tpu_torch.train.cli``, dumps in the reference's schema). With
``ExecutionConfig(kernels="pallas", conv_kernels="pallas")`` every conv and
its two gradients, the BN statistics, the residual join and its backward,
and the FC and its backward run in the hand-written CUDA kernels of
``resnet_tpu_torch.kernels``; ``OptimizerConfig(fused=True)`` adds the
one-launch Adam kernel. ``tools`` holds the convergence and soak drivers.
"""

from .config import ExecutionConfig, ModelConfig, model_config, tiny_model_config

__all__ = ["ExecutionConfig", "ModelConfig", "model_config", "tiny_model_config"]
