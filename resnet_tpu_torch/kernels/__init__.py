"""Hand-written CUDA kernels of the port, one module per Pallas kernel module
it replaces (resnet_tpu.kernels): ``conv.conv2d`` (with its dx and dW),
``fused.add_relu`` (with its mask backward) and ``fused.bias_act``,
``matmul.matmul`` (with its VJP), ``bn.moments``, ``bn.bn_apply`` and
``bn.batch_norm_act`` (with its backward), ``fused_conv.fused_conv`` and
``fused_conv.fused_join`` (the fused engine), ``block_fused.block_fused``
(the whole-block engine), ``adam.fused_adam``, and ``quant.qconv`` and
``quant.quant_act`` (the int8 serving kernels, which replace XLA ops of
resnet_tpu/quantize.py, no Pallas kernel). Each
module holds the wrappers, their plain PyTorch versions and launch counters
(``LAUNCHES`` and, for the other kernels of a module, ``DX_LAUNCHES``,
``DW_LAUNCHES``, ``MASK_LAUNCHES``, ``BWD_LAUNCHES``, ``APPLY_LAUNCHES``,
``JOIN_LAUNCHES``, ``ACT_LAUNCHES``; the map is ``checks.KERNELS``); ``build`` compiles
``csrc/`` with nvcc and loads it with ctypes on first use. ``ops`` holds the
forward entries a served forward reaches (K1, K2, K3, Q1 to Q3) as
``torch.library`` custom ops; importing this package registers their
implementations, so that a program exported with them runs."""

from . import conv, fused, matmul, quant  # noqa: F401  (each registers its op)
