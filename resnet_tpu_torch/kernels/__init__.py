"""Hand-written CUDA kernels of the port, one module per Pallas kernel module
it replaces (resnet_tpu.kernels): ``conv.conv2d`` (with its dx and dW),
``fused.add_relu`` (with its mask backward) and ``fused.bias_act``,
``matmul.matmul`` (with its VJP), ``bn.moments``, ``bn.bn_apply`` and
``bn.batch_norm_act`` (with its backward), ``fused_conv.fused_conv`` and
``fused_conv.fused_join`` (the fused engine), ``block_fused.block_fused``
(the whole-block engine) and ``adam.fused_adam``. Each
module holds the wrappers, their plain PyTorch versions and launch counters
(``LAUNCHES`` and, for the other kernels of a module, ``DX_LAUNCHES``,
``DW_LAUNCHES``, ``MASK_LAUNCHES``, ``BWD_LAUNCHES``, ``APPLY_LAUNCHES``,
``JOIN_LAUNCHES``; the map is ``checks.KERNELS``); ``build`` compiles
``csrc/`` with nvcc and loads it with ctypes on first use."""
