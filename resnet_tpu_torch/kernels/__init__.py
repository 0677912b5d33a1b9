"""Hand-written CUDA kernels of the port, one module per Pallas kernel module
it replaces (resnet_tpu.kernels): ``conv.conv2d`` (with its dx and dW),
``fused.add_relu`` (with its mask backward), ``matmul.matmul`` (with its
VJP), ``bn.moments`` and ``adam.fused_adam``. Each module holds the
wrappers, their plain PyTorch versions and launch counters (``LAUNCHES``
and, for backward kernels, ``DX_LAUNCHES``, ``DW_LAUNCHES``,
``MASK_LAUNCHES``, ``BWD_LAUNCHES``); ``build`` compiles ``csrc/`` with nvcc
and loads it with ctypes on first use."""
