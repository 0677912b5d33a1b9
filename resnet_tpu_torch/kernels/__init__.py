"""Hand-written CUDA kernels of the port, one module per Pallas kernel it
replaces (resnet_tpu.kernels): ``conv.conv2d``, ``fused.add_relu`` and
``matmul.matmul``. Each module holds the wrapper, its plain PyTorch version
and a launch counter ``LAUNCHES``; ``build`` compiles ``csrc/`` with nvcc
and loads it with ctypes on first use."""
