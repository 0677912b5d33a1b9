"""``ExecutionConfig.matmul_precision`` applied to the plain convs and matmuls.

The JAX package passes the precision to every plain conv and to the FC
(resnet_tpu/models/resnet.py:57, :61, :291, :313, :387). On the card the
port's plain convs are cuDNN and its plain products cuBLAS, whose fp32
arithmetic follows two global flags instead:
``torch.backends.cudnn.allow_tf32`` (True out of the box) and
``torch.backends.cuda.matmul.allow_tf32``. ``precision_scope`` sets both from
the config for the length of an entry point and puts the caller's values
back after: ``'highest'`` turns TF32 off (true fp32, as JAX's HIGHEST), and
``'high'`` and ``'default'`` allow it. The hand kernels do not read the flags:
they are fp32-accurate under every setting.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..config import ExecutionConfig


def allows_tf32(ecfg: Optional[ExecutionConfig]) -> bool:
    """Whether the config lets cuDNN and cuBLAS run fp32 in TF32."""
    return (ecfg or ExecutionConfig()).matmul_precision != "highest"


@contextlib.contextmanager
def precision_scope(ecfg: Optional[ExecutionConfig]) -> Iterator[None]:
    """Both TF32 flags from ``ecfg.matmul_precision`` inside, the caller's
    values after. The flags are process-wide, so autograd's device threads
    see them too: a backward run inside the scope is covered."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    allow = allows_tf32(ecfg)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
