"""Runtime state checking: the port of resnet_tpu.utils.debug, the
counterpart of the reference's check_errors (resnet.cu:2879-2907), which
scans every param/grad/m/v tensor for NaN/Inf; on a hit the trainer dumps
the state to sentinel id 99999999 and aborts.

``check_state_finite`` is one device reduction per floating leaf, stacked
into a single bool tensor that stays on the device until the caller reads
it; ``nonfinite_report`` is the host-side listing made after a trip, with
the JAX package's path names (dict keys and list indices joined by ``/``,
a NamedTuple field as ``.name``).
"""

from __future__ import annotations

import os
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

# gate for debug_print_tensor, the TO_PRINT compile-time flag of the
# reference (resnet.cu:27); enable with RESNET_TPU_DEBUG_PRINT=1
DEBUG_PRINT = os.environ.get("RESNET_TPU_DEBUG_PRINT", "") not in ("", "0")


def debug_print_tensor(name: str, x: torch.Tensor, n: int = 8) -> None:
    """Tensor tracer (printDeviceData, resnet.cu:1511): prints shape, range
    and the first n elements. A no-op unless RESNET_TPU_DEBUG_PRINT is set,
    so call sites can stay in the code; when on, it waits for the device."""
    if not DEBUG_PRINT:
        return
    flat = x.detach().reshape(-1)
    print(f"{name} shape={tuple(x.shape)} min={flat.min().item()} "
          f"max={flat.max().item()} head={flat[:min(n, flat.numel())].tolist()}")


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in the JAX package's pytree order and naming."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), f"{prefix}/.{name}" if prefix else f".{name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _floating(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def check_state_finite(tree) -> torch.Tensor:
    """A bool tensor, True iff every floating leaf is finite everywhere; on
    the leaves' device, not read back."""
    leaves = [torch.as_tensor(leaf) for _, leaf in _paths(tree) if _floating(leaf)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def nonfinite_report(tree) -> List[str]:
    """Host-side listing of the leaves holding NaN or Inf (the post-mortem
    path): "path: n NaN, m Inf of size"."""
    bad = []
    for name, leaf in _paths(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        n_nan, n_inf = int(np.isnan(arr).sum()), int(np.isinf(arr).sum())
        if n_nan or n_inf:
            bad.append(f"{name}: {n_nan} NaN, {n_inf} Inf of {arr.size}")
    return bad
