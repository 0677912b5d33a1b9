"""Move parameter and BN-state trees between the JAX package and the port.

The JAX package keeps parameters and BN running statistics as pytrees of
nested dicts and lists (``resnet_tpu.models.init``); the port keeps the
same nesting with torch tensors at the leaves, in the same layouts (HWIO
conv weights, ``(in, out)`` FC weight, ``{"mean", "var"}`` per BN layer).
JAX's PRNG cannot be reproduced in torch, so parity tests and serving of a
model trained in JAX take the JAX tree through here.

``load_jax_npz`` reads a checkpoint written by
``resnet_tpu.train.checkpoint.save_npz`` with numpy alone: its keys are
``/``-joined pytree paths such as ``params/blocks/3/proj/w``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of arrays -> the same nesting of torch tensors of
    the same dtype on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


# BN state has the same nested-dict/list shape as the parameters.
bn_state_from_numpy = params_from_numpy


def to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs with ``/``-joined paths, in JAX's pytree order
    (dict keys sorted, lists in index order)."""
    if isinstance(tree, dict):
        items: Iterable = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(pairs: Iterable[Tuple[str, Any]]):
    """Rebuild nested dicts/lists from ``/``-joined paths; a level whose
    keys are all integers becomes a list."""
    root: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"list indices {idx} are not 0..{len(idx) - 1}")
        return [_lists(node[str(i)]) for i in idx]
    return {k: _lists(v) for k, v in node.items()}


def load_jax_npz(path: str):
    """(params, bn_state) as numpy trees from a JAX ``save_npz`` checkpoint.

    bn_state is None when the checkpoint carries no running statistics."""
    trees: Dict[str, list] = {"params": [], "bn_state": []}
    with np.load(path) as data:
        for key in data.files:
            head, _, rest = key.partition("/")
            if head in trees and rest:
                trees[head].append((rest, np.asarray(data[key])))
    if not trees["params"]:
        raise ValueError(f"{path} holds no 'params/...' arrays")
    params = unflatten(trees["params"])
    bn_state = unflatten(trees["bn_state"]) if trees["bn_state"] else None
    return params, bn_state
