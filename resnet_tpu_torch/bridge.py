"""Move parameter and BN-state trees between the JAX package and the port.

The JAX package keeps parameters and BN running statistics as pytrees of
nested dicts and lists (``resnet_tpu.models.init``); the port keeps the
same nesting with torch tensors at the leaves, in the same layouts (HWIO
conv weights, ``(in, out)`` FC weight, ``{"mean", "var"}`` per BN layer).
JAX's PRNG cannot be reproduced in torch, so parity tests and serving of a
model trained in JAX take the JAX tree through here.

``train_state_from_numpy`` and ``to_numpy`` carry a whole training state
(parameters, Adam or SGD state, BN running statistics, step) both ways, so
the two packages can start from one state. ``load_jax_npz`` reads a checkpoint written by
``resnet_tpu.train.checkpoint.save_npz`` with numpy alone: its keys are
``/``-joined pytree paths such as ``params/blocks/3/proj/w``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of arrays -> the same nesting of torch tensors of
    the same dtype on ``device`` (the card unless the caller asks for the
    CPU). A bfloat16 array (JAX's, an ml_dtypes type numpy knows by name
    only) becomes a bfloat16 tensor of the same bits."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


# BN state has the same nested-dict/list shape as the parameters.
bn_state_from_numpy = params_from_numpy


def to_numpy(tree):
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the host
    (a bfloat16 tensor as float32, which holds it exactly). A NamedTuple (a
    TrainState, an optimizer state) keeps its type."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    if tree.dtype is torch.bfloat16:
        tree = tree.float()
    return tree.detach().cpu().numpy()


def tree_map(fn, tree, *rest):
    """fn over the leaves of one or more trees of the same nested dicts and
    lists; the result has the first tree's nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves(tree) -> List[Any]:
    """The leaves in JAX's pytree order: ``flatten``'s without building the
    paths, which cost the fused Adam step about 1 ms of host time per
    call over ResNet-50's four trees (``kernels/host_parts.py``)."""
    out: List[Any] = []
    _collect(tree, out.append)
    return out


def leaves_of(*trees) -> List[List[Any]]:
    """The leaves of trees of one nesting, each list in JAX's pytree order,
    from one walk over all of them (the keys of each dict sorted once);
    raises where a dict or list of the first tree is not matched in the
    others. Where the first tree holds a leaf, the others' values there are
    taken as leaves."""
    outs: List[List[Any]] = [[] for _ in trees]
    _collect_all(trees, outs)
    return outs


def _collect_all(nodes, outs) -> None:
    first = nodes[0]
    if isinstance(first, dict):
        for n in nodes:
            if not isinstance(n, dict) or len(n) != len(first):
                raise ValueError("leaves_of: trees of different nesting")
        for k in sorted(first):
            _collect_all([n[k] for n in nodes], outs)
    elif isinstance(first, (list, tuple)):
        for n in nodes:
            if not isinstance(n, (list, tuple)) or len(n) != len(first):
                raise ValueError("leaves_of: trees of different nesting")
        for children in zip(*nodes):
            _collect_all(children, outs)
    else:
        for out, n in zip(outs, nodes):
            out.append(n)


def _collect(tree, put) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], put)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _collect(v, put)
    else:
        put(tree)


def train_state_from_numpy(state, device="cuda"):
    """The port's TrainState from one whose leaves are numpy arrays: the
    JAX package's TrainState mapped to numpy, or ``to_numpy`` of the port's.
    The optimizer state is read by field name (``means``/``vars`` for Adam,
    ``momentum_buf`` for SGD). The state lands on the card unless the caller
    asks for the CPU: ``train_step`` runs wherever ``state.step`` lies."""
    from .optim import GuardedAdamState, SGDState
    from .train import TrainState

    opt = state.opt_state
    if hasattr(opt, "means"):
        opt = GuardedAdamState(
            means=params_from_numpy(opt.means, device),
            vars=params_from_numpy(opt.vars, device),
            mean_decay_prod=params_from_numpy(opt.mean_decay_prod, device),
            var_decay_prod=params_from_numpy(opt.var_decay_prod, device),
            step=params_from_numpy(opt.step, device))
    elif hasattr(opt, "momentum_buf"):
        opt = SGDState(momentum_buf=params_from_numpy(opt.momentum_buf, device),
                       step=params_from_numpy(opt.step, device))
    else:
        raise ValueError(f"unknown optimizer state {type(opt).__name__}")
    return TrainState(params=params_from_numpy(state.params, device), opt_state=opt,
                      bn_state=params_from_numpy(state.bn_state, device),
                      step=params_from_numpy(state.step, device))


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


def qparams_from_numpy(qparams, scales, device="cuda"):
    """The JAX package's W8A8 model (``resnet_tpu.quantize.quantize_model``'s
    (qparams, scales), as numpy arrays) for the port: the tree as tensors of
    the same dtypes (``wq`` int8, ``ws`` and ``b`` fp32) on ``device``, and
    the scales as Python floats holding their fp32 values exactly."""
    return (params_from_numpy(qparams, device),
            {k: float(np.float32(v)) for k, v in scales.items()})
