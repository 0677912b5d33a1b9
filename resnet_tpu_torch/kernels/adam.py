"""Guarded Adam over a list of tensors in one launch: the port of
resnet_tpu.kernels.adam.fused_adam_flat.

``fused_adam`` updates every (p, m, v) IN PLACE from its gradient g, with
the arithmetic of adam.py:38-53 and the hyper row
h = [lr, wd, b1, b2, eps, b1^t, b2^t, guard] (``hyper_row``). On CUDA tensors
it launches ``rt_adam_f32`` (``csrc/adam.cu``) over a table of
(p, g, m, v, numel, first block, 16-byte flag) rows passed in the kernel's
parameters, once per group of ``MAX_ROWS`` rows, instead of raveling the
tensors into flat copies as the JAX package does; anything the kernel does
not take raises. p, m and v keep their storage from step to step, so their
rows and checks are made once and cached (``_state_plan``), keyed by the
tensors' data pointers: a replaced tensor or a moved storage makes them
anew. Each call checks only the gradients and hands their
pointers to the C entry point; nothing is allocated or copied to the card.
On CPU tensors the plain version ``adam_leaf_reference`` runs per tensor;
it is also the per-tensor ``optim.adam.adam_update``.

Update only after the backward has finished: the tensors are overwritten.

``LAUNCHES`` counts wrapper calls that launched the kernel (one per call,
however many groups of rows it launches).
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import List, NamedTuple, Sequence, Tuple

import torch

from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
_CHUNK = 4096  # csrc/adam.cu CHUNK: elements per block
MAX_ROWS = 256  # csrc/adam.cu MAX_ROWS: rows in one launch's parameters
_COLS = 7  # csrc/adam.cu COLS: p, m, v, numel, first block, flag, tensor
_MAX_PLANS = 4  # cached state plans (one per optimizer state in use)
_shape = operator.attrgetter("shape")
_dtype = operator.attrgetter("dtype")


@functools.lru_cache(maxsize=64)
def _device_row(device, values: Tuple[float, ...]) -> torch.Tensor:
    """fp32 ``values`` on ``device``, copied there once per (device, values)."""
    return torch.tensor(values, dtype=torch.float32).to(device)


def _to_device(values, device) -> torch.Tensor:
    """fp32 ``values`` on ``device`` without a pageable copy: from pinned
    memory, not waiting for the copy, where the device is a card."""
    on_card = torch.device(device).type == "cuda"
    host = torch.tensor(values, dtype=torch.float32, pin_memory=on_card)
    return host.to(device, non_blocking=True)


def hyper_row(lr, weight_decay, beta1, beta2, eps, cur_mean_decay, cur_var_decay,
              nonfinite_guard, device) -> torch.Tensor:
    """The 8 fp32 hypers; lr and the decay products may be device scalars.

    No call waits on a pageable host-to-device copy: the constant hypers
    (wd, b1, b2, eps, guard) are copied to the device once per (device,
    values); lr and the decay products, where they are device scalars,
    join them in one ``torch.cat``; where all three are Python numbers the
    row goes over in one copy from pinned memory."""
    f32 = torch.float32
    steps = (lr, cur_mean_decay, cur_var_decay)
    guard = 1.0 if nonfinite_guard else 0.0
    if not any(isinstance(v, torch.Tensor) for v in steps):
        return _to_device([lr, weight_decay, beta1, beta2, eps, cur_mean_decay,
                           cur_var_decay, guard], device)
    consts = _device_row(device, (float(weight_decay), float(beta1), float(beta2),
                                  float(eps), guard))
    lr_t, cmd_t, cvd_t = (v.to(device=device, dtype=f32).reshape(1)
                          if isinstance(v, torch.Tensor) else _to_device([v], device)
                          for v in steps)
    return torch.cat([lr_t, consts[:4], cmd_t, cvd_t, consts[4:]])


def adam_leaf_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        v: torch.Tensor, h: torch.Tensor, wd_mask=1.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain guarded Adam for one tensor; returns new (p, m, v) in fp32.
    ``wd_mask`` multiplies the weight decay (0 exempts the tensor)."""
    lr, wd, b1, b2, eps, cmd, cvd, guard = h.unbind()
    pf = p.to(torch.float32)
    gf = g.to(torch.float32)
    wdm = wd * wd_mask
    g_wd = gf + wdm * pf
    new_m = b1 * m + (1 - b1) * g_wd
    new_v = b2 * v + (1 - b2) * torch.square(g_wd)
    keep = torch.logical_and(guard > 0, ~torch.isfinite(gf))
    new_m = torch.where(keep, m, new_m)
    new_v = torch.where(keep, v, new_v)
    m_adj = new_m / (1 - cmd)
    v_adj = new_v / (1 - cvd)
    new_p = pf - (lr * m_adj / (torch.sqrt(v_adj) + eps) + wdm * pf)
    new_p = torch.where(torch.logical_and(guard > 0, ~torch.isfinite(new_p)), pf, new_p)
    return new_p, new_m, new_v


def pack_rows(numels: Sequence[int], aligned: Sequence[bool]
              ) -> List[Tuple[int, int, int, int]]:
    """(tensor index, numel, first block, flag) per tensor with elements, in
    order. Rows go to the kernel in groups of ``MAX_ROWS``, one launch each,
    so a row's first block counts from the start of its group. The flag is
    1 where the tensor's p, m and v are 16-byte aligned (``aligned``) and
    numel % 4 == 0; the C entry point clears it where the gradient is not
    aligned too. A tensor without elements gets no row."""
    rows, first = [], 0
    for i, (n, a) in enumerate(zip(numels, aligned, strict=True)):
        if n == 0:
            continue
        if len(rows) % MAX_ROWS == 0:
            first = 0
        rows.append((i, n, first, int(a and n % 4 == 0)))
        first += -(-n // _CHUNK)
        if first >= 2**31:
            raise ValueError("fused_adam: too many elements for the kernel's grid")
    return rows


class _StatePlan(NamedTuple):
    """The cached part of a call: the state's device, its tensors' data
    pointers (the cache key), the parameters' shapes, the host table of
    rows for the C entry point, and the host array the gradients' pointers
    go into."""
    index: int
    ptrs: List[int]
    shapes: Tuple[torch.Size, ...]
    table: ctypes.Array
    n_rows: int
    grads: ctypes.Array


# the state plans in use, the latest first
_PLANS: List[_StatePlan] = []


def _state_plan(params, means, vars_, index: int, ptrs=None) -> _StatePlan:
    """The rows of (p, m, v), made and checked once while the tensors keep
    their storage: the cache is keyed by their data pointers (``ptrs``,
    read here when not given), compared as lists. A replaced tensor or a
    moved storage has another pointer and makes the rows anew; a tensor put
    where another was, with the same shape, has the same row."""
    tensors = (*params, *means, *vars_)
    if ptrs is None:
        ptrs = list(map(torch.Tensor.data_ptr, tensors))
    for plan in _PLANS:
        if plan.ptrs == ptrs and plan.index == index:
            return plan
    for t in tensors:
        if t.dtype is not torch.float32:
            raise TypeError(f"fused_adam: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused_adam: expected contiguous tensors")
        if t.get_device() != index:
            raise ValueError(f"fused_adam: a tensor on {t.device}, the hyper row on "
                             f"cuda:{index}")
    for p, m, v in zip(params, means, vars_):
        if not (p.shape == m.shape == v.shape):
            raise ValueError(f"fused_adam: shapes {tuple(p.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)}")
    rows = pack_rows([p.numel() for p in params],
                     [p.data_ptr() % 16 == m.data_ptr() % 16 == v.data_ptr() % 16 == 0
                      for p, m, v in zip(params, means, vars_)])
    cells = [c for i, n, first, flag in rows
             for c in (params[i].data_ptr(), means[i].data_ptr(), vars_[i].data_ptr(), n,
                       first, flag, i)]
    plan = _StatePlan(index, ptrs, tuple(map(_shape, params)),
                      (ctypes.c_int64 * len(cells))(*cells), len(rows),
                      (ctypes.c_int64 * len(params))())
    _PLANS.insert(0, plan)
    del _PLANS[_MAX_PLANS:]
    return plan


def _grad_pointers(grads, plan: _StatePlan, ptrs=None) -> ctypes.Array:
    """The gradients' pointers (``ptrs``, read here when not given) in the
    plan's host array, after the checks the kernel needs: the parameters'
    shapes, float32, contiguous, on the state's device. The array is the
    plan's own, overwritten by the next call."""
    if tuple(map(_shape, grads)) != plan.shapes:
        for g, shape in zip(grads, plan.shapes):
            if g.shape != shape:
                raise ValueError(f"fused_adam: gradient of shape {tuple(g.shape)} for a "
                                 f"parameter of shape {tuple(shape)}")
    if any(d is not torch.float32 for d in set(map(_dtype, grads))):
        raise TypeError(f"fused_adam: expected float32 gradients, got "
                        f"{set(map(_dtype, grads))}")
    if not all(map(torch.Tensor.is_contiguous, grads)):
        raise ValueError("fused_adam: expected contiguous tensors")
    if set(map(torch.Tensor.get_device, grads)) - {plan.index}:
        raise ValueError(f"fused_adam: gradients not all on cuda:{plan.index}")
    plan.grads[:] = list(map(torch.Tensor.data_ptr, grads)) if ptrs is None else ptrs
    return plan.grads


def _launch(plan: _StatePlan, grads: ctypes.Array, h: torch.Tensor) -> None:
    stream = torch._C._cuda_getCurrentRawStream(plan.index)
    build.launch_on(plan.index, stream, build.entry("rt_adam_f32"),
                    ctypes.addressof(plan.table), plan.n_rows, ctypes.addressof(grads),
                    h.data_ptr())


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               means: Sequence[torch.Tensor], vars_: Sequence[torch.Tensor],
               h: torch.Tensor) -> None:
    """One guarded Adam step over every tensor, in place on params, means
    and vars_. All fp32 and contiguous, on one device; h from ``hyper_row``."""
    global LAUNCHES
    if not (len(params) == len(grads) == len(means) == len(vars_)):
        raise ValueError("fused_adam: lists of different lengths")
    if h.shape != (8,):
        raise ValueError(f"fused_adam: hyper row of shape {tuple(h.shape)}")
    if not h.is_cuda:
        for p, g, m, v in zip(params, grads, means, vars_):
            if not (p.shape == g.shape == m.shape == v.shape):
                raise ValueError(f"fused_adam: shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                                 f"{tuple(m.shape)}, {tuple(v.shape)}")
        build.on_card("adam", *params, *grads, *means, *vars_, h, bf16=False)  # raises on a CUDA tensor
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, means, vars_):
                new_p, new_m, new_v = adam_leaf_reference(p, g, m, v, h)
                p.copy_(new_p)
                m.copy_(new_m)
                v.copy_(new_v)
        return
    if h.dtype is not torch.float32 or not h.is_contiguous():
        raise ValueError(f"fused_adam: hyper row of {h.dtype}, expected contiguous float32")
    # every data pointer in one pass: (p, m, v) key the cached plan
    ptrs = list(map(torch.Tensor.data_ptr, (*params, *means, *vars_, *grads)))
    n = 3 * len(params)
    plan = _state_plan(params, means, vars_, h.get_device(), ptrs[:n])
    pointers = _grad_pointers(grads, plan, ptrs[n:])
    if plan.n_rows:
        _launch(plan, pointers, h)
        LAUNCHES += 1
