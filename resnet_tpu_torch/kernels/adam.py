"""Guarded Adam over a list of tensors in one launch: the port of
resnet_tpu.kernels.adam.fused_adam_flat.

``fused_adam`` updates every (p, m, v) IN PLACE from its gradient g, with
the arithmetic of adam.py:38-53 and the hyper row
h = [lr, wd, b1, b2, eps, b1^t, b2^t, guard] (``hyper_row``). On CUDA tensors
it launches ``rt_adam_f32`` (``csrc/adam.cu``) once over a small device table
of (p, g, m, v, numel, first block) rows, instead of raveling the tensors
into flat copies as the JAX package does; anything the kernel does not take
raises. On CPU tensors the plain version ``adam_leaf_reference`` runs per
tensor; it is also the per-tensor ``optim.adam.adam_update``.

Update only after the backward has finished: the tensors are overwritten.

``LAUNCHES`` counts launches of the kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import build

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
_CHUNK = 4096  # csrc/adam.cu CHUNK: elements per block


def hyper_row(lr, weight_decay, beta1, beta2, eps, cur_mean_decay, cur_var_decay,
              nonfinite_guard, device) -> torch.Tensor:
    """The 8 fp32 hypers; lr and the decay products may be device scalars."""
    f32 = torch.float32

    def scalar(v):
        return torch.as_tensor(v, dtype=f32).to(device).reshape(1)

    consts = torch.tensor([weight_decay, beta1, beta2, eps,
                           1.0 if nonfinite_guard else 0.0], dtype=f32).to(device)
    return torch.cat([scalar(lr), consts[:4], scalar(cur_mean_decay),
                      scalar(cur_var_decay), consts[4:]])


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


def fused_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               means: Sequence[torch.Tensor], vars_: Sequence[torch.Tensor],
               h: torch.Tensor) -> None:
    """One guarded Adam step over every tensor, in place on params, means
    and vars_. All fp32 and contiguous, on one device; h from ``hyper_row``."""
    global LAUNCHES
    if not (len(params) == len(grads) == len(means) == len(vars_)):
        raise ValueError("fused_adam: lists of different lengths")
    for p, g, m, v in zip(params, grads, means, vars_):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"fused_adam: shapes {tuple(p.shape)}, {tuple(g.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
    if h.shape != (8,):
        raise ValueError(f"fused_adam: hyper row of shape {tuple(h.shape)}")
    tensors = [*params, *grads, *means, *vars_, h]
    if not build.on_card("adam", *tensors):
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, means, vars_):
                new_p, new_m, new_v = adam_leaf_reference(p, g, m, v, h)
                p.copy_(new_p)
                m.copy_(new_m)
                v.copy_(new_v)
        return
    rows, first = [], 0
    for p, g, m, v in zip(params, grads, means, vars_):
        if p.numel():
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         p.numel(), first])
            first += -(-p.numel() // _CHUNK)
    if not rows:
        return
    if first >= 2**31:
        raise ValueError("fused_adam: too many elements for the kernel's grid")
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        h.device, non_blocking=True)
    build.launch("rt_adam_f32", table.data_ptr(), len(rows), first, h.data_ptr(),
                 device=h.device)
    LAUNCHES += 1
