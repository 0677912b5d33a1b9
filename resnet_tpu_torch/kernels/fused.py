"""Residual join relu(a + b) and its backward: the port of
resnet_tpu.kernels.fused.add_relu.

``add_relu`` is a ``torch.autograd.Function`` whose forward is the custom op
``ops.add_relu`` (called directly where no gradient is recorded; its
implementations ``_forward`` on CUDA tensors and ``_forward_plain`` on CPU
ones, called directly in eager mode, ``ops.implement``). On a CUDA tensor its forward
launches ``rt_add_relu_f32`` and its backward ``rt_add_relu_mask_f32``
(``csrc/add_relu.cu``), the port of ``_add_relu_mask_kernel``:
g * [a + b > 0], strict >, the same gradient for both inputs (fused.py:80-83);
anything the kernels do not take raises. On a CPU tensor the plain versions
``add_relu_reference`` and ``add_relu_mask_reference`` run.

bf16 tensors take ``rt_add_relu_bf16`` and ``rt_add_relu_mask_bf16``:
a + b in fp32, one rounding to bf16 (fused.py:28-34); their plain versions
add in fp32 and cast once.

``LAUNCHES`` counts fp32 forward launches, ``MASK_LAUNCHES`` fp32 backward
ones, ``LAUNCHES_BF16`` and ``MASK_LAUNCHES_BF16`` the bf16 ones.

``bias_act(x, scale, shift, relu=True, cap=None)`` is the port of
resnet_tpu.kernels.fused.bias_act: clip(relu(x · scale + shift)) with (C,)
rows over the last dimension, x fp32 or bf16 (fp32 arithmetic, one
rounding to x's dtype). Its forward is K5 (``bn.bn_apply``, counted by
``bn.APPLY_LAUNCHES`` or ``bn.APPLY_LAUNCHES_BF16``) on the (rows, C) view;
its backward is torch ops, the formula of fused.py:104-117
(``bn.bn_apply_bwd``), as the JAX package has no kernel there either.
"""

from __future__ import annotations

import torch

from . import bn, build, ops

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
MASK_LAUNCHES = 0
LAUNCHES_BF16 = 0
MASK_LAUNCHES_BF16 = 0


def add_relu_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: max(a + b, 0) in fp32, NaN propagating, cast to a's
    dtype."""
    return torch.relu(a.float() + b.float()).to(a.dtype)


def add_relu_mask_reference(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor
                            ) -> torch.Tensor:
    """Plain backward: g where a + b > 0 (in fp32), else 0."""
    return torch.where(a.float() + b.float() > 0, g, torch.zeros_like(g))


def _forward_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.add_relu``'s CPU implementation: the plain version after the
    kernel's checks."""
    build.on_card("add_relu", a, b)
    return add_relu_reference(a, b)


def _forward(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.add_relu``'s CUDA implementation: one launch of K2."""
    if not build.on_card("add_relu", a, b):
        raise ValueError("add_relu: CPU tensors reached the CUDA implementation")
    out = torch.empty_like(a)
    if a.numel():
        build.launch(build.entry_name("add_relu", a), a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), a.numel(), device=a.device)
        build.count(__name__, "LAUNCHES", a)
    return out


_add_relu = ops.implement("add_relu", cpu=_forward_plain, cuda=_forward)


def add_relu_mask(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * [a + b > 0] for three contiguous tensors of one shape and dtype."""
    if a.shape != b.shape or a.shape != g.shape:
        raise ValueError(f"add_relu_mask: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(g.shape)}")
    if not build.on_card("add_relu_mask", a, b, g):
        return add_relu_mask_reference(a, b, g)
    out = torch.empty_like(g)
    if g.numel():
        build.launch(build.entry_name("add_relu_mask", g), a.data_ptr(), b.data_ptr(),
                     g.data_ptr(), out.data_ptr(), g.numel(), device=g.device)
        build.count(__name__, "MASK_LAUNCHES", g)
    return out


class _AddRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _add_relu(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if not any(ctx.needs_input_grad):
            return None, None
        d = add_relu_mask(a, b, g.contiguous())
        return d, d


def add_relu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(a + b) for two contiguous tensors of one shape and dtype (fp32
    or bf16); differentiable in both."""
    if a.shape != b.shape:
        raise ValueError(f"add_relu: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _AddRelu.apply(a, b)
    return _add_relu(a, b)  # no graph to record: skip the Function


class _BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, relu, cap):
        ctx.relu, ctx.cap = relu, cap
        ctx.save_for_backward(x, scale, shift)
        c = x.shape[-1]
        return bn.bn_apply(x.reshape(-1, c), scale, shift, relu=relu, cap=cap).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift = ctx.saved_tensors
        return (*bn.bn_apply_bwd(x, dy, scale, shift, relu=ctx.relu, cap=ctx.cap),
                None, None)


def bias_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool = True, cap=None) -> torch.Tensor:
    """clip(relu(x · scale + shift)), scale and shift (C,) over the last
    dimension of a contiguous fp32 or bf16 x, in x's dtype; differentiable
    in all three."""
    return _BiasAct.apply(x, scale, shift, relu, cap)
