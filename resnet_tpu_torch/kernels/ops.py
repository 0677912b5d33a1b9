"""The served hand kernels as ``torch.library`` custom ops, so that
``torch.export`` can trace a served forward into a program that calls them.

Five ops in the ``resnet_tpu_torch`` namespace, one for each forward entry
that a served forward (``export.InferenceModel``,
``export.QuantizedInferenceModel``) reaches:

    conv2d_nhwc(x, w, stride, padding?)        K1   kernels.conv
    add_relu(a, b)                             K2   kernels.fused
    matmul(a, b)                               K3   kernels.matmul
    quant_act(x, inv)                          Q2   kernels.quant
    qconv(xq, w, dq, bias?, wk?, stride, groups, relu, cap?, out_dtype)
                                               Q1, or Q3 for groups > 1

``conv2d_nhwc``'s ``padding`` is JAX's explicit padding as [lo, hi, lo_w,
hi_w], which a rank's tile of rows takes under spatial partitioning; None
(the default) is the reference's centred windows, so that a program saved
before the argument existed loads and runs as it did.

Each op has three implementations, picked by the dispatcher from the
inputs' dispatch key:

* CUDA: the kernel module's launch function (``conv._forward``,
  ``fused._forward``, ``matmul._forward``, ``quant._quant_act``,
  ``quant._qconv``), which counts its launches (``build.count`` or the
  module's counters) and raises on anything its kernel does not take;
* CPU: the kernel's plain version (``conv2d_reference``,
  ``add_relu_reference``, ``matmul_reference``, ``quant_act_reference``,
  ``qconv_reference``) after the same input checks;
* fake (``torch.library.register_fake``): the output's shape and dtype from
  the inputs', with the batch left symbolic; it also stands for the Meta
  key, where it raises as the kernels do for a device other than CPU or
  CUDA.

The ops are defined here; each kernel module registers its own CPU and
CUDA implementations with ``implement`` when it is imported, and importing
``resnet_tpu_torch.kernels`` imports all four. A wrapper calls what
``implement`` returns: the op while ``torch.export`` traces (the program
then calls the op, and the dispatcher picks the implementation by the
dispatch key), and in eager mode the same implementation function, picked
by the first input's device, without the dispatcher's host cost. The ops
do not differentiate: the autograd Functions of ``conv``, ``fused`` and
``matmul`` call them in their forward and keep their own backward.
"""

from __future__ import annotations

import torch

NAMESPACE = "resnet_tpu_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
SCHEMAS = {
    "conv2d_nhwc": "conv2d_nhwc(Tensor x, Tensor w, int stride, int[]? padding=None) -> Tensor",
    "add_relu": "add_relu(Tensor a, Tensor b) -> Tensor",
    "matmul": "matmul(Tensor a, Tensor b) -> Tensor",
    "quant_act": "quant_act(Tensor x, float inv) -> Tensor",
    "qconv": ("qconv(Tensor xq, Tensor w, Tensor dq, Tensor? bias, Tensor? wk, int stride, "
              "int groups, bool relu, float? cap, ScalarType out_dtype) -> Tensor"),
}
for _schema in SCHEMAS.values():
    LIB.define(_schema)

_ops = getattr(torch.ops, NAMESPACE)
conv2d_nhwc = _ops.conv2d_nhwc.default
add_relu = _ops.add_relu.default
matmul = _ops.matmul.default
quant_act = _ops.quant_act.default
qconv = _ops.qconv.default


def implement(name: str, *, cpu, cuda):
    """Register op ``name``'s CPU and CUDA implementations, and return what
    the kernel's wrapper calls: the op itself while a tracer records the
    call (``torch.export``, or any tracer that hands the code fake
    tensors), so the program holds the op; else the implementation for the
    first input's device, the one the dispatcher would pick, called
    directly: the dispatcher's round trip costs an eager call ~2-20 us of
    host time on the card, 30-80% of a small kernel's whole call (PERF.md)."""
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    op = getattr(_ops, name).default

    def call(*args):
        first = args[0]
        if type(first) is not torch.Tensor or torch.compiler.is_exporting():
            return op(*args)
        return (cuda if first.is_cuda else cpu)(*args)

    return call


def _devices(name: str, *tensors) -> None:
    """The kernels' device rule, for the fake implementations: one device,
    CPU or CUDA (a fake tensor carries the device it stands for, so only a
    real Meta tensor fails here)."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")


@torch.library.register_fake(f"{NAMESPACE}::conv2d_nhwc")
def _conv2d_nhwc_fake(x, w, stride, padding=None):
    _devices("conv2d", x, w)
    n, h, wd, _ = x.shape
    if padding is None:
        return x.new_empty((n, h // stride, wd // stride, w.shape[3]))
    k = w.shape[0]
    lo, hi, lo_w, hi_w = padding
    return x.new_empty((n, (h + lo + hi - k) // stride + 1, (wd + lo_w + hi_w - k) // stride + 1,
                        w.shape[3]))


@torch.library.register_fake(f"{NAMESPACE}::add_relu")
def _add_relu_fake(a, b):
    _devices("add_relu", a, b)
    return torch.empty_like(a)


@torch.library.register_fake(f"{NAMESPACE}::matmul")
def _matmul_fake(a, b):
    _devices("matmul", a, b)
    return a.new_empty((a.shape[0], b.shape[1]))


@torch.library.register_fake(f"{NAMESPACE}::quant_act")
def _quant_act_fake(x, inv):
    _devices("quant_act", x)
    return torch.empty_like(x, dtype=torch.int8)


@torch.library.register_fake(f"{NAMESPACE}::qconv")
def _qconv_fake(xq, w, dq, bias, wk, stride, groups, relu, cap, out_dtype):
    _devices("qconv", xq, w, dq, bias, wk)
    n, h, wd, _ = xq.shape
    return xq.new_empty((n, h // stride, wd // stride, w.shape[3]), dtype=out_dtype)
