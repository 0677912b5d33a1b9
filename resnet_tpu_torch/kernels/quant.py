"""The int8 (W8A8) serving kernels: Q1, the int8 conv with its dequantizing
epilogue, Q3, its grouped counterpart, and Q2, the activation quantization
(``csrc/qconv.cu``).

None has a Pallas counterpart: resnet_tpu/quantize.py leaves ``_qconv``
(:218), ``_qsite``'s dequantization (:243-247), the FC's product
(:279-287) and ``_quant_act`` (:213) to XLA. PyTorch has no int8
convolution on CUDA (``F.conv2d`` rejects int8), so the port runs them on
these hand kernels.

``quant_act(x, inv)`` (Q2): clip(round_half_even(f32(x) * inv), -127, 127)
as int8, x fp32 (the images) or bf16, ``inv`` the fp32 value of 1 / scale
(a Python float that fp32 holds exactly).

``qconv(xq, w, dq, bias, stride=, ...)`` (Q1): xq (N, H, W, Cin) int8, w
(kh, kw, Cin, Cout) int8 HWIO; the int32 conv over the reference's centred
windows (``ops.padding``), then ``f32(acc) * dq + bias`` rounded step by
step (``dq = ws * scale`` in fp32, as JAX orders it), then either bf16
(with ReLU and an optional cap on the bf16 value) or fp32 (the FC's
logits, ``out_dtype=torch.float32``). The kernel reads the weight as
``pack_weight`` lays it out: (Cout, Kp) K-major, each output channel's kh
kernel rows of kw * Cin bytes ((dj, ci) order) padded to a multiple of
``RUN`` bytes (so a 16-byte chunk of the kernel's A is one contiguous run
of x: the stem's 21-byte rows take 32), zero in the padding and from K = kh
* Rp up to Kp, a multiple of ``BK``; it reads A in the same K order,
``build.QC_SLICE`` bytes a step. Where Cin % 16 == 0 the rows need no
padding and K is the plain (di, dj, ci) order. A caller that serves many batches packs
the weight once (``quantize.prepare_sites``), passes it as ``wk`` and, as
``w``, its view ``unpack_weight(wk, (kh, kw, Cin))``, which only the plain
version reads. The kernel's tile width and K splits are
``build.qconv_plan``'s, a function of the shapes; split partials and
tile tickets come from the scratch that K4 and K6 keep per (device,
stream) (``bn._workspace``), whose tickets the kernel leaves zero.

``qconv(..., groups=g)`` with g > 1 (ResNeXt's 3x3s) launches Q3 instead
of Q1: the same sum per group (output channel o reads the input channels
of group o // (Cout / g)) and Q1's epilogue step for step. JAX's ``_qconv``
passes ``feature_group_count`` to XLA's conv (quantize.py:218-238);
PyTorch has no int8 conv on CUDA, so Q3 is a hand kernel too. It reads the
weight as ``pack_weight(w, g)`` lays it out: (kh * kw, Cout, Cgp), each
tap's and output channel's Cin / g bytes in a row of Cgp = Cin / g
rounded up to 4, zero past Cin / g (``unpack_weight`` views it as HWIO
again); each block of the kernel rebuilds its span of it once, in
fragment order. Bound by bytes at every ResNeXt site (x read once, the
bf16 output written once; the int8 products take ~2 us a batch-128 site
on the tensor cores), so Q3 runs ``mma.sync`` s8 on 8-column blocks
(whole groups packed block-diagonally where Cout / g < 8) from a halo
tile of x staged once in shared memory, two tiles in flight, and stores
its output as 16-byte row chunks. Its plan, ``build.q3_plan`` (column
blocks a span, output rows or images a tile), is a function of the
shapes and of x's 16-byte alignment.

Both wrappers call their custom op (``ops.quant_act``, ``ops.qconv``; in
eager mode its implementation directly, ``ops.implement``): the plain
version on CPU tensors (``_quant_act_plain``, ``_qconv_plain``) and the
kernel on CUDA tensors (``_quant_act``, ``_qconv``), which launches it or
raises. The plain versions:
``quant_act_reference`` in torch ops (``torch.round`` rounds half to even,
as ``jnp.round``), ``qconv_reference`` = ``qconv_acc_reference`` (the conv
in float64 on the int8 values with cuDNN off, exact: every partial sum is
an integer far below 2^53, where fp32 would round sums above 2^24) then
``epilogue_reference`` in torch ops, one op a step so nothing is
contracted. The kernels reproduce them bit for bit.

``LAUNCHES`` counts Q1 launches, ``GROUPED_LAUNCHES`` Q3's, ``ACT_LAUNCHES``
Q2's, whatever the input's dtype: a ResNet-50 forward moves Q1 and Q2 by 54
(53 convs and the FC), a ResNeXt-50 forward Q1 by 38, Q3 by 16 (the
grouped 3x3s) and Q2 by 54.
"""

from __future__ import annotations

import torch

from ..ops.conv import conv2d
from ..ops.padding import reference_padding
from . import bn, build, ops

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
GROUPED_LAUNCHES = 0
ACT_LAUNCHES = 0

BK = 64  # the packed weight's rows are a multiple of it (qconv.cu KP_ALIGN)
RUN = 16  # a kernel row's bytes in K are padded to a multiple of it (qconv.cu RUN)
QMAX = 127
# |acc| <= 127 * 127 * K must fit int32
MAX_K = (2 ** 31 - 1) // (QMAX * QMAX)


def quant_act_reference(x: torch.Tensor, inv: float) -> torch.Tensor:
    """Plain Q2: clip(round(f32(x) * inv), -127, 127) as int8."""
    return torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(torch.int8)


def quant_act(x: torch.Tensor, inv: float) -> torch.Tensor:
    """Q2 on a contiguous fp32 or bf16 tensor; ``inv`` = 1 / scale in fp32."""
    return _quant_act_op(x, inv)


def _quant_act_plain(x: torch.Tensor, inv: float) -> torch.Tensor:
    """``ops.quant_act``'s CPU implementation: the plain version after the
    kernel's checks."""
    build.on_card("quant_act", x)
    return quant_act_reference(x, inv)


def _quant_act(x: torch.Tensor, inv: float) -> torch.Tensor:
    """``ops.quant_act``'s CUDA implementation: one launch of Q2."""
    if not build.on_card("quant_act", x):
        raise ValueError("quant_act: CPU tensors reached the CUDA implementation")
    global ACT_LAUNCHES
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel():
        build.launch(build.entry_name("quant_act", x), x.data_ptr(), q.data_ptr(),
                     inv, x.numel(), device=x.device)
        ACT_LAUNCHES += 1
    return q


_quant_act_op = ops.implement("quant_act", cpu=_quant_act_plain, cuda=_quant_act)


def relu_reference(h: torch.Tensor, cap=None) -> torch.Tensor:
    """max(h, 0), then min(h, cap) with cap cast to h's dtype, written as
    the kernel's comparisons (a NaN and a -0 pass through)."""
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h = torch.where(h < zero, zero, h)
    if cap is not None:
        c = torch.tensor(cap, dtype=h.dtype, device=h.device)
        h = torch.where(h > c, c, h)
    return h


def qconv_acc_reference(xq: torch.Tensor, w: torch.Tensor, stride: int,
                        groups: int = 1) -> torch.Tensor:
    """The int32 accumulator of Q1: the conv of the int8 values over the
    reference's windows, in float64 with cuDNN off (its FFT algorithms
    would not be exact), cast to int32."""
    with torch.backends.cudnn.flags(enabled=False):
        y = conv2d(xq.to(torch.float64), w.to(torch.float64), stride=stride, groups=groups)
    return y.to(torch.int32)


def epilogue_reference(acc: torch.Tensor, dq: torch.Tensor, bias=None, *, relu=False,
                       cap=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Q1's epilogue in torch ops: f32(acc) * dq, + bias, then fp32 out, or
    bf16 with ReLU and the cap on the bf16 value."""
    v = acc.to(torch.float32) * dq
    if bias is not None:
        v = v + bias
    if out_dtype == torch.float32:
        return v
    h = v.to(torch.bfloat16)
    return relu_reference(h, cap) if relu else h


def qconv_reference(xq, w, dq, bias=None, *, stride=1, groups=1, relu=False, cap=None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain Q1: ``qconv_acc_reference`` then ``epilogue_reference``."""
    return epilogue_reference(qconv_acc_reference(xq, w, stride, groups), dq, bias,
                              relu=relu, cap=cap, out_dtype=out_dtype)


def row_bytes(kw: int, cin: int) -> int:
    """A kernel row's bytes in the packed K: kw * Cin rounded up to RUN."""
    return -(-kw * cin // RUN) * RUN


def packed_k(kshape) -> int:
    """The K the kernel sums over for a (kh, kw, Cin) weight: kh kernel rows
    of ``row_bytes``."""
    kh, kw, cin = kshape
    return kh * row_bytes(kw, cin)


def padded_k(kshape) -> int:
    """The packed weight's row length Kp: ``packed_k`` rounded up to BK."""
    return -(-packed_k(kshape) // BK) * BK


def group_row_bytes(cin_g: int) -> int:
    """Q3's bytes a tap and output channel: Cin / g rounded up to 4."""
    return -(-cin_g // 4) * 4


def pack_weight(w: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """An HWIO int8 weight (kh, kw, Cin / groups, Cout) as the kernel reads
    it. groups 1 (Q1): (Cout, Kp) with row co = kernel row di of w[..., co]
    ((dj, ci) order) at di * Rp (Rp = ``row_bytes``), zero in each row's
    padding and from kh * Rp up to Kp = ``padded_k``. groups > 1 (Q3):
    (kh * kw, Cout, Cgp), row (tap, co) the tap's Cin / groups bytes of
    w[..., co], zero up to Cgp = ``group_row_bytes``."""
    kh, kw, cin, cout = w.shape
    if groups > 1:
        out = torch.zeros((kh * kw, cout, group_row_bytes(cin)), dtype=torch.int8,
                          device=w.device)
        out[:, :, :cin] = w.reshape(kh * kw, cin, cout).permute(0, 2, 1)
        return out
    rp = row_bytes(kw, cin)
    out = torch.zeros((cout, padded_k((kh, kw, cin))), dtype=torch.int8, device=w.device)
    rows = out[:, :kh * rp].view(cout, kh, rp)
    rows[:, :, :kw * cin] = w.reshape(kh, kw * cin, cout).permute(2, 0, 1)
    return out


def unpack_weight(wk: torch.Tensor, kshape, groups: int = 1) -> torch.Tensor:
    """``pack_weight``'s inverse as a view of ``wk``: the HWIO weight
    (kh, kw, Cin / groups, Cout), ``kshape`` = (kh, kw, Cin / groups)."""
    kh, kw, cin = kshape
    if groups > 1:
        return wk.view(kh, kw, *wk.shape[1:])[..., :cin].permute(0, 1, 3, 2)
    rp, cout = row_bytes(kw, cin), wk.shape[0]
    rows = wk[:, :kh * rp].view(cout, kh, rp)[:, :, :kw * cin]
    return rows.view(cout, kh, kw, cin).permute(1, 2, 3, 0)


def _check(xq, w, dq, bias, out_dtype, relu, cap):
    if xq.dim() != 4 or w.dim() != 4:
        raise ValueError(f"qconv: expected x (N, H, W, C) and w (kh, kw, C, Cout), got "
                         f"{tuple(xq.shape)} and {tuple(w.shape)}")
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qconv: expected int8 x and w, got {xq.dtype} and {w.dtype}")
    for name, t in (("dq", dq), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (w.shape[-1],)):
            raise ValueError(f"qconv: {name} must be fp32 ({w.shape[-1]},)")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qconv: out_dtype {out_dtype}; expected bfloat16 or float32")
    if cap is not None and not relu:
        raise ValueError("qconv: a cap needs relu=True")
    if relu and out_dtype == torch.float32:
        raise ValueError("qconv: relu applies to a bf16 output")


def qconv(xq: torch.Tensor, w: torch.Tensor, dq: torch.Tensor, bias=None, *,
          stride: int = 1, groups: int = 1, relu: bool = False, cap=None,
          out_dtype=torch.bfloat16, wk=None) -> torch.Tensor:
    """Q1 (Q3 for groups > 1): the int8 conv of xq by w over the reference's
    windows, then the dequantizing epilogue (see the module's docstring).
    ``wk``, the packed weight (``pack_weight(w, groups)``), is packed here
    when not given."""
    return _qconv_op(xq, w, dq, bias, wk, stride, groups, relu, cap, out_dtype)


def _qconv_plain(xq, w, dq, bias, wk, stride, groups, relu, cap, out_dtype):
    """``ops.qconv``'s CPU implementation: the plain version after the
    kernels' checks."""
    _check(xq, w, dq, bias, out_dtype, relu, cap)
    _on_card(xq, w, dq, bias)
    return qconv_reference(xq, w, dq, bias, stride=stride, groups=groups, relu=relu,
                           cap=cap, out_dtype=out_dtype)


def _qconv(xq, w, dq, bias=None, wk=None, stride=1, groups=1, relu=False, cap=None,
           out_dtype=torch.bfloat16):
    """``ops.qconv``'s CUDA implementation: one launch of Q1, or of Q3 for
    groups > 1."""
    _check(xq, w, dq, bias, out_dtype, relu, cap)
    if not _on_card(xq, w, dq, bias):
        raise ValueError("qconv: CPU tensors reached the CUDA implementation")
    if groups != 1:
        return _qconv_grouped(xq, w, dq, bias, stride, groups, relu, cap, out_dtype, wk)
    n, h, wd, cin = xq.shape
    kh, kw, wcin, cout = w.shape
    if wcin != cin:
        raise ValueError(f"qconv: x has {cin} channels, w takes {wcin}")
    k = kh * kw * cin
    if k > MAX_K:
        raise ValueError(f"qconv: K = {k} exceeds {MAX_K}: 127 * 127 * K would overflow int32")
    wk = pack_weight(w) if wk is None else wk
    kk = packed_k((kh, kw, cin))
    kp = -(-kk // BK) * BK
    if (wk.dtype != torch.int8 or tuple(wk.shape) != (cout, kp)
            or not wk.is_contiguous() or wk.device != xq.device or not build.aligned16(wk)):
        raise ValueError(f"qconv: wk must be the contiguous, 16-byte aligned int8 "
                         f"({cout}, {kp}) of this tree's pack_weight(w), got "
                         f"{tuple(wk.shape)}; re-pack the HWIO weight (or export the model "
                         f"again) rather than reuse a packed weight of another layout")
    ho, wo = h // stride, wd // stride
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=xq.device)
    if out.numel():
        global LAUNCHES
        m = n * ho * wo
        tile_n, splits = build.qconv_plan(m, cout, kk)
        part = tickets = None  # held until the launch is enqueued
        if splits > 1:
            index = xq.device.index
            tiles = -(-m // build.QC_BM) * -(-cout // tile_n)
            part, tickets = bn._workspace(index, tiles * splits * build.QC_BM * tile_n, tiles,
                                          torch._C._cuda_getCurrentRawStream(index))
        build.launch("rt_qconv_s8", xq.data_ptr(), wk.data_ptr(), dq.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     None if part is None else part.data_ptr(),
                     None if tickets is None else tickets.data_ptr(),
                     n, h, wd, cin, cout, kh, kw, stride, reference_padding(h, kh, stride)[0],
                     reference_padding(wd, kw, stride)[0], ho, wo, kp,
                     _mode(relu, out_dtype), cap is not None,
                     0.0 if cap is None else float(cap), tile_n, splits, device=xq.device)
        LAUNCHES += 1
    return out


_qconv_op = ops.implement("qconv", cpu=_qconv_plain, cuda=_qconv)


def _mode(relu: bool, out_dtype) -> int:
    """The kernels' epilogue mode: 0 bf16, 1 bf16 with ReLU (and the cap),
    2 fp32 (qconv.cu Mode)."""
    return 2 if out_dtype == torch.float32 else int(relu)


def _qconv_grouped(xq, w, dq, bias, stride, groups, relu, cap, out_dtype, wk):
    """Q3: ``qconv`` with groups > 1 on the card."""
    global GROUPED_LAUNCHES
    n, h, wd, cin = xq.shape
    kh, kw, cin_g, cout = w.shape
    if cin_g * groups != cin or cout % groups:
        raise ValueError(f"qconv: x has {cin} channels and w ({tuple(w.shape)}) takes "
                         f"{cin_g} a group; {groups} groups need both counts to divide")
    if kh * kw * cin_g > MAX_K:
        raise ValueError(f"qconv: K = {kh * kw * cin_g} a group exceeds {MAX_K}: "
                         "127 * 127 * K would overflow int32")
    wk = pack_weight(w, groups) if wk is None else wk
    want = (kh * kw, cout, group_row_bytes(cin_g))
    if (wk.dtype != torch.int8 or tuple(wk.shape) != want or not wk.is_contiguous()
            or wk.device != xq.device or not build.aligned16(wk)):
        raise ValueError(f"qconv: wk must be the contiguous, 16-byte aligned int8 {want} of "
                         f"pack_weight(w, {groups}), got {tuple(wk.shape)}")
    pad_top, pad_left = reference_padding(h, kh, stride)[0], reference_padding(wd, kw, stride)[0]
    ho, wo = h // stride, wd // stride
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=xq.device)
    if out.numel():
        plan = build.q3_plan(n, cin, cout, groups, kh, kw, stride, ho, wo,
                             out_dtype == torch.float32, build.aligned16(xq))
        if plan is None:
            raise ValueError(f"qconv: no Q3 tile of {wo} output columns fits shared memory")
        build.launch("rt_qconv_grouped_s8", xq.data_ptr(), wk.data_ptr(), dq.data_ptr(),
                     None if bias is None else bias.data_ptr(), out.data_ptr(),
                     n, h, wd, cin, cout, groups, kh, kw, stride, pad_top, pad_left,
                     ho, wo, _mode(relu, out_dtype), cap is not None,
                     0.0 if cap is None else float(cap), *plan, device=xq.device)
        GROUPED_LAUNCHES += 1
    return out


def _on_card(xq, w, dq, bias) -> bool:
    """True to launch Q1 (Q3), False for the plain version (CPU tensors only);
    raises on mixed devices, a device other than CPU or CUDA, or a
    non-contiguous xq, dq or bias (``build.on_card``'s rules; it takes no
    int8). ``w`` may be any view: the kernel reads ``wk``."""
    for t in (xq, w, dq, bias):
        if t is not None and (t.device != xq.device or (t is not w and not t.is_contiguous())):
            raise ValueError(f"qconv: expected contiguous tensors on {xq.device}")
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qconv: no kernel for device {xq.device}")
    return xq.device.type == "cuda"
