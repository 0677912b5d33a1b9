"""The fused engine's conv and residual join: the port of
resnet_tpu.kernels.fused_conv.

``fused_conv(x, w, scale, shift, stride, padding, prologue, relu, cap)``
returns (y, sums): y = conv(u, w) with u = clip(relu(x · scale + shift)) (the
previous layer's BN affine, the prologue; the zero padding stays 0 after
it) and sums = [Σy, Σy²] per output channel (this layer's BN statistics,
the epilogue). With ``prologue=False`` u is x and scale/shift are ignored
((1,) placeholders do). It is a ``torch.autograd.Function``. On CUDA
tensors its forward launches K8, ``rt_fused_conv_f32`` (``csrc/fused_conv.cu``,
the split-TF32 tensor-core GEMM of ``csrc/tc_gemm.cuh``);
on CPU tensors the plain version ``fused_conv_reference`` runs. Its
backward follows ``_fused_conv_bwd`` (fused_conv.py:402-422): recompute u
from x (not stored: the engine's memory trade), fold the sums' cotangents
into dy, take du and dW from the plain conv's VJP, then the prologue's
backward in torch ops. The JAX package takes those gradient convs from
``lax.conv`` outside any Pallas kernel; here they are
``aten.convolution_backward``, the VJP autograd runs for ``F.conv2d``
(cuDNN on the card), called without recomputing the forward conv. Like
every plain conv of the port they run at the config's ``matmul_precision``
(the training step's backward is inside ``ops.precision.precision_scope``),
so under 'highest' in fp32; the JAX package's Pallas backward drops its
precision there (fused_conv.py:419-422), which the port does not copy.

``conv_chain`` is the same contract in torch ops with the closed-form
backward over the saved u (``conv_chain_xla``, fused_conv.py:431-499): the
``fusedxla`` and ``hybrid`` engines' conv sites. It takes ``fused_conv``'s
explicit ``padding`` too (JAX's chain has none: its spatial step runs the
chain whole; the port runs it on a rank's haloed tile).

``fused_join(e, se, te, r, sr, tr, cap)`` is clip(relu(e·se + te + r·sr + tr))
with (C,) rows, K9 (``rt_fused_join_f32``) on CUDA tensors and
``fused_join_reference`` on CPU ones; its backward is torch ops
(fused_conv.py:558-575). ``bn_affine_from_sums`` turns sums into the next
prologue's (scale, shift) in torch ops, which autograd differentiates; γ
and β are taken to fp32 first (fused_conv.py:581-589).

bf16 data: K8 and K9 take bf16 x, e and r as the Pallas kernels do, with
fp32 per-channel rows (``build.rows_f32``) and the weight cast to x's
dtype (fused_conv.py:215): ``rt_fused_conv_bf16`` runs the prologue in
fp32 on the upcast x and rounds u to bf16 before the dot (:61-76), takes
bf16 products into an fp32 accumulator, rounds y once (:108) and takes
[Σy, Σy²] from the fp32 accumulator (:109-110), on ``csrc/wgb_gemm.cuh``'s
``wgmma`` + TMA core (the weight by TMA as it lies, K split by
``build.wgb_split``); ``rt_fused_join_bf16``
computes in fp32 on the upcast e and r and rounds once (:506-513). The
plain versions round at the same points: ``fused_conv_reference``
convolves the rounded u and the bf16 weight in fp32 (a bf16 product is
exact in fp32), takes the sums, then rounds y. In fp32 it is the chain's
value function; in bf16 the two differ, by design: the chain
(``_chain_xla_value``, :431-458) convolves in bf16 and takes its sums from
the rounded y. The backward follows JAX's rounding points (:358-399): the
output gradient with the sums' cotangents folded in is formed in fp32 from
the upcast dy and the rounded y and rounded to u's dtype before the conv
VJP; dW is cast to w's dtype, the prologue's dx to x's, dscale and dshift
to the rows' dtype; the join's to e's, r's and the rows' (:558-575).

``LAUNCHES`` counts K8 launches, ``JOIN_LAUNCHES`` K9; ``LAUNCHES_BF16``
and ``JOIN_LAUNCHES_BF16`` the bf16 ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d as _plain_conv2d
from ..ops.padding import reference_padding
from . import bn, build

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
JOIN_LAUNCHES = 0
LAUNCHES_BF16 = 0
JOIN_LAUNCHES_BF16 = 0
_MAX_N_TILES = 65535  # gridDim.y of the GEMM walks its column tiles

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
_NHWC_AXES = (0, 1, 2)


def _resolve_padding(x: torch.Tensor, w: torch.Tensor, stride: int,
                     padding: Optional[Padding]) -> Padding:
    """The explicit padding, or the reference's centred windows."""
    if padding is not None:
        return padding
    return (reference_padding(x.shape[1], w.shape[0], stride),
            reference_padding(x.shape[2], w.shape[1], stride))


def _out_dim(n: int, pad: Tuple[int, int], k: int, s: int) -> int:
    return (n + pad[0] + pad[1] - k) // s + 1


def bn_affine_from_sums(sums, gamma, beta, m: int, eps: float):
    """(scale, shift) of BN from per-channel [Σy, Σy²] over m rows, fp32
    whatever gamma's and beta's dtype (fused_conv.py:581-589)."""
    mean, var = bn.mean_var_from_sums(sums[0], sums[1], m)
    inv = torch.rsqrt(var + eps)
    scale = gamma.float() * inv
    shift = beta.float() - scale * mean
    return scale, shift


def channel_sums(y):
    """[Σy, Σy²] per channel of an NHWC tensor, (2, C), in fp32 on the
    upcast y."""
    y = y.float()
    return torch.stack([y.sum(_NHWC_AXES), (y * y).sum(_NHWC_AXES)])


def _prologue(x, scale, shift, relu: bool, cap):
    """u = clip(relu(x · scale + shift)), the BN apply's plain version."""
    return bn.bn_apply_reference(x, scale, shift, relu=relu, cap=cap)


def _conv_vjp(u, w, g, stride: int, padding: Padding, needs_du: bool):
    """(du, dW) of conv(u, w) with explicit padding at the output gradient g,
    NHWC and HWIO: the plain conv's VJP. Where a symmetric padding of the
    low side gives the same windows (the reference's centred ones do), u is
    not copied into a padded tensor."""
    (hl, hh), (wl, wh) = padding
    k = w.shape[0]
    same = all(lo >= 0 and (n + 2 * lo - k) // stride == (n + lo + hi - k) // stride
               for n, lo, hi in ((u.shape[1], hl, hh), (u.shape[2], wl, wh)))
    up = u if same else F.pad(u, (0, 0, wl, wh, hl, hh))
    du, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), up.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
        [stride, stride], [hl, wl] if same else [0, 0], [1, 1], False, [0, 0], 1,
        [needs_du, True, False])
    if du is not None:
        du = du.permute(0, 2, 3, 1)
        if not same:  # the adjoint of the pad crops (and of a crop, pads)
            du = F.pad(du, (0, 0, -wl, -wh, -hl, -hh))
        du = du.contiguous()
    return du, dw.permute(2, 3, 1, 0).contiguous()


def _conv_contract_bwd(u, x, w, scale, shift, y, dy, dsums, *, stride: int,
                       padding: Padding, prologue: bool, relu: bool, cap, needs_dx: bool):
    """The closed-form backward of the (prologue, conv, statistics) contract
    shared by ``fused_conv`` and ``conv_chain`` (fused_conv.py:358-399),
    with its rounding points: dy_tot in fp32 from the upcast dy and y,
    rounded to u's dtype; dW to w's dtype; the prologue's dx to x's, dscale
    and dshift to the rows'."""
    dy_tot = (dy.float() + dsums[0] + 2.0 * dsums[1] * y.float()).to(u.dtype)
    du, dw = _conv_vjp(u, w.to(u.dtype), dy_tot, stride, padding, needs_dx or prologue)
    dw = dw.to(w.dtype)
    if prologue:
        # the prologue's backward (fused_conv.py:219-236)
        dx, dscale, dshift = bn.bn_apply_bwd(x, du, scale, shift, relu=relu, cap=cap)
    else:
        dx, dscale, dshift = du, torch.zeros_like(scale), torch.zeros_like(shift)
    return dx, dw, dscale, dshift


def _chain_value(x, w, scale, shift, stride, padding, prologue, relu, cap):
    """(y, sums, u) of the contract in torch ops (fused_conv.py:431-458): u
    rounded to x's dtype, the conv in that dtype with the explicit padding
    (or the reference's windows), the sums of the rounded y."""
    u = _prologue(x, scale, shift, relu, cap) if prologue else x
    y = _plain_conv2d(u, w, stride=stride, padding=padding)
    return y, channel_sums(y), u


def fused_conv_reference(x, w, scale, shift, stride: int = 1,
                         padding: Optional[Padding] = None, prologue: bool = True,
                         relu: bool = True, cap=None):
    """Plain version of K8: the prologue rounded to x's dtype, the conv of
    that u and the weight in x's dtype computed in fp32 (``ops.conv.conv2d``,
    cuDNN on the card: TF32 must be off to compare), the two sums of the
    fp32 y, then y rounded once to x's dtype."""
    u = _prologue(x, scale, shift, relu, cap) if prologue else x
    y = _plain_conv2d(u.float(), w.to(x.dtype).float(), stride=stride, padding=padding)
    return y.to(x.dtype), channel_sums(y)


def _check(x, w, scale, shift, stride, prologue):
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3] or w.shape[0] != w.shape[1]:
        raise ValueError(f"fused_conv: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"fused_conv: stride {stride}")
    if prologue and (tuple(scale.shape) != (x.shape[3],) or scale.shape != shift.shape):
        raise ValueError(f"fused_conv: prologue rows must be ({x.shape[3]},), got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")


def _forward(x, w, scale, shift, stride, padding, prologue, relu, cap):
    w = w.to(x.dtype)  # the weight in x's dtype (fused_conv.py:215)
    scale, shift = build.rows_f32(scale, shift)
    if not build.on_card("fused_conv", x, w, rows=(scale, shift)):
        return fused_conv_reference(x, w, scale, shift, stride, padding, prologue, relu, cap)
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    (ph, pw) = _resolve_padding(x, w, stride, padding)
    ho, wo = _out_dim(h, ph, k, stride), _out_dim(wd, pw, k, stride)
    if ho <= 0 or wo <= 0 or n == 0 or cin == 0 or cout == 0:
        raise ValueError(f"fused_conv: empty conv x {tuple(x.shape)}, w {tuple(w.shape)}")
    if -(-cout // build.tc_tile_n(cout)) > _MAX_N_TILES or k * k * cin >= 2**31:
        raise ValueError(f"fused_conv: Cout={cout}, k*k*Cin beyond the kernel's grid")
    m = n * ho * wo
    y = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    sums = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    # the statistics' partials, one row pair per 128-row tile of y (TC_BM and
    # WGB_BM alike)
    part = torch.empty((-(-m // build.TC_BM), 2, cout), dtype=torch.float32,
                       device=x.device)
    plan = build.wgb_split if x.dtype is torch.bfloat16 else build.tc_split
    splits = plan(m, cout, k * k * cin)
    ws_ptr, _ws = build.gemm_workspace(splits, m, cout, x)
    build.launch(build.entry_name("fused_conv", x), x.data_ptr(), w.data_ptr(),
                 scale.data_ptr(), shift.data_ptr(), y.data_ptr(), part.data_ptr(),
                 sums.data_ptr(), n, h, wd, cin, cout, k, stride, ph[0], pw[0], ho, wo,
                 int(prologue), int(relu), int(cap is not None),
                 0.0 if cap is None else float(cap), ws_ptr, splits, device=x.device)
    build.count(__name__, "LAUNCHES", x)
    return y, sums


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, padding, prologue, relu, cap):
        y, sums = _forward(x, w, scale, shift, stride, padding, prologue, relu, cap)
        ctx.args = (stride, _resolve_padding(x, w, stride, padding), prologue, relu, cap)
        ctx.save_for_backward(x, w, scale, shift, y)
        return y, sums

    @staticmethod
    def backward(ctx, dy, dsums):
        x, w, scale, shift, y = ctx.saved_tensors
        stride, padding, prologue, relu, cap = ctx.args
        # recompute u rather than keep it (fused_conv.py:407-416), rounded to
        # x's dtype
        u = _prologue(x, scale, shift, relu, cap) if prologue else x
        grads = _conv_contract_bwd(u, x, w, scale, shift, y, dy, dsums, stride=stride,
                                   padding=padding, prologue=prologue, relu=relu, cap=cap,
                                   needs_dx=ctx.needs_input_grad[0])
        return (*grads, None, None, None, None, None)


def fused_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               stride: int = 1, padding: Optional[Padding] = None, prologue: bool = True,
               relu: bool = True, cap=None):
    """(y, sums): y = conv(clip(relu(x · scale + shift)), w) with the padding
    held at 0, sums = [Σy, Σy²] (2, Cout) fp32. x (N, H, W, Cin) NHWC fp32
    or bf16 (y in its dtype), w (k, k, Cin, Cout) HWIO, cast to x's dtype,
    scale and shift (Cin,) with the prologue; ``padding`` ((top, bottom),
    (left, right)) or the reference's centred windows. Differentiable in x,
    w, scale and shift."""
    _check(x, w, scale, shift, stride, prologue)
    return _FusedConv.apply(x, w, scale, shift, stride, padding, prologue, relu, cap)


class _ConvChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, padding, prologue, relu, cap):
        y, sums, u = _chain_value(x, w, scale, shift, stride, padding, prologue, relu, cap)
        ctx.args = (stride, _resolve_padding(x, w, stride, padding), prologue, relu, cap)
        ctx.save_for_backward(x, w, scale, shift, y, u)
        return y, sums

    @staticmethod
    def backward(ctx, dy, dsums):
        x, w, scale, shift, y, u = ctx.saved_tensors
        stride, padding, prologue, relu, cap = ctx.args
        grads = _conv_contract_bwd(u, x, w, scale, shift, y, dy, dsums, stride=stride,
                                   padding=padding, prologue=prologue, relu=relu, cap=cap,
                                   needs_dx=ctx.needs_input_grad[0])
        return (*grads, None, None, None, None, None)


def conv_chain(x, w, scale, shift, stride: int = 1, prologue: bool = True,
               relu: bool = True, cap=None, padding: Optional[Padding] = None):
    """``fused_conv``'s contract on torch ops, u saved for the closed-form
    backward (fused_conv.py:461-499); ``padding`` as ``fused_conv``'s (a
    rank's tile under spatial partitioning), default the reference's
    windows."""
    _check(x, w, scale, shift, stride, prologue)
    return _ConvChain.apply(x, w, scale, shift, stride, padding, prologue, relu, cap)


# ------------------------------------------------------------------- join


def fused_join_reference(e, se, te, r, sr, tr, cap=None):
    """Plain version of K9: e · se + te + r · sr + tr, ReLU, the cap, in fp32
    on the upcast e and r, rounded once to e's dtype."""
    y = torch.clamp_min(e.float() * se.float() + te.float() + r.float() * sr.float()
                        + tr.float(), 0.0)
    return (y if cap is None else torch.clamp_max(y, cap)).to(e.dtype)


def _join_forward(e, se, te, r, sr, tr, cap):
    rows = build.rows_f32(se, te, sr, tr)
    if not build.on_card("fused_join", e, r, rows=rows):
        return fused_join_reference(e, *rows[:2], r, *rows[2:], cap)
    out = torch.empty_like(e)
    if e.numel():
        build.launch(build.entry_name("fused_join", e), e.data_ptr(), r.data_ptr(),
                     *(t.data_ptr() for t in rows), out.data_ptr(), e.numel(), e.shape[-1],
                     int(cap is not None), 0.0 if cap is None else float(cap),
                     device=e.device)
        build.count(__name__, "JOIN_LAUNCHES", e)
    return out


class _FusedJoin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, se, te, r, sr, tr, cap):
        y = _join_forward(e, se, te, r, sr, tr, cap)
        ctx.cap, ctx.shift_dtypes = cap, (te.dtype, tr.dtype)
        ctx.save_for_backward(e, se, r, sr, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        # in fp32 on the upcast values, each gradient cast to its input's
        # dtype (fused_conv.py:558-575)
        e, se, r, sr, y = ctx.saved_tensors
        yf = y.float()
        gate = yf > 0 if ctx.cap is None else (yf > 0) & (yf < ctx.cap)
        dv = torch.where(gate, dy.float(), torch.zeros_like(yf))
        axes = tuple(range(e.dim() - 1))
        dt = dv.sum(axes)
        te_dtype, tr_dtype = ctx.shift_dtypes
        return ((dv * se.float()).to(e.dtype), (dv * e.float()).sum(axes).to(se.dtype),
                dt.to(te_dtype), (dv * sr.float()).to(r.dtype),
                (dv * r.float()).sum(axes).to(sr.dtype), dt.to(tr_dtype), None)


def fused_join(e, se, te, r, sr, tr, cap=None):
    """clip(relu(e · se + te + r · sr + tr)): the residual join applying both
    pending BN affines, (C,) rows over the last dimension of two contiguous
    tensors of one shape and dtype, fp32 or bf16 (the result in it);
    differentiable in all six."""
    if e.shape != r.shape:
        raise ValueError(f"fused_join: shapes {tuple(e.shape)} and {tuple(r.shape)}")
    c = e.shape[-1]
    for v in (se, te, sr, tr):
        if tuple(v.shape) != (c,):
            raise ValueError(f"fused_join: rows must be ({c},), got {tuple(v.shape)}")
    return _FusedJoin.apply(e, se, te, r, sr, tr, cap)
