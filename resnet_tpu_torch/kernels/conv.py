"""Direct NHWC convolution and its VJP: the port of
resnet_tpu.kernels.conv.conv2d_pallas.

JAX's explicit padding (conv.py:60-72): ``padding=((lo, hi), (lo_w, hi_w))``
gives Ho = (H + lo + hi - k) // s + 1 and iy = s*oy - lo + i (W alike), taps
outside the image skipped; lo and hi may be negative (a window grid that
starts or ends inside the input, as a rank's tile of rows under spatial
partitioning has). ``padding=None`` is the reference's centred windows
(``ops.padding.reference_padding``): out = in / stride, the geometry and the
launches every caller had before padding was taken. Every entry point of
``csrc/conv.cu`` takes the window grid (pad_top, pad_left, Ho, Wo) after the
stride (``geometry``). ``conv2d`` is a
``torch.autograd.Function`` whose forward is the custom op
``ops.conv2d_nhwc`` (called directly where no gradient is recorded; its
implementations ``_forward`` on CUDA tensors and ``_forward_plain`` on CPU
ones, called directly in eager mode, ``ops.implement``). On CUDA tensors its forward launches the conv
kernel of ``csrc/conv.cu``, and its backward the two gradient kernels of the
same file (dx only when the input needs a gradient, dW only when the weight
does); anything the kernels do not take raises. All three run on the
split-TF32 tensor-core GEMM of ``csrc/tc_gemm.cuh`` (fp32 accurate), each
splitting K by ``build.tc_split`` (dx at stride 1 only); the forward gathers its input through
the fused conv's im2col (``csrc/im2col.cuh``) without the prologue. On CPU
tensors each of the three runs its plain version:

* ``conv2d_reference``: F.pad with the explicit, possibly negative padding,
  then F.conv2d (``ops.conv.conv2d``);
* ``conv2d_dx_reference``: the JAX VJP's recipe (conv.py:150-170): dilate the
  gradient by the stride, pad, and convolve with the flipped, transposed
  filter, then crop;
* ``conv2d_dw_reference``: per tap, the strided window of the padded input
  contracted with the gradient over (N, Ho, Wo) (conv.py:172-196).

bf16 tensors take the bf16 entry points of the same file: bf16 in, an
fp32 accumulator, bf16 out rounded once, as the JAX kernel does for bf16
inputs (conv.py:55-57, :105; dW in fp32 from the upcast inputs, cast to
w.dtype, :180-195). The forward (``rt_conv2d_nhwc_bf16``) runs every
shape on the persistent kernel of ``csrc/wgb_gemm.cuh``'s ``wgmma`` + TMA
core, with the A loader ``fwd_bf16_route`` names (K8-bf16's gather without
its prologue; a 1x1/s1 conv's input by TMA boxes; the stem's kernel rows
staged by 4-byte copies; the threads' 2-byte loads for ragged widths and
misaligned tensors), K split by ``build.tc_split`` into the chunks
``csrc/bf16_gemm.cuh``'s kernel took, one fp32 add per k16 step: the bits
of that kernel, which ran it before. dx (``rt_conv2d_dx_nhwc_bf16``) runs
on the same persistent loop, the phases of a strided dx as units of one
launch, with the loaders ``dx_bf16_route`` names (g gathered by 16-byte
copies, or a 1x1/s1's g by TMA boxes; w read as it lies, K-major, by TMA
boxes or 16-byte copies; the threads' 2-byte loads for ragged widths and
misaligned tensors), K split by ``build.tc_split`` at stride 1 into the
same chunks, no torch op on w: the bits of ``bf16_gemm.cuh``'s kernel,
which ran it before. dW runs where ``dw_bf16_route`` sends
it: ``rt_conv2d_dw_nhwc_bf16`` on ``csrc/wgb_gemm.cuh``'s ``wgmma`` + TMA
core (x and g read by TMA boxes as they lie, K split by
``build.wgb_split``) wherever Cin % 64 == 0 or Cin <= 8, Cout % 8 == 0,
the tensors 16-byte aligned and stride 1 or 2, which is every ResNet-50
conv (the stem's 3 channels through a copy of x zero-padded to 8,
``dw_narrow_x``); ``rt_conv2d_dw_nhwc_bf16_mma`` on ``bf16_gemm.cuh``
otherwise (ragged or misaligned operands). Every tensor of one call
shares its dtype. The plain versions compute in fp32 (the inputs upcast,
TF32 off on the card) and cast the result once to the inputs' dtype.

The counters ``LAUNCHES``, ``DX_LAUNCHES`` and ``DW_LAUNCHES`` count the
launches of the fp32 forward, dx and dW kernels, ``LAUNCHES_BF16``,
``DX_LAUNCHES_BF16`` and ``DW_LAUNCHES_BF16`` those of the bf16 ones.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d as _plain_conv2d
from ..ops.padding import reference_padding
from . import build, ops

# wrapper calls that launched each CUDA kernel
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0
LAUNCHES_BF16 = 0
DX_LAUNCHES_BF16 = 0
DW_LAUNCHES_BF16 = 0
_MAX_N_TILES = 65535  # gridDim.y of a launch walks the 64- or 128-wide column tiles
# the bf16 loaders as csrc/conv.cu numbers them (FWD_*, DX_*): the wrapper
# names one, and the entry point refuses a loader the shapes or the
# pointers do not allow
FWD_ROUTES = ("gather", "matrix", "scalar", "stem")
DX_ROUTES = ("gather", "matrix", "scalar", "copy")


Padding = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


def resolve_padding(h: int, wd: int, k: int, stride: int, padding: Padding
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The explicit ((lo, hi), (lo_w, hi_w)); None: the reference's, which
    needs stride | H and stride | W (conv.py::_resolve_padding)."""
    if padding is not None:
        (lo, hi), (lo_w, hi_w) = padding
        return (int(lo), int(hi)), (int(lo_w), int(hi_w))
    if stride < 1 or h % stride or wd % stride:
        raise ValueError(f"conv2d: stride {stride} must divide {h}x{wd}")
    return reference_padding(h, k, stride), reference_padding(wd, k, stride)


def geometry(h: int, wd: int, k: int, stride: int, padding: Padding
             ) -> Tuple[int, int, int, int]:
    """(pad_top, pad_left, Ho, Wo), the window grid csrc/conv.cu's entries
    take: Ho = (H + lo + hi - k) // s + 1 (conv.py:71-72)."""
    if stride < 1:
        raise ValueError(f"conv2d: stride {stride}")
    (lo, hi), (lo_w, hi_w) = resolve_padding(h, wd, k, stride, padding)
    ho, wo = (h + lo + hi - k) // stride + 1, (wd + lo_w + hi_w - k) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d: padding {padding} leaves no output of {h}x{wd} at k={k}, "
                         f"stride {stride}")
    return lo, lo_w, ho, wo


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     padding: Padding = None) -> torch.Tensor:
    """Plain forward in fp32, cast to x's dtype (cuDNN on the card: TF32
    must be off to compare)."""
    return _plain_conv2d(x.float(), w.float(), stride=stride,
                         padding=padding).to(x.dtype)


def _dilate(g: torch.Tensor, s: int) -> torch.Tensor:
    """Insert s - 1 zeros between spatial elements (conv.py::_dilate)."""
    if s == 1:
        return g
    n, h, w, c = g.shape
    z = g.new_zeros((n, h, s, w, s, c))
    z[:, :, 0, :, 0, :] = g
    return z.reshape(n, h * s, w * s, c)[:, : (h - 1) * s + 1, : (w - 1) * s + 1, :]


def conv2d_dx_reference(g: torch.Tensor, w: torch.Tensor, x_shape, stride: int = 1,
                        padding: Padding = None) -> torch.Tensor:
    """Plain dx: conv of the dilated gradient with the flipped, transposed
    filter, cropped to the input grid; fp32, cast to g's dtype."""
    dtype, g, w = g.dtype, g.float(), w.float()
    n, h, wd, cin = x_shape
    k = w.shape[0]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = resolve_padding(h, wd, k, stride, padding)
    w_flip = torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)
    pad = ((k - 1 - ph_lo, k - 1 - ph_hi + (h + ph_lo + ph_hi - k) % stride),
           (k - 1 - pw_lo, k - 1 - pw_hi + (wd + pw_lo + pw_hi - k) % stride))
    dx = _plain_conv2d(_dilate(g, stride), w_flip, stride=1, padding=pad)
    return dx[:, :h, :wd, :].to(dtype).contiguous()


def conv2d_dw_reference(x: torch.Tensor, g: torch.Tensor, k: int, stride: int = 1,
                        padding: Padding = None) -> torch.Tensor:
    """Plain dW (k, k, Cin, Cout): per-tap windows of x times g, in fp32,
    cast to x's dtype."""
    dtype, x, g = x.dtype, x.float(), g.float()
    n, h, wd, cin = x.shape
    ho, wo, cout = g.shape[1], g.shape[2], g.shape[3]
    (ph_lo, ph_hi), (pw_lo, pw_hi) = resolve_padding(h, wd, k, stride, padding)
    xp = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    # guarantee slice bounds for the largest tap
    pad_h = max(0, (k - 1) + (ho - 1) * stride + 1 - xp.shape[1])
    pad_w = max(0, (k - 1) + (wo - 1) * stride + 1 - xp.shape[2])
    if pad_h or pad_w:
        xp = F.pad(xp, (0, 0, 0, pad_w, 0, pad_h))
    g2 = g.reshape(n * ho * wo, cout)
    taps = [[xp[:, i:i + (ho - 1) * stride + 1:stride,
                j:j + (wo - 1) * stride + 1:stride, :].reshape(-1, cin).t() @ g2
             for j in range(k)] for i in range(k)]
    return torch.stack([torch.stack(row) for row in taps]).to(dtype)


def _shapes(x: torch.Tensor, w: torch.Tensor, stride: int, padding: Padding = None
            ) -> Tuple[int, ...]:
    """(n, h, wd, cin, cout, k, (pad_top, pad_left, ho, wo))"""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv2d: x {tuple(x.shape)}, w {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    kh, kw, wcin, cout = w.shape
    if kh != kw or kh % 2 == 0 or wcin != cin:
        raise ValueError(
            f"conv2d: w {tuple(w.shape)} must be (k, k, {cin}, Cout) with odd k"
        )
    return n, h, wd, cin, cout, kh, geometry(h, wd, kh, stride, padding)


@functools.lru_cache(maxsize=None)
def fwd_bf16_route(m: int, cin: int, cout: int, k: int, stride: int,
                   aligned: bool = True, splits: int = None, pad_left: int = None,
                   flat: bool = True) -> str:
    """The A loader of K1's bf16 forward (``csrc/conv.cu``, all on the
    persistent ``wgmma`` kernel) for m output pixels, K split ``splits``
    ways (by default ``build.tc_split``'s plan; the FC passes its own):
    'stem' (x's kernel
    rows staged by 4-byte copies, A set from them) for Cin = 3, 7x7,
    stride 2, Cout <= 64; 'matrix' (TMA boxes of the (m, Cin) input) for a
    1x1/s1 conv whose K splits are whole 64-deep slices; 'gather' (16-byte
    copies of 8 channels of one tap) elsewhere where Cin % 8 == 0; each of
    these where Cout % 8 == 0 and x, w and y are 16-byte ``aligned``; else
    'scalar' (2-byte loads of both operands: ragged widths, misaligned
    tensors). The window grid: 'stem' needs an odd ``pad_left`` (None: the
    reference's, 3), 'matrix' a ``flat`` grid (no padding, Ho = H, Wo = W,
    as every 1x1/s1 of the reference). A function of the shapes, the split,
    the alignment and the grid only; the wrapper hands it to the kernel
    (``FWD_ROUTES``)."""
    if splits is None:
        splits = build.tc_split(m, cout, k * k * cin)
    if cout % 8 or not aligned:
        return "scalar"
    if ((cin, k, stride) == (3, 7, 2) and cout <= 64 and splits == 1
            and (pad_left is None or pad_left % 2)):
        return "stem"
    if cin % 8:
        return "scalar"
    whole = splits == 1 or build.k_chunk(k * k * cin, splits, 16) % build.WGB_BK == 0
    return "matrix" if (k, stride) == (1, 1) and flat and whole else "gather"


def _flat(h: int, wd: int, k: int, stride: int, geo) -> bool:
    """The window grid of a 1x1/s1 conv that is the input's own (conv.cu
    dw_flat): its input and output are the same (pixels, C) matrix."""
    return (k, stride) == (1, 1) and tuple(geo) == (0, 0, h, wd)


def _op_padding(padding: Padding) -> Optional[List[int]]:
    """A padding in the op's form: None, or [lo, hi, lo_w, hi_w]."""
    return None if padding is None else [*padding[0], *padding[1]]


def _pairs(pads: Optional[List[int]]) -> Padding:
    """The op's padding as ((lo, hi), (lo_w, hi_w)), or None."""
    return None if pads is None else ((pads[0], pads[1]), (pads[2], pads[3]))


def _forward_plain(x: torch.Tensor, w: torch.Tensor, stride: int,
                   pads: Optional[List[int]] = None) -> torch.Tensor:
    """``ops.conv2d_nhwc``'s CPU implementation: the plain forward after
    the kernel's checks."""
    padding = _pairs(pads)
    _shapes(x, w, stride, padding)
    build.on_card("conv2d", x, w)
    return conv2d_reference(x, w, stride, padding)


def _forward(x: torch.Tensor, w: torch.Tensor, stride: int,
             pads: Optional[List[int]] = None) -> torch.Tensor:
    """``ops.conv2d_nhwc``'s CUDA implementation: one launch of K1."""
    n, h, wd, cin, cout, k, geo = _shapes(x, w, stride, _pairs(pads))
    if not build.on_card("conv2d", x, w):
        raise ValueError("conv2d: CPU tensors reached the CUDA implementation")
    if -(-cout // 64) > _MAX_N_TILES or k * k * cin >= 2**31:
        raise ValueError(f"conv2d: Cout={cout}, k*k*Cin beyond the kernel's grid")
    ho, wo = geo[2], geo[3]
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        m = n * ho * wo
        # fp32 on tc_gemm.cuh, bf16 on wgb_gemm.cuh: the same K split
        name, splits = build.entry_name("conv2d_nhwc", x), build.tc_split(m, cout, k * k * cin)
        ws_ptr, _ws = build.gemm_workspace(splits, m, cout, x)
        route = () if x.dtype is not torch.bfloat16 else (FWD_ROUTES.index(fwd_bf16_route(
            m, cin, cout, k, stride, build.aligned16(x, w), splits, geo[1],
            _flat(h, wd, k, stride, geo))),)
        build.launch(name, x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, k,
                     stride, *geo, ws_ptr, splits, *route, device=x.device)
        build.count(__name__, "LAUNCHES", x)
    return out


_conv2d_nhwc = ops.implement("conv2d_nhwc", cpu=_forward_plain, cuda=_forward)


def phase_taps(p: int, k: int, s: int, lo: int = None) -> Tuple[int, int]:
    """(first, count): the taps i = first + s*t of a k-wide window whose
    origin is lo (None: the reference's k // 2) that reach input rows of
    phase p (iy mod s = p); csrc/conv.cu PhaseTaps."""
    first = (p + (k // 2 if lo is None else lo)) % s
    return first, ((k - 1 - first) // s + 1 if first < k else 0)


def dx_phase_weights(w: torch.Tensor, stride: int, pads: Tuple[int, int] = None
                     ) -> torch.Tensor:
    """The B operands of the dx kernel: for each phase (py, px) in row-major
    order, the taps that reach it of w^T (k, k, Cout, Cin) under the window
    origin ``pads`` = (pad_top, pad_left) (None: the reference's), as one
    contiguous (taps * Cout, Cin) block after another (a small torch op on
    the weight, as the flip and transpose are jnp ops in the JAX VJP)."""
    k, cin = w.shape[0], w.shape[2]
    top, left = pads if pads is not None else (None, None)
    wt = w.permute(0, 1, 3, 2)
    parts = [wt[phase_taps(py, k, stride, top)[0]::stride,
                phase_taps(px, k, stride, left)[0]::stride].reshape(-1, cin)
             for py in range(stride) for px in range(stride)]
    return torch.cat(parts).contiguous()


def dx_splits(m: int, cin: int, cout: int, k: int, stride: int) -> int:
    """K splits of dx for m = N*H*W input pixels: ``build.tc_split`` at
    stride 1; one a phase at stride > 1 (the phases' rows are not
    contiguous in dx, so no split goes through a workspace)."""
    return build.tc_split(m, cin, k * k * cout) if stride == 1 else 1


@functools.lru_cache(maxsize=None)
def dx_bf16_route(m: int, cin: int, cout: int, k: int, stride: int,
                  aligned: bool = True, flat: bool = True) -> str:
    """The loaders of K1's bf16 dx (``csrc/conv.cu``, all on the persistent
    ``wgmma`` kernel) for m = N*H*W input pixels: 'matrix' (g and w by TMA
    boxes) for a 1x1/s1 dx whose K splits are whole 64-deep slices;
    'gather' (g by 16-byte copies of 8 channels of one tap, w by TMA boxes)
    where every slice lies in one tap of w (k = 1, or Cout % 64 == 0 with
    whole slices); 'copy' (both by 16-byte copies) elsewhere; each of these
    where Cout % 8 == 0, Cin % 8 == 0 and g, w and dx are 16-byte
    ``aligned``; else 'scalar' (2-byte loads of both operands: ragged
    widths, misaligned tensors); 'matrix' only on a ``flat`` window grid
    (no padding, Ho = H, Wo = W, as every 1x1/s1 of the reference). A
    function of the shapes, the alignment and the grid only; the wrapper
    hands it to the kernel (``DX_ROUTES``)."""
    if cout % 8 or cin % 8 or not aligned:
        return "scalar"
    splits = dx_splits(m, cin, cout, k, stride)
    whole = splits == 1 or build.k_chunk(k * k * cout, splits, 16) % build.WGB_BK == 0
    if (k, stride) == (1, 1) and flat and whole:
        return "matrix"
    return "gather" if (k == 1 or cout % build.WGB_BK == 0) and whole else "copy"


def conv2d_dx(g: torch.Tensor, w: torch.Tensor, x_shape, stride: int = 1,
              padding: Padding = None) -> torch.Tensor:
    """dx (N, H, W, Cin) of ``conv2d`` from its output gradient
    g (N, Ho, Wo, Cout) and the weight w (k, k, Cin, Cout)."""
    n, h, wd, cin = x_shape
    k, cout = w.shape[0], w.shape[3]
    geo = geometry(h, wd, k, stride, padding)
    if tuple(g.shape) != (n, geo[2], geo[3], cout):
        raise ValueError(f"conv2d_dx: g {tuple(g.shape)} for x {tuple(x_shape)}")
    if not build.on_card("conv2d_dx", g, w):
        return conv2d_dx_reference(g, w, x_shape, stride, padding)
    if -(-cin // 64) > _MAX_N_TILES or k * k * cout >= 2**31:
        raise ValueError(f"conv2d_dx: Cin={cin}, k*k*Cout beyond the kernel's grid")
    dx = torch.empty((n, h, wd, cin), dtype=g.dtype, device=g.device)
    if dx.numel():
        if g.numel() == 0:
            return dx.zero_()
        m = n * h * wd
        # fp32 takes the phases' slices of w^T; bf16 reads w as it lies
        bf16 = g.dtype is torch.bfloat16
        b = w if bf16 else dx_phase_weights(w, stride, geo[:2])
        route = (DX_ROUTES.index(dx_bf16_route(m, cin, cout, k, stride, build.aligned16(g, w),
                                               _flat(h, wd, k, stride, geo))),
                 ) if bf16 else ()
        splits = dx_splits(m, cin, cout, k, stride)
        ws_ptr, _ws = build.gemm_workspace(splits, m, cin, g)
        build.launch(build.entry_name("conv2d_dx_nhwc", g), g.data_ptr(), b.data_ptr(),
                     dx.data_ptr(), n, h, wd, cin, cout, k, stride, *geo, ws_ptr, splits,
                     *route, device=g.device)
        build.count(__name__, "DX_LAUNCHES", g)
    return dx


DW_NARROW = 8  # channels a tap of the wgmma dW's narrow tiles (16 taps a tile)


def dw_bf16_route(cin: int, cout: int, stride: int, aligned: bool = True,
                  hw: Tuple[int, int] = None) -> str:
    """The core K1's bf16 dW runs on: 'wgmma' (``csrc/wgb_gemm.cuh``) where
    x and g are plain TMA boxes: 64 channels of one tap a tile half (Cin %
    64 == 0) or 8 (Cin <= 8, the stem's 3 padded to 8 by ``dw_narrow_x``),
    rows a multiple of 16 bytes (Cout % 8 == 0), the operands TMA reads
    16-byte ``aligned``, a stride whose phases it reads (1 or 2) and an
    input ``hw`` = (H, W) with a row and a column in every phase (None: the
    reference's grid, where the stride divides them); else 'mma'
    (``csrc/bf16_gemm.cuh``): ragged widths, misaligned tensors, a tile of
    fewer rows than the stride. A function of the shapes and the alignment
    only: a launch on either route that fails raises."""
    ok = ((cin % 64 == 0 or cin <= DW_NARROW) and cout % 8 == 0 and stride in (1, 2)
          and aligned and (hw is None or min(hw) >= stride))
    return "wgmma" if ok else "mma"


def dw_narrow_x(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin < 8) zero-padded to 8 channels, the wgmma dW's narrow
    operand: the padded channels' rows of dW are zeros, cut off after the
    kernel, so the rows kept are x's own dW."""
    return F.pad(x, (0, DW_NARROW - x.shape[3]))


def conv2d_dw(x: torch.Tensor, g: torch.Tensor, k: int, stride: int = 1,
              padding: Padding = None) -> torch.Tensor:
    """dW (k, k, Cin, Cout) of ``conv2d`` from its input x (N, H, W, Cin) and
    output gradient g (N, Ho, Wo, Cout)."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    geo = geometry(h, wd, k, stride, padding)
    ho, wo = geo[2], geo[3]
    if tuple(g.shape) != (n, ho, wo, cout):
        raise ValueError(f"conv2d_dw: g {tuple(g.shape)} for x {tuple(x.shape)}")
    if not build.on_card("conv2d_dw", x, g):
        return conv2d_dw_reference(x, g, k, stride, padding)
    pixels = n * ho * wo
    if -(-cout // 64) > _MAX_N_TILES or pixels >= 2**31:
        raise ValueError(f"conv2d_dw: Cout={cout}, N*Ho*Wo beyond the kernel's grid")
    dw = torch.empty((k, k, cin, cout), dtype=x.dtype, device=x.device)
    if dw.numel():
        if pixels == 0:
            return dw.zero_()
        name = build.entry_name("conv2d_dw_nhwc", x)
        out = dw
        bf16 = x.dtype is torch.bfloat16
        if bf16 and dw_bf16_route(cin, cout, stride, g.data_ptr() % 16 == 0 and (
                cin < DW_NARROW or x.data_ptr() % 16 == 0), (h, wd)) == "wgmma":
            if cin < DW_NARROW:
                x, cin = dw_narrow_x(x), DW_NARROW
                out = torch.empty((k, k, cin, cout), dtype=x.dtype, device=x.device)
            splits = build.wgb_split(k * k * cin, cout, build.WGB_BK * build.dw_slices(
                n, ho, wo, k, stride, _flat(h, wd, k, stride, geo)))
        else:
            splits = build.tc_split(k * k * cin, cout, pixels)
            name += "_mma" if bf16 else ""
        ws_ptr, _ws = build.gemm_workspace(splits, k * k * cin, cout, x)
        build.launch(name, x.data_ptr(), g.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, k,
                     stride, *geo, ws_ptr, splits, device=x.device)
        build.count(__name__, "DW_LAUNCHES", x)
        if out is not dw:
            dw.copy_(out[:, :, :dw.shape[2]])
    return dw


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.stride, ctx.padding = stride, padding
        ctx.save_for_backward(x, w)
        return _conv2d_nhwc(x, w, stride, _op_padding(padding))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()  # autograd may hand over a strided view
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv2d_dx(g, w, x.shape, ctx.stride, ctx.padding)
        if ctx.needs_input_grad[1]:
            dw = conv2d_dw(x, g, w.shape[0], ctx.stride, ctx.padding)
        return dx, dw, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: Padding = None) -> torch.Tensor:
    """x (N, H, W, Cin) NHWC, w (k, k, Cin, Cout) HWIO, odd square k ->
    (N, Ho, Wo, Cout): ``padding`` ((lo, hi), (lo_w, hi_w)) as JAX's
    ``conv2d_pallas`` takes it, or None for the reference's windows (stride
    | H and stride | W, Ho = H/stride). Differentiable in x and w."""
    _shapes(x, w, stride, padding)
    if padding is not None:
        padding = resolve_padding(x.shape[1], x.shape[2], w.shape[0], stride, padding)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv2d.apply(x, w, stride, padding)
    # no graph to record: skip the Function
    return _conv2d_nhwc(x, w, stride, _op_padding(padding))
