"""The whole-block kernel: the port of resnet_tpu.kernels.block_fused.

``block_fused(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap)`` runs one
stride-1 bottleneck block with an identity shortcut and batch-statistics BN
and returns (out, sums_r, sums_s, sums_e) (block_fused.py:393-401): x
(N, H, W, 4C) NHWC, w1 (4C, C), w2 (3, 3, C, C) HWIO, w3 (C, 4C), fp32
gamma/beta rows (C,) for the first two BN layers and (4C,) for the third;
sums = [Σy, Σy²] per channel of each raw conv output r, s, e:

    r = x @ W1;  u = clip(relu(r · sc_r + sh_r));  s = conv3x3(u, W2)
    v = clip(relu(s · sc_s + sh_s));  e = v @ W3
    out = clip(relu(e · sc_e + sh_e + x))

with each (sc, sh) from its completed sums (``bn_affine_from_sums``). It is
a ``torch.autograd.Function``. On CUDA tensors its forward launches K10,
``rt_block_fused_f32`` (``csrc/block_fused.cu``): one host call that enqueues
the weights' K-major tf32 split, the three GEMMs on the wgmma core
(``csrc/wg_gemm.cuh``, K splits from ``build.wg_split``), the on-device (sc,
sh) rows and the join on the current stream. On CPU tensors the plain
version ``block_fused_reference`` runs, torch ops in the order of
``_block_fused_fwd_jnp`` (block_fused.py:202-254).
``block_fused_forward`` returns everything the kernel (or the plain
version) writes: out, r, s, e, the three sums and the six (sc, sh) rows it
applied. The backward recomputes the ReLU gates from those rows, so a gate
never differs from the forward's.

The backward is the closed form of ``_block_fused_vjp_bwd``
(block_fused.py:430-516) in torch ops, as the JAX package has no kernel for
it: ``_bn_bwd`` for each BN layer (K6's plain closed form), the two 1x1
products as ``torch.matmul``, the 3x3's du and dW from the plain conv's
VJP (``fused_conv._conv_vjp``, cuDNN on the card, no forward recompute),
and the identity shortcut's ``dx_res = g``. The sums' cotangents fold into the BN backward (a ``None``
cotangent counts as zero). Products and convs run at the config's
``matmul_precision`` like every plain op of the port (``ops.precision``);
the JAX package's precision drop in its fused backward is not copied.

``_pad_interior`` (block_fused.py:368-389) is not carried over: it pads C to
the TPU's 128 lanes, and the CUDA kernel masks any width.

``split_tf32(b)`` is that split alone, the B operand of the wgmma core:
(2, N, kp) with [0] = tf32(bᵀ) rounded to nearest, ties away (PTX
``cvt.rna``), [1] = tf32(bᵀ - [0]), kp = K rounded up to a multiple of 4,
zeros past K. Its plain version ``split_tf32_reference`` is bit for bit the
kernel's.

``LAUNCHES`` counts K10 launches, ``SPLIT_LAUNCHES`` those of the split
kernel through ``split_tf32`` (K10 runs it inside its own host call).
"""

from __future__ import annotations

import torch

from . import bn, build
from .fused_conv import _conv_vjp, bn_affine_from_sums, channel_sums

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
SPLIT_LAUNCHES = 0
_MAX_N_TILES = 65535  # gridDim.y of the GEMM walks its column tiles
_PAD1 = ((1, 1), (1, 1))


def bn_stats_from_sums(sums: torch.Tensor, m: int):
    """(mean, biased var) from [Σy, Σy²] over m rows (block_fused.py:326-330)."""
    return bn.mean_var_from_sums(sums[0], sums[1], m)


def _clip_relu(v, cap):
    v = torch.clamp_min(v, 0.0)
    return v if cap is None else torch.clamp_max(v, cap)


def _gate(v, cap):
    """Where clip(relu(v)) passes its gradient."""
    return v > 0 if cap is None else (v > 0) & (v < cap)


def block_fused_reference(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps: float, cap=None):
    """Plain version of K10, step for step as ``_block_fused_fwd_jnp``:
    (out, r, s, e, sums_r, sums_s, sums_e, (sc_r, sh_r, sc_s, sh_s, sc_e,
    sh_e)). On the card the products and the 3x3 are cuBLAS and cuDNN, so
    TF32 must be off to compare."""
    from ..ops.conv import conv2d

    n, h, wd, c4 = x.shape
    c = w1.shape[1]
    m = n * h * wd
    r = (x.reshape(m, c4) @ w1).reshape(n, h, wd, c)
    sums_r = channel_sums(r)
    sc_r, sh_r = bn_affine_from_sums(sums_r, g1, b1, m, eps)
    u = _clip_relu(r * sc_r + sh_r, cap)
    s = conv2d(u, w2, padding=_PAD1)
    sums_s = channel_sums(s)
    sc_s, sh_s = bn_affine_from_sums(sums_s, g2, b2, m, eps)
    v = _clip_relu(s * sc_s + sh_s, cap)
    e = (v.reshape(m, c) @ w3).reshape(n, h, wd, c4)
    sums_e = channel_sums(e)
    sc_e, sh_e = bn_affine_from_sums(sums_e, g3, b3, m, eps)
    out = _clip_relu(e * sc_e + sh_e + x, cap)
    return out, r, s, e, sums_r, sums_s, sums_e, (sc_r, sh_r, sc_s, sh_s, sc_e, sh_e)


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 mantissa bits) to nearest, ties away from
    zero, as PTX ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude and clear them (a carry into the exponent is the right
    rounding, up to inf); NaN stays NaN."""
    bits = t.view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(t), t, rounded)


def split_tf32_reference(b: torch.Tensor) -> torch.Tensor:
    """Plain version of the split kernel: b (K, N) -> (2, N, kp)."""
    k, n = b.shape
    bt = torch.zeros((n, build.kmajor_ld(k)), dtype=torch.float32, device=b.device)
    bt[:, :k] = b.t()
    hi = _tf32_rna(bt)
    return torch.stack((hi, _tf32_rna(bt - hi)))


def split_tf32(b: torch.Tensor) -> torch.Tensor:
    """The K-major tf32 split of b (K, N) fp32 (see the module docstring):
    the kernel on a CUDA tensor, the plain version on a CPU one."""
    global SPLIT_LAUNCHES
    if b.dim() != 2 or 0 in b.shape:
        raise ValueError(f"split_tf32: expected a non-empty (K, N) matrix, got "
                         f"{tuple(b.shape)}")
    build.refuse_bf16("split_tf32", b)
    if not build.on_card("split_tf32", b):
        return split_tf32_reference(b)
    k, n = b.shape
    out = torch.empty((2, n, build.kmajor_ld(k)), dtype=torch.float32, device=b.device)
    build.launch("rt_split_tf32_f32", b.data_ptr(), out.data_ptr(), k, n, device=b.device)
    SPLIT_LAUNCHES += 1
    return out


def _check(x, w1, w2, w3, g1, b1, g2, b2, g3, b3):
    if x.dim() != 4 or w1.dim() != 2 or w1.shape[0] != x.shape[3]:
        raise ValueError(f"block_fused: x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    c4, c = w1.shape
    if tuple(w2.shape) != (3, 3, c, c) or tuple(w3.shape) != (c, c4):
        raise ValueError(f"block_fused: w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)} for "
                         f"C={c}, 4C={c4}")
    for row, width in ((g1, c), (b1, c), (g2, c), (b2, c), (g3, c4), (b3, c4)):
        if tuple(row.shape) != (width,):
            raise ValueError(f"block_fused: BN rows must be ({c},) and ({c4},), got "
                             f"{tuple(row.shape)}")


def block_fused_forward(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps: float, cap=None):
    """K10 on CUDA tensors, the plain version on CPU ones: everything the
    kernel writes, in the order of ``block_fused_reference``'s result. Not
    differentiable; ``block_fused`` is."""
    global LAUNCHES
    _check(x, w1, w2, w3, g1, b1, g2, b2, g3, b3)
    build.refuse_bf16("block_fused", x, w1, w2, w3, g1, b1, g2, b2, g3, b3)
    if not build.on_card("block_fused", x, w1, w2, w3, g1, b1, g2, b2, g3, b3):
        return block_fused_reference(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap)
    n, h, wd, c4 = x.shape
    c = w1.shape[1]
    m = n * h * wd
    if m == 0 or c == 0:
        raise ValueError(f"block_fused: empty block x {tuple(x.shape)}, C={c}")
    if -(-c4 // build.wg_tile_n(c4)) > _MAX_N_TILES or 9 * c >= 2**31:
        raise ValueError(f"block_fused: 4C={c4}, C={c} beyond the kernel's grid")
    dev = x.device
    # (Cout, K) of the three GEMMs; one split-K workspace serves them in turn
    gemms = ((c, c4), (c, 9 * c), (c4, c))
    splits = [build.wg_split(m, cout, k) for cout, k in gemms]
    out, e = torch.empty_like(x), torch.empty_like(x)
    rs = torch.empty((2, n, h, wd, c), dtype=torch.float32, device=dev)
    r, s = rs[0], rs[1]
    small = torch.empty(8 * c + 4 * c4, dtype=torch.float32, device=dev)
    sums_r, sums_s, sums_e, rows = small.split((2 * c, 2 * c, 2 * c4, 4 * c + 2 * c4))
    # scratch: the per-WG_BM-row-tile statistics, the split-K partials and
    # the split weights, each from a 256-byte boundary (TMA reads the last)
    sizes = (-(-m // build.WG_BM) * 2 * max(c, c4),
             max((sp * m * cout for sp, (cout, _) in zip(splits, gemms) if sp > 1), default=0),
             sum(2 * cout * build.kmajor_ld(k) for cout, k in gemms))
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-size // 64) * 64)
    work = torch.empty(starts[-1], dtype=torch.float32, device=dev)
    part, ws, wsplit = (work.data_ptr() + 4 * start for start in starts[:3])
    build.launch("rt_block_fused_f32", x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                 w3.data_ptr(), g1.data_ptr(), b1.data_ptr(), g2.data_ptr(), b2.data_ptr(),
                 g3.data_ptr(), b3.data_ptr(), out.data_ptr(), r.data_ptr(), s.data_ptr(),
                 e.data_ptr(), sums_r.data_ptr(), sums_s.data_ptr(), sums_e.data_ptr(),
                 rows.data_ptr(), part, ws if sizes[1] else None, wsplit, n, h, wd, c4, c,
                 float(eps), int(cap is not None), 0.0 if cap is None else float(cap),
                 *splits, device=dev)
    LAUNCHES += 1
    aff = rows.split((c, c, c, c, c4, c4))
    return (out, r, s, e, sums_r.view(2, c), sums_s.view(2, c), sums_e.view(2, c4), aff)


def _bn_bwd(da, y, gamma, sums, m: int, eps: float, dsums):
    """(dy, dgamma, dbeta) of a = bn(y) with the batch statistics of sums,
    at da (block_fused.py:333-357): K6's plain closed form with no ReLU
    (``bn.bn_bwd_reference``) on the (M, C) view, plus the sums'
    cotangents dsums[0] + 2y·dsums[1] when given."""
    mean, var = bn_stats_from_sums(sums, m)
    c = y.shape[-1]
    dy, dgamma, dbeta = bn.bn_bwd_reference(y.reshape(m, c), da.reshape(m, c), mean,
                                            torch.rsqrt(var + eps), gamma, None, relu=False)
    dy = dy.reshape(y.shape)
    if dsums is not None:
        dy = dy + dsums[0] + 2.0 * y * dsums[1]
    return dy, dgamma, dbeta


class _BlockFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap):
        out, r, s, e, sums_r, sums_s, sums_e, aff = block_fused_forward(
            x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap)
        ctx.eps, ctx.cap = eps, cap
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w1, w2, w3, g1, g2, g3, r, s, e, out, sums_r, sums_s,
                              sums_e, *aff[:4])
        return out, sums_r, sums_s, sums_e

    @staticmethod
    def backward(ctx, dout, dsums_r, dsums_s, dsums_e):
        (x, w1, w2, w3, g1, g2, g3, r, s, e, out, sums_r, sums_s, sums_e,
         sc_r, sh_r, sc_s, sh_s) = ctx.saved_tensors
        eps, cap = ctx.eps, ctx.cap
        n, h, wd, c4 = x.shape
        c = w1.shape[1]
        m = n * h * wd
        # the join: out = clip(relu(bn_e(e) + x))
        g = torch.zeros_like(out) if dout is None else torch.where(
            _gate(out, cap), dout, torch.zeros_like(dout))
        de, dg3, db3 = _bn_bwd(g, e, g3, sums_e, m, eps, dsums_e)
        # the expand 1x1: e = v @ W3, v = clip(relu(bn_s(s)))
        v_pre = s * sc_s + sh_s
        v = _clip_relu(v_pre, cap)
        de2 = de.reshape(m, c4)
        dw3 = v.reshape(m, c).t() @ de2
        dv = (de2 @ w3.t()).reshape(n, h, wd, c)
        da2 = torch.where(_gate(v_pre, cap), dv, torch.zeros_like(dv))
        ds, dg2, db2 = _bn_bwd(da2, s, g2, sums_s, m, eps, dsums_s)
        # the spatial 3x3: s = conv(u, W2), u = clip(relu(bn_r(r)))
        u_pre = r * sc_r + sh_r
        u = _clip_relu(u_pre, cap)
        du, dw2 = _conv_vjp(u, w2, ds, 1, _PAD1, True)
        da1 = torch.where(_gate(u_pre, cap), du, torch.zeros_like(du))
        dr, dg1, db1 = _bn_bwd(da1, r, g1, sums_r, m, eps, dsums_r)
        # the reduce 1x1: r = x @ W1, and the identity shortcut's g
        dr2 = dr.reshape(m, c)
        dw1 = x.reshape(m, c4).t() @ dr2
        dx = g + (dr2 @ w1.t()).reshape(n, h, wd, c4)
        return dx, dw1, dw2, dw3, dg1, db1, dg2, db2, dg3, db3, None, None


def block_fused(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                g3: torch.Tensor, b3: torch.Tensor, eps: float, cap=None):
    """(out, sums_r, sums_s, sums_e) of one stride-1 identity bottleneck in
    training mode; differentiable in all ten tensors, through the sums too."""
    return _BlockFused.apply(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap)
