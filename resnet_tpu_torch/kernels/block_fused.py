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
(``csrc/wg_gemm.cuh``, K splits from ``build.wg_split``; ``plan``), the
on-device (sc, sh) rows and the join on the current stream. On CPU tensors
the plain version ``block_fused_reference`` runs, torch ops in the order of
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
kernel's. It takes fp32 weights only: bf16 K10 needs no split.

bf16: x (and so out, r, s, e) may be bf16, with the weights cast to x's
dtype (block_fused.py:316) and γ, β taken to fp32 (``build.rows_f32``, as
``row`` does at :281). ``rt_block_fused_bf16`` follows the rounding points
of ``_block_fused_fwd_jnp`` (:202-254), and so does the plain version:
each GEMM's bf16 products go into an fp32 accumulator, its sums come from
that fp32 result, and r, s and e are rounded to bf16 once; the prologues
run in fp32 on the rounded values and round u and v before the next
product; the six (sc, sh) rows are fp32; the join rounds out once. Its
three GEMMs run K8-bf16's gather, tiles and K splits (``build.wgb_split``)
on the bf16 ``wgmma`` + TMA core's warp-specialized persistent loop
(``csrc/wgb_gemm.cuh`` ``wgb::specialized``: one block per SM over each
stage's (m tile, n tile, split) units, two warpgroups copying and applying
the prologue, two multiplying), folded as K8 folds, so each stage has
K8-bf16's bits; a stage of 2^31 units or more raises (``_UNITS``), it never
falls back. The
backward follows ``_block_fused_vjp_bwd``'s casts (:430-516): the
products in fp32 on the upcast values, each activation
gradient rounded to x's dtype, dW to w's dtype, dγ₃ and dβ₃ to γ₃'s and
β₃'s, while dγ₁, dβ₁, dγ₂ and dβ₂ leave JAX's function in fp32 whatever
their parameters' dtype (:511-516). The autograd engine casts a
Function's gradient to its input's dtype, so with bf16 parameters those
four leaves are JAX's value rounded to bf16.

Statistics summed over ranks (inside ``bn.sync_stats``, the data-parallel
'auto' step): the one host call turns each stage's sums into the next
stage's rows on the device, with no point where the ranks could sum them.
So ``block_fused_forward(..., reduce)`` runs the block as four stage calls
of the same kernels (``rt_block_fused_stage_{f32,bf16}``: stage 0 the
weights' split, the reduce GEMM and its sums; 1 and 2 the rows from the
summed sums over the global row count, a device float, then the next GEMM
and its sums; 3 the last rows and the join), summing each stage's sums and
the row count over the ranks (``bn.summed``) between two calls. The GEMMs,
tiles, K splits and the rows' arithmetic are the one call's, so under a sum
that changes nothing the four calls give the one call's bits. The
backward's batch means of dy and dy·x̂ are then the group's (one all-reduce
a BN layer, with the sums' cotangents), while dγ and dβ stay this rank's:
they are parameter gradients, which the step's bucket sums. Without a sum
the one call runs, with its bits and launches.

``LAUNCHES`` counts K10 launches, ``LAUNCHES_BF16`` bf16 ones,
``STAGE_LAUNCHES`` (``_BF16``) the stage calls (four a block),
``SPLIT_LAUNCHES`` those of the split kernel through ``split_tf32`` (K10
runs it inside its own host call).
"""

from __future__ import annotations

import torch

from . import bn, build
from .fused_conv import _conv_vjp, bn_affine_from_sums, channel_sums

# wrapper calls that launched the CUDA kernel
LAUNCHES = 0
LAUNCHES_BF16 = 0
SPLIT_LAUNCHES = 0
# stage calls of a block whose statistics are summed over ranks (four a block)
STAGE_LAUNCHES = 0
STAGE_LAUNCHES_BF16 = 0
_MAX_N_TILES = 65535  # gridDim.y of the GEMM walks its column tiles
_UNITS = 2**31  # the bf16 loop indexes its units in 32 bits
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


def _stage_sums(sums, m_local: int, reduce):
    """A stage's (sums, row count): this rank's, or with ``reduce`` those of
    every rank of the statistics group (``bn.summed``)."""
    if reduce is None:
        return sums, m_local
    return bn.summed(reduce, sums, m_local)


def block_fused_reference(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps: float, cap=None,
                          reduce=None):
    """Plain version of K10, step for step as ``_block_fused_fwd_jnp``, its
    rounding points included: (out, r, s, e, sums_r, sums_s, sums_e, (sc_r,
    sh_r, sc_s, sh_s, sc_e, sh_e)). With ``reduce`` (an in-place sum over the
    ranks of a statistics group) each stage's sums and row count are summed
    over the ranks before its rows are taken, the sums returned are those,
    and the global row count (a device scalar) follows the rows. On the card
    the products and the 3x3 are cuBLAS and cuDNN in fp32, so TF32 must be
    off to compare."""
    from ..ops.conv import conv2d

    n, h, wd, c4 = x.shape
    c = w1.shape[1]
    m_local = n * h * wd
    dt = x.dtype
    r_f = (x.reshape(m_local, c4).float() @ w1.to(dt).float()).reshape(n, h, wd, c)
    sums_r, m = _stage_sums(channel_sums(r_f), m_local, reduce)
    r = r_f.to(dt)
    sc_r, sh_r = bn_affine_from_sums(sums_r, g1, b1, m, eps)
    u = _clip_relu(r.float() * sc_r + sh_r, cap).to(dt)
    s_f = conv2d(u.float(), w2.to(dt).float(), padding=_PAD1)
    sums_s, m = _stage_sums(channel_sums(s_f), m_local, reduce)
    s = s_f.to(dt)
    sc_s, sh_s = bn_affine_from_sums(sums_s, g2, b2, m, eps)
    v = _clip_relu(s.float() * sc_s + sh_s, cap).to(dt)
    e_f = (v.reshape(m_local, c).float() @ w3.to(dt).float()).reshape(n, h, wd, c4)
    sums_e, m = _stage_sums(channel_sums(e_f), m_local, reduce)
    e = e_f.to(dt)
    sc_e, sh_e = bn_affine_from_sums(sums_e, g3, b3, m, eps)
    out = _clip_relu(e.float() * sc_e + sh_e + x.float(), cap).to(dt)
    result = (out, r, s, e, sums_r, sums_s, sums_e, (sc_r, sh_r, sc_s, sh_s, sc_e, sh_e))
    return result if reduce is None else (*result, m)


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
    if b.dtype is torch.bfloat16:
        raise ValueError("split_tf32: the tf32 split takes fp32 weights; bf16 K10 "
                         "multiplies its bf16 weights as they are")
    if not build.on_card("split_tf32", b, bf16=False):
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


def plan(m: int, c4: int, c: int, bf16: bool):
    """(splits, sizes, units) of K10 on m pixels of width 4C = c4: the K
    splits of its three GEMMs ((Cout, K) = (C, 4C), (C, 9C), (4C, C);
    ``build.wgb_split`` in bf16, ``build.wg_split`` in fp32), the floats of
    its three scratch regions (the per-128-row-tile statistics, the split-K
    partials, which the stages take in turn, and in fp32 the split weights),
    and each GEMM's work units (m tiles x n tiles x splits: the bf16
    persistent loop's)."""
    gemms = ((c, c4), (c, 9 * c), (c4, c))
    split, tile_n = ((build.wgb_split, build.wgb_tile_n) if bf16
                     else (build.wg_split, build.wg_tile_n))
    splits = [split(m, cout, k) for cout, k in gemms]
    sizes = (-(-m // build.WG_BM) * 2 * max(c, c4),
             max((sp * m * cout for sp, (cout, _) in zip(splits, gemms) if sp > 1), default=0),
             0 if bf16 else sum(2 * cout * build.kmajor_ld(k) for cout, k in gemms))
    units = [-(-m // build.WGB_BM) * -(-cout // tile_n(cout)) * sp
             for sp, (cout, _) in zip(splits, gemms)]
    return splits, sizes, units


def block_fused_forward(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps: float, cap=None,
                        reduce=None):
    """K10 on CUDA tensors, the plain version on CPU ones: everything the
    kernel writes, in the order of ``block_fused_reference``'s result. With
    ``reduce`` (an in-place sum over a statistics group's ranks) the block
    runs one stage at a time (``rt_block_fused_stage_*``, counted in
    ``STAGE_LAUNCHES``), each stage's sums and the row count summed over the
    ranks between two stages, and the global row count follows, as the
    plain version's. Not differentiable; ``block_fused`` is."""
    _check(x, w1, w2, w3, g1, b1, g2, b2, g3, b3)
    w1, w2, w3 = (w.to(x.dtype) for w in (w1, w2, w3))  # block_fused.py:316
    rows = build.rows_f32(g1, b1, g2, b2, g3, b3)
    if not build.on_card("block_fused", x, w1, w2, w3, rows=rows):
        if reduce is None:
            return block_fused_reference(x, w1, w2, w3, *rows, eps, cap)
        return block_fused_reference(x, w1, w2, w3, *rows, eps, cap, reduce)
    n, h, wd, c4 = x.shape
    c = w1.shape[1]
    m_local = n * h * wd
    if m_local == 0 or c == 0:
        raise ValueError(f"block_fused: empty block x {tuple(x.shape)}, C={c}")
    if -(-c4 // build.wg_tile_n(c4)) > _MAX_N_TILES or 9 * c >= 2**31:
        raise ValueError(f"block_fused: 4C={c4}, C={c} beyond the kernel's grid")
    dev = x.device
    bf16 = x.dtype is torch.bfloat16
    splits, sizes, units = plan(m_local, c4, c, bf16)
    if bf16 and max(units) >= _UNITS:
        raise ValueError(f"block_fused: {max(units)} units of a stage GEMM at M={m_local}, "
                         f"4C={c4}, C={c}; the persistent loop indexes fewer than 2^31")
    out, e = torch.empty_like(x), torch.empty_like(x)
    rs = torch.empty((2, n, h, wd, c), dtype=x.dtype, device=dev)
    r, s = rs[0], rs[1]
    small = torch.empty(8 * c + 4 * c4, dtype=torch.float32, device=dev)
    sums_r, sums_s, sums_e, aff_rows = small.split((2 * c, 2 * c, 2 * c4, 4 * c + 2 * c4))
    # the scratch regions, each from a 256-byte boundary (TMA reads the last)
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + -(-size // 64) * 64)
    work = torch.empty(starts[-1], dtype=torch.float32, device=dev)
    part, ws, wsplit = (work.data_ptr() + 4 * start for start in starts[:3])
    tensors = (x, w1, w2, w3, *rows, out, r, s, e, sums_r, sums_s, sums_e, aff_rows)
    tail = (n, h, wd, c4, c, float(eps), int(cap is not None),
            0.0 if cap is None else float(cap), *splits)
    scratch = (part, ws if sizes[1] else None) + (() if bf16 else (wsplit,))
    ptrs = (*(t.data_ptr() for t in tensors), *scratch, *tail)
    aff = aff_rows.split((c, c, c, c, c4, c4))
    sums = (sums_r.view(2, c), sums_s.view(2, c), sums_e.view(2, c4))
    if reduce is None:
        build.launch(build.entry_name("block_fused", x), *ptrs, device=dev)
        build.count(__name__, "LAUNCHES", x)
        return (out, r, s, e, *sums, aff)
    entry = build.entry_name("block_fused_stage", x)
    m = None  # the global row count, a device float, from stage 0's sum on
    for stage in range(4):
        build.launch(entry, stage, *ptrs, None if m is None else m.data_ptr(), device=dev)
        build.count(__name__, "STAGE_LAUNCHES", x)
        if stage < 3:
            total, m = bn.summed(reduce, sums[stage], m_local)
            sums[stage].copy_(total)
    return (out, r, s, e, *sums, aff, m)


def _bn_bwd(da, y, gamma, sums, m, eps: float, dsums, reduce=None):
    """(dy, dgamma, dbeta) of a = bn(y) with the batch statistics of sums
    over m rows, at da (block_fused.py:333-357): K6's plain closed form with
    no ReLU (``bn.bn_bwd_reference``) on the (M, C) view in fp32, plus the
    sums' cotangents dsums[0] + 2y·dsums[1] when given; dy rounded once to
    y's dtype, dgamma and dbeta fp32. With ``reduce`` the statistics are a
    group's (sums and m global): dy takes the group's means of da and
    da·x̂, and the sums' cotangents summed over the ranks (one all-reduce),
    while dgamma and dbeta stay this rank's, parameter gradients that the
    step's gradient bucket sums."""
    mean, var = bn_stats_from_sums(sums, m)
    c = y.shape[-1]
    yf = y.float()
    rows = y.numel() // c
    inv_std = torch.rsqrt(var + eps)
    if reduce is None:
        dy, dgamma, dbeta = bn.bn_bwd_reference(yf.reshape(rows, c), da.float().reshape(rows, c),
                                                mean, inv_std, gamma.float(), None, relu=False)
        dy = dy.reshape(y.shape)
        if dsums is not None:
            dy = dy + dsums[0] + 2.0 * yf * dsums[1]
        return dy.to(y.dtype), dgamma, dbeta
    g = gamma.float()
    daf = da.float().reshape(rows, c)
    x_hat = (yf.reshape(rows, c) - mean) * inv_std
    dbeta = daf.sum(0)
    dgamma = (daf * x_hat).sum(0)
    ds = torch.zeros((2, c), dtype=torch.float32, device=y.device) if dsums is None else dsums
    both = torch.cat([dbeta, dgamma, ds.float().reshape(-1)])
    reduce(both)
    s1, s2, ds0, ds1 = both.view(4, c).unbind(0)
    dy = (g * inv_std * (daf - s1 / m - x_hat * (s2 / m))).reshape(y.shape)
    dy = dy + ds0 + 2.0 * yf * ds1
    return dy.to(y.dtype), dgamma, dbeta


def _mm(a, b):
    """a @ b in fp32 on the upcast values (a bf16 product is exact in fp32)."""
    return a.float() @ b.float()


class _BlockFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap, reduce):
        if reduce is None:
            out, r, s, e, sums_r, sums_s, sums_e, aff = block_fused_forward(
                x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap)
            m = x.shape[0] * x.shape[1] * x.shape[2]
        else:
            out, r, s, e, sums_r, sums_s, sums_e, aff, m = block_fused_forward(
                x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap, reduce)
            ctx.mark_non_differentiable(m)
        ctx.eps, ctx.cap, ctx.b3_dtype, ctx.reduce, ctx.m = eps, cap, b3.dtype, reduce, m
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w1, w2, w3, g1, g2, g3, r, s, e, out, sums_r, sums_s,
                              sums_e, *aff[:4])
        return (out, sums_r, sums_s, sums_e) + (() if reduce is None else (m,))

    @staticmethod
    def backward(ctx, dout, dsums_r, dsums_s, dsums_e, *_dm):
        (x, w1, w2, w3, g1, g2, g3, r, s, e, out, sums_r, sums_s, sums_e,
         sc_r, sh_r, sc_s, sh_s) = ctx.saved_tensors
        eps, cap, reduce = ctx.eps, ctx.cap, ctx.reduce
        n, h, wd, c4 = x.shape
        c = w1.shape[1]
        m = n * h * wd  # this rank's rows; ctx.m the statistics' (global) count
        dt = x.dtype
        # the join: out = clip(relu(bn_e(e) + x))
        g = torch.zeros_like(out) if dout is None else torch.where(
            _gate(out.float(), cap), dout.to(dt), torch.zeros_like(out))
        de, dg3, db3 = _bn_bwd(g, e, g3, sums_e, ctx.m, eps, dsums_e, reduce)
        # the expand 1x1: e = v @ W3, v = clip(relu(bn_s(s)))
        v_pre = s.float() * sc_s + sh_s
        v = _clip_relu(v_pre, cap).to(dt)
        de2 = de.reshape(m, c4)
        dw3 = _mm(v.reshape(m, c).t(), de2).to(w3.dtype)
        dv = _mm(de2, w3.to(dt).t()).reshape(n, h, wd, c)
        da2 = torch.where(_gate(v_pre, cap), dv, torch.zeros_like(dv)).to(dt)
        ds, dg2, db2 = _bn_bwd(da2, s, g2, sums_s, ctx.m, eps, dsums_s, reduce)
        # the spatial 3x3: s = conv(u, W2), u = clip(relu(bn_r(r)))
        u_pre = r.float() * sc_r + sh_r
        u = _clip_relu(u_pre, cap).to(dt)
        du, dw2 = _conv_vjp(u, w2.to(dt), ds, 1, _PAD1, True)
        dw2 = dw2.to(w2.dtype)
        da1 = torch.where(_gate(u_pre, cap), du.float(), torch.zeros_like(u_pre)).to(dt)
        dr, dg1, db1 = _bn_bwd(da1, r, g1, sums_r, ctx.m, eps, dsums_r, reduce)
        # the reduce 1x1: r = x @ W1, and the identity shortcut's g
        dr2 = dr.reshape(m, c)
        dw1 = _mm(x.reshape(m, c4).t(), dr2).to(w1.dtype)
        dx = (g.float() + _mm(dr2, w1.to(dt).t()).reshape(n, h, wd, c4)).to(dt)
        # dγ₁, dβ₁, dγ₂, dβ₂ in fp32, dγ₃, dβ₃ in their dtypes (block_fused.py:511-516)
        return (dx, dw1, dw2, dw3, dg1, db1, dg2, db2, dg3.to(g3.dtype),
                db3.to(ctx.b3_dtype), None, None, None)


def block_fused(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, w3: torch.Tensor,
                g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                g3: torch.Tensor, b3: torch.Tensor, eps: float, cap=None,
                with_rows: bool = False):
    """(out, sums_r, sums_s, sums_e) of one stride-1 identity bottleneck in
    training mode, x fp32 or bf16 (out in its dtype, the sums fp32);
    differentiable in all ten tensors, through the sums too. Inside
    ``bn.sync_stats`` the statistics are the group's: the block runs stage
    by stage with each stage's sums summed over the ranks (the sums
    returned are the group's), and the backward's batch means are the
    group's. ``with_rows`` adds the row count the sums are over (this
    block's rows, or the group's as a device scalar)."""
    group = bn.stats_group()
    reduce = None if group is None else group.reduce
    outs = _BlockFused.apply(x, w1, w2, w3, g1, b1, g2, b2, g3, b3, eps, cap, reduce)
    if not with_rows:
        return outs[:4]
    return (*outs[:4], outs[4] if reduce is not None else x.shape[0] * x.shape[1] * x.shape[2])
