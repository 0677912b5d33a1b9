"""K1's bf16 dx and K3's bf16 forward on the wgmma core's persistent kernel
(resnet_tpu_torch/kernels/csrc/conv.cu, matmul.cu), what the CPU can hold:
the loaders each ResNet-50 dx takes (``conv.dx_bf16_route``), B read from w
by its own index (against ``dx_phase_weights``, the slices the fp32 dx and
the kernel this one replaced take), the phases of a strided dx as units of
one launch (every row of dx written once), the kernel's GEMM written out
in torch (bit for bit against the plain dx on integer-valued inputs, and
against the JAX package's Pallas conv VJP in interpret mode), and the
arguments the wrappers hand the library (``build.launch`` recorded instead
of called). The kernels themselves run in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu_torch.kernels import build, checks, conv, matmul

REL = 1e-5  # beside one bf16 ulp per element


def _resnet50_dx(batch=32):
    """(label, batch, H, Cin, Cout, k, stride) of each distinct dx shape of
    ResNet-50's training step: the 52 block convs' (the stem takes none)."""
    return [(label, n, h, cin, cout, k, s)
            for label, n, h, cin, cout, k, s, *_ in checks.fused_sites(batch)]


DX = _resnet50_dx()


@pytest.mark.parametrize("case", DX, ids=[c[0] for c in DX])
def test_every_resnet50_dx_takes_its_route(case):
    """Every ResNet-50 dx at batch 32 runs on the persistent kernel: a
    1x1/s1 by TMA boxes of g and w, the 3x3s and strided dxs with g
    gathered and w by TMA boxes (Cout % 64 == 0, whole slices), and stage
    4's 3x3, whose 5 splits of 928 end inside 64-deep slices, with w by
    16-byte copies."""
    label, n, h, cin, cout, k, s = case
    m = n * h * h
    splits = conv.dx_splits(m, cin, cout, k, s)
    whole = splits == 1 or build.k_chunk(k * k * cout, splits, 16) % build.WGB_BK == 0
    want = ("matrix" if (k, s) == (1, 1) and whole else "gather" if whole else "copy")
    assert conv.dx_bf16_route(m, cin, cout, k, s) == want
    assert want != "copy" or (label.startswith("block 14 spatial") and splits == 5)


def test_resnet50_dx_reach_three_routes():
    routes = {conv.dx_bf16_route(n * h * h, cin, cout, k, s) for _, n, h, cin, cout, k, s in DX}
    assert routes == {"matrix", "gather", "copy"}


@pytest.mark.parametrize("cin,cout,k,stride,aligned", [
    (9, 33, 3, 2, True),     # checks' ragged case
    (130, 33, 3, 1, True),   # Cout no multiple of 8
    (36, 64, 3, 1, True),    # Cin no multiple of 8: dx's rows no 16-byte stores
    (64, 64, 3, 1, False),   # a misaligned g, w or dx
    (64, 64, 1, 1, False),
])
def test_other_dx_shapes_take_the_scalar_loader(cin, cout, k, stride, aligned):
    assert conv.dx_bf16_route(2 * 14 * 14, cin, cout, k, stride, aligned) == "scalar"


def test_dx_cases_cover_each_route():
    """Phase 3's bf16 dx cases reach all four loaders."""
    routes = {conv.dx_bf16_route(n * h * h, cin, cout, k, s)
              for _, n, h, cin, cout, k, s in checks.BF16_DX_CASES}
    assert routes == {"matrix", "gather", "copy", "scalar"}


def _b_from_w(w, stride):
    """B of each phase as the kernel reads it, by w's own index: B[(ti, tj,
    co), ci] = w[fy + s*ti, fx + s*tj, ci, co], the phases in row-major
    order, one (taps * Cout, Cin) block after another."""
    k, cin, cout = w.shape[0], w.shape[2], w.shape[3]
    parts = []
    for p in range(stride * stride):
        fy, ny = conv.phase_taps(p // stride, k, stride)
        fx, nx = conv.phase_taps(p % stride, k, stride)
        rows = [w[fy + stride * ti, fx + stride * tj, ci, co]
                for ti in range(ny) for tj in range(nx) for co in range(cout)
                for ci in range(cin)]
        parts.append(torch.stack(rows).reshape(ny * nx * cout, cin) if rows
                     else w.new_zeros((0, cin)))
    return torch.cat(parts)


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_b_by_ws_index_is_the_phase_weights(rng, k, stride):
    """The kernel's B, read from w by its own index in (ti, tj, co) order,
    is ``dx_phase_weights(w, s)`` bit for bit: the slices of w^T the fp32
    dx takes and the kernel this one replaced took."""
    w = torch.from_numpy(rng.normal(size=(k, k, 5, 3)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(_b_from_w(w, stride), conv.dx_phase_weights(w, stride))


def _depths(k, s, cout):
    """(phase, K) of each row phase of a k x k dx at stride s, K = its taps x
    Cout, in the order conv.cu's rt_conv2d_dx_nhwc_bf16 takes their units
    (the deepest first, row-major on a tie; the order moves no sum)."""
    depths = [(p, conv.phase_taps(p // s, k, s)[1] * conv.phase_taps(p % s, k, s)[1] * cout)
              for p in range(s * s)]
    return sorted(depths, key=lambda pk: -pk[1])


def _units(n, h, cin, cout, k, s, splits):
    """conv.cu's units of a dx (wgb::Units::at): n tile fastest, then m
    tile, then the phase's rank and split; each yields (phase, split, the
    rows row0 + [0, 128) of the phase that exist, col0, k0, k1)."""
    ho = h // s
    rows = n * ho * ho
    bn = build.wgb_tile_n(cin)
    m_tiles, n_tiles = -(-rows // build.WGB_BM), -(-cin // bn)
    depths = _depths(k, s, cout)
    chunk = build.k_chunk(k * k * cout, splits, 16) if s == 1 else depths[0][1]
    for u in range(m_tiles * n_tiles * splits * len(depths)):
        col0 = u % n_tiles * bn
        r = u // n_tiles
        row0 = r % m_tiles * build.WGB_BM
        q = r // m_tiles
        split, (phase, depth) = q % splits, depths[q // splits]
        k0 = split * chunk
        yield (phase, split, range(row0, min(row0 + build.WGB_BM, rows)), col0, k0,
               min(depth, k0 + chunk))


def _dx_row(m, n, h, s, phase):
    """dx's row of row m of a phase (conv.cu PhaseRow)."""
    ho = h // s
    b, rem = divmod(m, ho * ho)
    qy, qx = divmod(rem, ho)
    py, px = divmod(phase, s)
    return (b * h + py + s * qy) * h + px + s * qx


@pytest.mark.parametrize("n,h,cin,cout,k,s", [
    (2, 14, 72, 40, 3, 2), (3, 10, 130, 64, 3, 2), (2, 8, 16, 24, 1, 2), (1, 12, 64, 64, 3, 3),
    (2, 7, 512, 512, 3, 1), (4, 14, 64, 256, 1, 1)])
def test_phase_units_write_every_dx_row_once(n, h, cin, cout, k, s):
    """The units of one launch write each (dx row, column tile) once per
    split, every split's K columns [k0, k1) tiling the phase's K; a phase
    without taps (1x1/s2's odd phases) writes its rows too (zeros)."""
    splits = conv.dx_splits(n * h * h, cin, cout, k, s)
    bn = build.wgb_tile_n(cin)
    seen = np.zeros((n * h * h, -(-cin // bn), splits), int)
    depth_cols = {}
    for phase, split, rows, col0, k0, k1 in _units(n, h, cin, cout, k, s, splits):
        for m in rows:
            seen[_dx_row(m, n, h, s, phase), col0 // bn, split] += 1
        depth_cols.setdefault((phase, col0, rows.start), []).append((k0, k1))
    assert (seen == 1).all()
    for (phase, *_), spans in depth_cols.items():
        depth = dict(_depths(k, s, cout))[phase]
        cols = [c for k0, k1 in sorted(spans) for c in range(k0, max(k0, k1))]
        assert cols == list(range(depth))


def _kernel_dx(g, w, x_shape, s, splits):
    """The persistent kernel's dx written out in torch: per phase, row (n,
    qy, qx) of A holds g at (qy + cy - ti, qx + cx - tj) for the phase's
    taps in (ti, tj, co) order (zeros outside the gradient), B is w by its
    own index; K cut into splits of ``build.k_chunk(K, splits, 16)``
    columns, each split's k16 steps summed in fp32 in K order, the splits
    added in split order, the result cast to g's dtype once."""
    n, h, wd, cin = x_shape
    k, cout = w.shape[0], w.shape[3]
    ho, wo = h // s, wd // s
    gp = torch.nn.functional.pad(g.float(), (0, 0, k, k, k, k))
    dx = torch.zeros(n, h, wd, cin)
    b_all, at = _b_from_w(w, s).float(), 0
    for p in range(s * s):
        py, px = divmod(p, s)
        fy, ny = conv.phase_taps(py, k, s)
        fx, nx = conv.phase_taps(px, k, s)
        cy, cx = (py + k // 2 - fy) // s, (px + k // 2 - fx) // s
        cols = [gp[:, k + cy - ti:k + cy - ti + ho, k + cx - tj:k + cx - tj + wo, :]
                for ti in range(ny) for tj in range(nx)]
        depth = ny * nx * cout
        b, at = b_all[at:at + depth], at + depth
        if not depth:
            continue
        a = torch.cat(cols, dim=-1).reshape(n * ho * wo, depth)
        chunk = build.k_chunk(depth, splits, 16)
        y = torch.zeros(n * ho * wo, cin)
        for z in range(splits):
            part = torch.zeros_like(y)
            for k0 in range(z * chunk, min(depth, (z + 1) * chunk), 16):
                k1 = min(k0 + 16, depth, (z + 1) * chunk)
                part = part + a[:, k0:k1] @ b[k0:k1]
            y = y + part
        dx[:, py::s, px::s, :] = y.reshape(n, ho, wo, cin)
    return dx.to(g.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,cin,cout,k,s,splits", [
    (2, 14, 8, 16, 3, 2, 1), (2, 7, 9, 33, 3, 1, 2), (1, 12, 5, 7, 3, 3, 1),
    (2, 8, 16, 24, 1, 2, 1), (2, 7, 12, 40, 3, 1, 5), (1, 14, 3, 8, 7, 2, 1)])
def test_kernel_dx_gives_the_plain_dx_bit_for_bit(rng, dtype, n, h, cin, cout, k, s, splits):
    """On integer-valued g and w, whose sums every order keeps exact in
    fp32, the kernel's phases, K order, B index and splits give the plain
    dx bit for bit: every tap of every input pixel is summed once, the
    columns past a split's end add nothing."""
    g = torch.from_numpy(rng.integers(-4, 5, size=(n, h // s, h // s, cout)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-4, 5, size=(k, k, cin, cout)).astype(np.float32)).to(dtype)
    want = conv.conv2d_dx_reference(g, w, (n, h, h, cin), s)
    assert torch.equal(_kernel_dx(g, w, (n, h, h, cin), s, splits), want)


@pytest.mark.parametrize("k,s,splits", [(3, 2, 1), (3, 1, 2), (1, 1, 1)])
def test_kernel_dx_matches_pallas(rng, k, s, splits):
    """The kernel's dx in plain form against the JAX package's Pallas conv
    VJP in interpret mode on the same bf16 inputs: each bf16 element within
    one bf16 ulp plus 1e-5 of max."""
    from resnet_tpu.kernels.conv import conv2d_pallas

    n, h, cin, cout = 2, 8, 16, 24
    x = rng.normal(size=(n, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(n, h // s, h // s, cout)).astype(np.float32)
    jx, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: conv2d_pallas(a, b, s, None, True), jx, jw)
    want = np.asarray(vjp(jg)[0].astype(jnp.float32), np.float64)
    tw, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (jw, jg))
    got = _kernel_dx(tg, tw, (n, h, h, cin), s, splits)
    assert got.dtype is torch.bfloat16 and got.shape == want.shape
    _, e = np.frexp(np.abs(want))
    ulp = np.where(want != 0, np.ldexp(1.0, e - 8), 0.0)
    diff = np.abs(got.float().numpy().astype(np.float64) - want)
    assert np.all(diff <= ulp + REL * np.abs(want).max())


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' library calls recorded instead of made: every tensor
    counts as on the card, and build.launch appends (entry, args)."""
    calls = []
    monkeypatch.setattr(build, "on_card", lambda *a, **k: True)
    monkeypatch.setattr(build, "launch", lambda name, *args, device: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("case", checks.BF16_DX_CASES, ids=[c[0] for c in checks.BF16_DX_CASES])
def test_dx_wrapper_hands_the_library_w_as_it_lies(launches, case):
    """conv2d_dx on bf16 is one launch of rt_conv2d_dx_nhwc_bf16 with w
    itself (no torch op cuts phase weights from it), dx's split (tc_split
    at stride 1, one at stride > 1) and the loaders dx_bf16_route names."""
    _, n, h, cin, cout, k, s = case
    n = min(n, 2)
    g = torch.zeros((n, h // s, h // s, cout), dtype=torch.bfloat16)
    w = torch.zeros((k, k, cin, cout), dtype=torch.bfloat16)
    dx = conv.conv2d_dx(g, w, (n, h, h, cin), s)
    assert dx.shape == (n, h, h, cin)
    (name, args), = launches
    assert name == "rt_conv2d_dx_nhwc_bf16"
    assert args[:3] == (g.data_ptr(), w.data_ptr(), dx.data_ptr())
    assert args[3:10] == (n, h, h, cin, cout, k, s)
    splits, route = args[-2:]
    assert splits == conv.dx_splits(n * h * h, cin, cout, k, s)
    assert splits == (build.tc_split(n * h * h, cin, k * k * cout) if s == 1 else 1)
    assert (args[-3] is None) == (splits == 1)
    assert conv.DX_ROUTES[route] == conv.dx_bf16_route(n * h * h, cin, cout, k, s)


def _view(shape, offset):
    """A zero bf16 tensor of ``shape`` whose data start ``offset`` elements
    past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[offset:][:n].view(shape)


# (entry, offset of the input in elements, the loader the wrapper must name)
HANDED = [("conv2d_dx", 0, "gather"), ("conv2d_dx", 1, "scalar"), ("conv2d", 0, "gather"),
          ("conv2d", 1, "scalar"), ("matmul", 0, "swap"), ("matmul", 1, "swap_scalar")]


@pytest.mark.parametrize("entry,offset,route", HANDED, ids=[f"{e} +{o}" for e, o, _ in HANDED])
def test_wrappers_name_the_loader_their_pointers_allow(launches, entry, offset, route):
    """The route is decided once, in the wrapper, from the shapes and the
    pointers it hands over, and passed as the entry's last argument: an
    input 2 bytes off a 16-byte boundary names the 2-byte loader, the
    same shape aligned the 16-byte one (the entry refuses any loader its
    operands do not allow: tests/test_torch_gpu.py). The forwards are
    called as their ops' CUDA implementations (``conv._forward``,
    ``matmul._forward``), which the dispatcher runs for CUDA tensors."""
    if entry == "conv2d_dx":
        g, w = _view((2, 14, 14, 64), offset), torch.zeros((3, 3, 128, 64), dtype=torch.bfloat16)
        conv.conv2d_dx(g, w, (2, 14, 14, 128), 1)
        names, table = "rt_conv2d_dx_nhwc_bf16", conv.DX_ROUTES
    elif entry == "conv2d":
        x, w = _view((2, 14, 14, 64), offset), torch.zeros((3, 3, 64, 128), dtype=torch.bfloat16)
        conv._forward(x, w, 1)
        names, table = "rt_conv2d_nhwc_bf16", conv.FWD_ROUTES
    else:
        a, b = torch.zeros((8, 2048), dtype=torch.bfloat16), _view((2048, 1000), offset)
        matmul._forward(a, b)
        names, table = "rt_matmul_bf16", matmul.FWD_BF16_ROUTES
    (name, args), = launches
    assert name == names and (args[0] % 16 != 0 or args[1] % 16 != 0) == bool(offset)
    assert table[args[-1]] == route


def test_fp32_dx_keeps_the_phase_weights(launches):
    g, w = torch.zeros((2, 7, 7, 16)), torch.zeros((3, 3, 8, 16))
    conv.conv2d_dx(g, w, (2, 14, 14, 8), 2)
    (name, args), = launches
    assert name == "rt_conv2d_dx_nhwc_f32" and args[1] != w.data_ptr()


@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (8, 2048, 1000), (32, 2048, 1000),
                                   (33, 2048, 1000), (64, 2048, 1000), (5, 300, 33)])
def test_matmul_bf16_wrapper_is_one_entry_with_the_routes_split(launches, m, k, n):
    """K3's op on a card (its CUDA implementation, ``matmul._forward``) on
    bf16 launches rt_matmul_bf16 for every M, with the fp32
    route's K split (skinny_split for M <= 32, the FC's 9; split_k above)
    and the loaders fwd_bf16_route names."""
    a, b = torch.zeros((m, k), dtype=torch.bfloat16), torch.zeros((k, n), dtype=torch.bfloat16)
    c = matmul._forward(a, b)
    assert c.shape == (m, n) and c.dtype is torch.bfloat16
    (name, args), = launches
    assert name == "rt_matmul_bf16" and args[3:6] == (m, n, k)
    want = build.skinny_split(m, n, k) if m <= 32 else build.split_k(m, n, k)
    assert args[-2] == want == matmul.fwd_splits(m, n, k)
    assert (args[-3] is None) == (want == 1)
    assert matmul.FWD_BF16_ROUTES[args[-1]] == matmul.fwd_bf16_route(m, n, k)
    if (m, n, k) == (8, 1000, 2048):
        assert want == 9 and build.k_chunk(k, want, 16) == 240


@pytest.mark.parametrize("m,route", [(1, "skinny"), (32, "skinny"), (64, "tiled")])
def test_fp32_matmul_keeps_its_entry_points(launches, m, route):
    matmul._forward(torch.zeros((m, 2048)), torch.zeros((2048, 1000)))
    (name, _), = launches
    assert name == ("rt_matmul_skinny_f32" if route == "skinny" else "rt_matmul_f32")


@pytest.mark.parametrize("m,k,n,aligned,want", [
    (8, 2048, 1000, True, "swap"), (32, 2048, 1000, True, "swap"),
    (1, 2048, 1000, True, "swap"), (33, 2048, 1000, True, "matrix"),
    (64, 2048, 1000, True, "matrix"), (5, 300, 33, True, "swap_scalar"),
    (5, 300, 40, True, "swap_scalar"), (8, 2048, 1000, False, "swap_scalar"),
    (64, 2048, 1000, False, "scalar")])
def test_matmul_bf16_routes(m, k, n, aligned, want):
    """The FC's loaders: at batch 1-32 the operands swapped (b by TMA
    boxes, a by 16-byte copies, or both by 2-byte loads for a ragged N or
    K or a misaligned operand); above, K1's bf16 forward, a by TMA boxes
    where the splits are whole slices (split_k's 4 of 512 at 33 and 64
    rows), 2-byte loads for a ragged or misaligned operand."""
    assert matmul.fwd_bf16_route(m, n, k, aligned) == want


def test_bf16_matmul_cases_cover_each_route():
    routes = {matmul.fwd_bf16_route(m, n, k, offset % 8 == 0)
              for _, m, k, n, offset in checks.BF16_MATMUL_CASES}
    assert routes == {"swap", "matrix", "swap_scalar"}
