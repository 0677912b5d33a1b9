"""K1's bf16 dW and K8-bf16 on the bf16 wgmma + TMA core
(resnet_tpu_torch/kernels/csrc/wgb_gemm.cuh), what the CPU can hold: the
route each ResNet-50 dW shape takes, the core's split plan
(``build.wgb_split``) at every ResNet-50 bf16 dW and K8 shape, dW's 64-pixel
boxes, the stem's zero-padded channels (bit for bit against the unpadded
plain dW, and against the JAX package's Pallas conv VJP in interpret mode),
and the arguments the wrappers hand the library (``build.launch`` recorded
instead of called). The kernels themselves run in tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu_torch.config import model_config
from resnet_tpu_torch.kernels import block_fused, build, checks, conv, fused_conv

REL = 1e-5  # beside one bf16 ulp per element


def _resnet50_convs(batch=32):
    """(label, batch, H, Cin, Cout, k, stride) of each distinct conv shape of
    ResNet-50: the stem, then the 52 block convs' (checks.fused_sites)."""
    m = model_config("resnet50")
    stem = ("stem", batch, m.input_dim, m.in_channels, m.init_filters, m.init_kernel,
            m.init_stride)
    return [stem] + [(label, n, h, cin, cout, k, s)
                     for label, n, h, cin, cout, k, s, *_ in checks.fused_sites(batch)]


CONVS = _resnet50_convs()
IDS = [c[0] for c in CONVS]


@pytest.mark.parametrize("case", CONVS, ids=IDS)
def test_every_resnet50_dw_takes_the_wgmma_route(case):
    """Every ResNet-50 conv's bf16 dW runs on the wgmma core: 64 channels a
    tile half, or the stem's 3 padded to 8."""
    _, _, _, cin, cout, _, s = case
    assert conv.dw_bf16_route(cin, cout, s) == "wgmma"


@pytest.mark.parametrize("cin,cout,stride,aligned", [
    (20, 24, 1, True),   # checks' ragged split-K case: Cin neither <= 8 nor % 64
    (64, 33, 1, True),   # a row of g not a multiple of 16 bytes
    (128, 128, 3, True),  # a stride whose phases the core does not read
    (64, 64, 1, False),  # a misaligned x or g
    (9, 64, 1, True),
])
def test_other_dw_shapes_take_the_mma_route(cin, cout, stride, aligned):
    assert conv.dw_bf16_route(cin, cout, stride, aligned) == "mma"


def _dw_plans():
    for label, n, h, cin, cout, k, s in CONVS:
        ho = h // s
        cin = max(cin, conv.DW_NARROW)
        yield f"dW {label}", k * k * cin, cout, build.WGB_BK * build.dw_slices(n, ho, ho, k, s)


def _k8_plans():
    for label, n, h, cin, cout, k, s, *_ in checks.fused_sites(32):
        yield f"K8 {label}", n * (h // s) ** 2, cout, k * k * cin


PLANS = list(_dw_plans()) + list(_k8_plans())


@pytest.mark.parametrize("label,m,n,k", PLANS, ids=[p[0] for p in PLANS])
def test_wgb_split_cuts_whole_slices(label, m, n, k):
    """The core's plan at each ResNet-50 bf16 dW and K8 shape (batch 32): at
    least one split, at most 256, each chunk a whole number of 64-deep
    slices, none empty, the chunks adding up to K, each split at least
    WGB_MIN_SLICES deep when there are several, and a second call the same
    plan."""
    splits = build.wgb_split(m, n, k)
    assert 1 <= splits <= 256
    chunks = build.wgb_chunks(k, splits)
    assert len(chunks) == splits and sum(chunks) == k
    assert all(c % build.WGB_BK == 0 for c in chunks)
    assert chunks[-1] > 0
    assert splits == 1 or min(chunks[:-1]) >= build.WGB_MIN_SLICES * build.WGB_BK
    build.wgb_split.cache_clear()
    assert build.wgb_split(m, n, k) == splits


def test_wgb_split_fills_the_card_where_the_output_is_small():
    """dW's outputs are a few tiles over hundreds of thousands of pixels:
    the plan splits them over at least most of the card's resident blocks,
    and leaves a large K8 output whole."""
    m, n, k = 9 * 64, 64, build.WGB_BK * build.dw_slices(32, 56, 56, 3, 1)
    resident = 132 * build.WGB_BLOCKS_PER_SM[build.wgb_tile_n(n)]
    tiles = -(-m // build.WGB_BM)
    assert tiles * build.wgb_split(m, n, k) >= resident // 2
    assert build.wgb_split(32 * 56 * 56, 64, 9 * 64) == 1


@pytest.mark.parametrize("ho", [112, 56, 28, 14, 7, 5])
def test_dw_box_tiles_the_grid_with_the_fewest_padded_pixels(ho):
    bw, bh = build.dw_box(ho, ho)
    assert bw * bh == 64 and (bw, bh) in build.DW_BOXES

    def padded(b):
        return -(-ho // b[0]) * b[0] * (-(-ho // b[1]) * b[1])

    assert padded((bw, bh)) == min(padded(b) for b in build.DW_BOXES)


@pytest.mark.parametrize("n,ho,k,s,want", [
    (32, 56, 1, 1, 32 * 56 * 56 // 64),  # a 1x1 at stride 1: pixels in a row
    (32, 56, 3, 1, 32 * 7 * 7),          # 8 x 8 boxes
    (32, 112, 7, 2, 32 * 7 * 28),        # the stem: 16 x 4 boxes
    (2, 7, 3, 1, 2),                     # one 8 x 8 box covers 7 x 7
])
def test_dw_slices_count_the_boxes(n, ho, k, s, want):
    assert build.dw_slices(n, ho, ho, k, s) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("n,h,k,s", [(2, 32, 7, 2), (1, 224, 7, 2), (2, 16, 3, 1)])
def test_stem_padded_channels_give_the_stems_dw_bit_for_bit(rng, dtype, n, h, k, s):
    """The plain dW of x zero-padded to 8 channels (``dw_narrow_x``), cut
    back to its 3, equals the plain dW of x bit for bit."""
    x = torch.from_numpy(rng.normal(size=(n, h, h, 3)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(n, h // s, h // s, 64)).astype(np.float32)).to(dtype)
    x8 = conv.dw_narrow_x(x)
    assert x8.shape == (n, h, h, 8) and torch.equal(x8[..., :3], x)
    assert not x8[..., 3:].any()
    padded = conv.conv2d_dw_reference(x8, g, k, s)[:, :, :3]
    assert torch.equal(padded, conv.conv2d_dw_reference(x, g, k, s))


def test_stem_padded_dw_matches_pallas(rng):
    """The stem's route on the wgmma core in plain form (x padded to 8
    channels, dW cut back to 3) against the JAX package's Pallas conv VJP
    in interpret mode on the same bf16 inputs: each bf16 element within one
    bf16 ulp plus 1e-5 of max."""
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 3, 8)) * 0.2).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    jx, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: conv2d_pallas(a, b, 2, None, True), jx, jw)
    want = np.asarray(vjp(jg)[1].astype(jnp.float32), np.float64)
    tx, tg = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (jx, jg))
    got = conv.conv2d_dw_reference(conv.dw_narrow_x(tx), tg, 7, 2)[:, :, :3]
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


@pytest.mark.parametrize("case", [c for c in CONVS if c[0] == "stem" or c[2] <= 14][:4]
                         + [("ragged", 2, 27, 20, 24, 3, 1)],
                         ids=lambda c: c[0])
def test_dw_wrapper_hands_the_library_its_route(launches, case):
    """conv2d_dw on bf16 names the entry point of its route, with the
    core's plan: the stem as an 8-channel conv of its padded copy on the
    wgmma core, a ragged width on bf16_gemm.cuh's mma.sync core; dW keeps
    its (k, k, Cin, Cout) shape."""
    _, n, h, cin, cout, k, s = case
    n = min(n, 2)
    x = torch.zeros((n, h, h, cin), dtype=torch.bfloat16)
    g = torch.zeros((n, h // s, h // s, cout), dtype=torch.bfloat16)
    dw = conv.conv2d_dw(x, g, k, s)
    assert dw.shape == (k, k, cin, cout)
    (name, args), = launches
    cin_k, splits = args[6], args[-1]
    if conv.dw_bf16_route(cin, cout, s) == "wgmma":
        assert name == "rt_conv2d_dw_nhwc_bf16"
        assert cin_k == max(cin, conv.DW_NARROW)
        assert splits == build.wgb_split(
            k * k * cin_k, cout, build.WGB_BK * build.dw_slices(n, h // s, h // s, k, s))
    else:
        assert (name, cin_k) == ("rt_conv2d_dw_nhwc_bf16_mma", cin)
        assert splits == build.tc_split(k * k * cin, cout, n * (h // s) ** 2)


def test_fp32_dw_keeps_its_entry_point(launches):
    x = torch.zeros((2, 16, 16, 3))
    g = torch.zeros((2, 8, 8, 64))
    conv.conv2d_dw(x, g, 7, 2)
    (name, args), = launches
    assert name == "rt_conv2d_dw_nhwc_f32" and args[6] == 3


@pytest.mark.parametrize("case", checks.fused_sites(2)[:6], ids=lambda c: c[0])
def test_fused_conv_bf16_plans_on_the_wgmma_core(launches, case):
    """K8-bf16 plans its K split with wgb_split and keeps its entry point
    and arguments; its statistics' partials one row pair per 128-row
    tile."""
    _, n, h, cin, cout, k, s, prologue, cap = case
    x = torch.zeros((n, h, h, cin), dtype=torch.bfloat16)
    w = torch.zeros((k, k, cin, cout), dtype=torch.bfloat16)
    rows = torch.ones(cin), torch.zeros(cin)
    fused_conv._forward(x, w, *rows, s, None, prologue, True, cap)
    (name, args), = launches
    m = n * (h // s) ** 2
    assert name == "rt_fused_conv_bf16"
    assert args[-1] == build.wgb_split(m, cout, k * k * cin)


def test_block_fused_bf16_plans_its_gemms_on_the_wgmma_core(launches):
    n, h, c = 2, 7, 64
    x = torch.zeros((n, h, h, 4 * c), dtype=torch.bfloat16)
    ws = (torch.zeros((4 * c, c)), torch.zeros((3, 3, c, c)), torch.zeros((c, 4 * c)))
    rows = [torch.ones(c), torch.zeros(c)] * 2 + [torch.ones(4 * c), torch.zeros(4 * c)]
    block_fused.block_fused_forward(x, *ws, *rows, 1e-5, None)
    (name, args), = launches
    m = n * h * h
    assert name == "rt_block_fused_bf16"
    assert list(args[-3:]) == [build.wgb_split(m, cout, kk)
                               for cout, kk in ((c, 4 * c), (c, 9 * c), (4 * c, c))]


# ResNet-50's identity blocks: (H, C) of stages 1-4, x (N, H, H, 4C)
IDENTITY_BLOCKS = [(56, 64), (28, 128), (14, 256), (7, 512)]


@pytest.mark.parametrize("n", [2, 32])
@pytest.mark.parametrize("h,c", IDENTITY_BLOCKS, ids=[f"{h}^2 C={c}" for h, c in IDENTITY_BLOCKS])
def test_block_fused_bf16_hands_the_library_its_persistent_plan(launches, n, h, c):
    """K10-bf16's wrapper at each ResNet-50 identity-block shape: the bf16
    entry point; K8's K splits (wgb_split) of the three stage GEMMs, which
    the persistent loop keeps unit for unit; the tile partials at the
    scratch's start, one [Σ, Σ²] row pair per 128-row tile of the widest
    stage; the split-K partials from the next 256-byte boundary, as many as
    the largest split stage needs (None where no stage splits); and each
    stage's units (m tiles x n tiles x splits) below 2^31."""
    c4, m = 4 * c, n * h * h
    x = torch.zeros((n, h, h, c4), dtype=torch.bfloat16)
    ws = (torch.zeros((c4, c)), torch.zeros((3, 3, c, c)), torch.zeros((c, c4)))
    rows = [torch.ones(c), torch.zeros(c)] * 2 + [torch.ones(c4), torch.zeros(c4)]
    block_fused.block_fused_forward(x, *ws, *rows, 1e-5, None)
    (name, args), = launches
    gemms = ((c, c4), (c, 9 * c), (c4, c))
    splits = [build.wgb_split(m, cout, k) for cout, k in gemms]
    assert name == "rt_block_fused_bf16" and len(args) == 31
    assert list(args[-3:]) == splits
    part_floats = -(-m // 128) * 2 * c4
    ws_floats = max((sp * m * cout for sp, (cout, _) in zip(splits, gemms) if sp > 1),
                    default=0)
    units = [-(-m // 128) * -(-cout // build.wgb_tile_n(cout)) * sp
             for sp, (cout, _) in zip(splits, gemms)]
    assert block_fused.plan(m, c4, c, True) == (splits, (part_floats, ws_floats, 0), units)
    part, ws_ptr = args[18], args[19]
    if ws_floats:
        assert ws_ptr - part == 4 * -(-part_floats // 64) * 64
    else:
        assert ws_ptr is None
    assert max(units) < 2**31


def test_block_fused_bf16_refuses_a_stage_beyond_the_unit_index(launches, monkeypatch):
    """A stage of 2^31 units or more cannot run on the persistent loop: the
    wrapper raises with the count and launches nothing (no fallback)."""
    c = 8
    plan = block_fused.plan

    def huge(m, c4, c_, bf16):
        splits, sizes, units = plan(m, c4, c_, bf16)
        return splits, sizes, [2**31] + units[1:]

    monkeypatch.setattr(block_fused, "plan", huge)
    x = torch.zeros((1, 4, 4, 4 * c), dtype=torch.bfloat16)
    ws = (torch.zeros((4 * c, c)), torch.zeros((3, 3, c, c)), torch.zeros((c, 4 * c)))
    rows = [torch.ones(c), torch.zeros(c)] * 2 + [torch.ones(4 * c), torch.zeros(4 * c)]
    with pytest.raises(ValueError, match="2\\^31"):
        block_fused.block_fused_forward(x, *ws, *rows, 1e-5, None)
    assert launches == []
