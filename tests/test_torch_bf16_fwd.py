"""K1's bf16 forward on the wgmma core's persistent kernel and K3's bf16
backward in one launch (resnet_tpu_torch/kernels/csrc/conv.cu, matmul.cu),
what the CPU can hold: the A loader each ResNet-50 conv's forward takes
(``conv.fwd_bf16_route``), the K splits it shares with bf16_gemm.cuh's
kernel (whole k16 steps; whole slices where A comes by TMA), the kernel's
GEMM written out in torch (K in (di, dj, ci) order, cut into those splits:
bit for bit against the plain conv on integer-valued inputs, and against
the JAX package's Pallas conv in interpret mode), the arguments the
wrappers hand the library (``build.launch`` recorded instead of called),
and the FC backward's block plan (``build.matmul_bwd_plan_bf16``). The
kernels themselves run in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from resnet_tpu_torch.config import model_config
from resnet_tpu_torch.kernels import build, checks, conv, matmul

REL = 1e-5  # beside one bf16 ulp per element


def _resnet50_convs(batch):
    """(label, batch, H, Cin, Cout, k, stride) of each distinct conv shape of
    ResNet-50's forward: the stem, then the 52 block convs'."""
    m = model_config("resnet50")
    stem = ("stem", batch, m.input_dim, m.in_channels, m.init_filters, m.init_kernel,
            m.init_stride)
    return [stem] + [(label, n, h, cin, cout, k, s)
                     for label, n, h, cin, cout, k, s, *_ in checks.fused_sites(batch)]


CONVS = _resnet50_convs(8) + _resnet50_convs(32)
CONV_IDS = [f"{c[0]}, batch {c[1]}" for c in CONVS]


@pytest.mark.parametrize("case", CONVS, ids=CONV_IDS)
def test_every_resnet50_forward_takes_the_wgmma_core(case):
    """Every conv of ResNet-50's forward, served at batch 8 or trained at 32,
    runs on the wgmma core's persistent kernel: the stem on its staged
    kernel rows, a 1x1/s1 by TMA boxes where its splits are whole slices,
    the others on 8-channel chunks."""
    label, n, h, cin, cout, k, s = case
    m = n * (h // s) ** 2
    chunk = build.k_chunk(k * k * cin, build.tc_split(m, cout, k * k * cin), 16)
    want = ("stem" if label == "stem" else
            "matrix" if (k, s) == (1, 1) and chunk % build.WGB_BK == 0 else "gather")
    assert conv.fwd_bf16_route(m, cin, cout, k, s) == want


@pytest.mark.parametrize("case", CONVS, ids=CONV_IDS)
def test_forward_splits_are_bf16_gemm_chunks(case):
    """The persistent kernel cuts K as bf16_gemm.cuh's kernel did (tc_split,
    chunks of whole k16 steps, none empty), so it adds the same 16-deep
    sums in the same order; a split by TMA boxes is whole 64-deep slices."""
    _, n, h, cin, cout, k, s = case
    m, depth = n * (h // s) ** 2, k * k * cin
    splits = build.tc_split(m, cout, depth)
    chunk = build.k_chunk(depth, splits, 16)
    assert chunk % 16 == 0 and (splits - 1) * chunk < depth <= splits * chunk
    if conv.fwd_bf16_route(m, cin, cout, k, s) == "matrix":
        assert splits == 1 or chunk % build.WGB_BK == 0


@pytest.mark.parametrize("cin,cout,k,stride,aligned", [
    (9, 33, 3, 1, True),     # checks' ragged case: neither width a multiple of 8
    (130, 66, 3, 2, True),   # checks' ragged stride-2 case
    (64, 64, 3, 1, False),   # a misaligned x or w
    (3, 64, 7, 2, False),    # the stem's shape, misaligned
    (3, 64, 7, 1, True),     # Cin = 3 at another stride
    (64, 60, 1, 1, True),    # a row of w no whole 16-byte chunks
])
def test_other_forward_shapes_take_the_scalar_loader(cin, cout, k, stride, aligned):
    assert conv.fwd_bf16_route(2 * 7 * 7, cin, cout, k, stride, aligned) == "scalar"


def test_forward_cases_cover_each_route():
    """Phase 3's bf16 forward cases reach all four A loaders, the
    misaligned one by its storage offset."""
    routes = {conv.fwd_bf16_route(c[1] * (c[2] // c[6]) ** 2, c[3], c[4], c[5], c[6],
                                  not c[7:] or c[7] % 8 == 0)
              for c in checks.BF16_CONV_CASES}
    assert routes == {"matrix", "gather", "scalar", "stem"}


def _kernel_gemm(x, w, s, splits):
    """The persistent kernel's GEMM written out in torch: row (n, oy, ox) of A
    holds x's window from (s*oy - k/2, s*ox - k/2) with K in (di, dj, ci)
    order, zeros outside the image; K is cut into splits of
    ``build.k_chunk(K, splits, 16)`` columns, each split's k16 steps summed
    in fp32 in K order, the splits added in split order, the result cast to
    x's dtype once."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    ho, wo, p = h // s, wd // s, k // 2
    xp = F.pad(x.float(), (0, 0, p, k, p, k))
    cols = [xp[:, di:di + s * ho:s, dj:dj + s * wo:s, :] for di in range(k) for dj in range(k)]
    a = torch.cat(cols, dim=-1).reshape(n * ho * wo, k * k * cin)
    b = w.float().reshape(k * k * cin, cout)
    depth, chunk = k * k * cin, build.k_chunk(k * k * cin, splits, 16)
    y = torch.zeros(n * ho * wo, cout)
    for z in range(splits):
        part = torch.zeros_like(y)
        for k0 in range(z * chunk, min(depth, (z + 1) * chunk), 16):
            k1 = min(k0 + 16, depth, (z + 1) * chunk)
            part = part + a[:, k0:k1] @ b[k0:k1]
        y = y + part
    return y.reshape(n, ho, wo, cout).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,h,cin,cout,k,s,splits", [
    (2, 30, 3, 8, 7, 2, 1), (1, 224, 3, 8, 7, 2, 1), (3, 16, 3, 8, 7, 2, 2),
    (2, 14, 24, 16, 3, 2, 3), (2, 7, 9, 33, 3, 1, 2)])
def test_kernel_gemm_gives_the_plain_conv_bit_for_bit(rng, dtype, n, h, cin, cout, k, s,
                                                      splits):
    """On integer-valued x and w, whose sums every order keeps exact in fp32,
    the kernel's K order, window and splits give the plain conv bit for bit:
    the window's edges and the columns past a split's end come out as
    zeros, and every column is summed once."""
    x = torch.from_numpy(rng.integers(-4, 5, size=(n, h, h, cin)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.integers(-4, 5, size=(k, k, cin, cout)).astype(np.float32)).to(dtype)
    assert torch.equal(_kernel_gemm(x, w, s, splits), conv.conv2d_reference(x, w, s))


@pytest.mark.parametrize("splits", [1, 2])
def test_kernel_gemm_stem_matches_pallas(rng, splits):
    """The stem's GEMM in plain form against the JAX package's Pallas conv in
    interpret mode on the same bf16 inputs: each bf16 element within one
    bf16 ulp plus 1e-5 of max."""
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 3, 8)) * 0.2).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(conv2d_pallas(jx, jw, 2, None, True).astype(jnp.float32), np.float64)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in (jx, jw))
    got = _kernel_gemm(tx, tw, 2, splits)
    assert got.dtype is torch.bfloat16 and got.shape == want.shape
    _, e = np.frexp(np.abs(want))
    ulp = np.where(want != 0, np.ldexp(1.0, e - 8), 0.0)
    diff = np.abs(got.float().numpy().astype(np.float64) - want)
    assert np.all(diff <= ulp + REL * np.abs(want).max())


@pytest.mark.parametrize("w_parity", [0, 1])
def test_stem_windows_start_4_byte_aligned(w_parity):
    """conv.cu's stem stages, for each output pixel and kernel row, the 24
    values from x's element 3 (pixel of (iy, 2 ox - 3)) - 1 on, 4 bytes a
    copy: even for every ox where W is even (the stride divides W), the
    only widths the stem loader takes."""
    w = 224 + w_parity
    starts = [3 * (iy * w + 2 * ox - 3) - 1 + 2 * p for iy in (0, 5) for ox in range(w // 2)
              for p in range(12)]
    assert all(v % 2 == 0 for v in starts) == (w_parity == 0)


def test_stem_slices_touch_at_most_four_kernel_rows():
    """A 64-deep slice of the stem's K = 147 (21 values a kernel row) spans
    at most 4 kernel rows from its first, the rows conv.cu stages a slot."""
    for k0 in range(0, 147, 64):
        rows = {k // 21 for k in range(k0, min(k0 + 64, 147))}
        assert min(rows) == k0 // 21 and max(rows) - min(rows) < 4


@pytest.fixture
def launches(monkeypatch):
    """The wrappers' library calls recorded instead of made: every tensor
    counts as on the card, and build.launch appends (entry, args)."""
    calls = []
    monkeypatch.setattr(build, "on_card", lambda *a, **k: True)
    monkeypatch.setattr(build, "launch", lambda name, *args, device: calls.append((name, args)))
    return calls


WRAPPER_CASES = [c for c in checks.BF16_CONV_CASES if c[1] == 8] + checks.BF16_CONV_CASES[-5:]


@pytest.mark.parametrize("case", WRAPPER_CASES, ids=[c[0] for c in WRAPPER_CASES])
def test_forward_wrapper_hands_the_library_its_route(launches, case):
    """K1's op on a card (its CUDA implementation, ``conv._forward``, which
    the dispatcher runs for CUDA tensors) on bf16 names the persistent
    kernel's entry point for every shape, with bf16_gemm.cuh's K split (tc_split), as the fp32 forward,
    and the A loader fwd_bf16_route names for x's alignment."""
    _, n, h, cin, cout, k, s, *offset = case
    x = torch.zeros(n * h * h * cin + 8, dtype=torch.bfloat16)[
        (offset[0] if offset else 0):][:n * h * h * cin].view(n, h, h, cin)
    y = conv._forward(x, torch.zeros((k, k, cin, cout), dtype=torch.bfloat16), s)
    assert y.shape == (n, h // s, h // s, cout)
    (name, args), = launches
    assert name == "rt_conv2d_nhwc_bf16"
    assert args[3:10] == (n, h, h, cin, cout, k, s)
    m = n * (h // s) ** 2
    assert args[-2] == build.tc_split(m, cout, k * k * cin)
    assert conv.FWD_ROUTES[args[-1]] == conv.fwd_bf16_route(m, cin, cout, k, s,
                                                           x.data_ptr() % 16 == 0)


def test_fp32_forward_keeps_its_entry_point(launches):
    conv._forward(torch.zeros((2, 16, 16, 3)), torch.zeros((7, 7, 3, 64)), 2)
    (name, args), = launches
    assert name == "rt_conv2d_nhwc_f32" and args[-1] == build.tc_split(128, 64, 147)


def _covered(m, k, n, need_a, need_b):
    """How many times each element of da (m, k) and db (k, n) is written by
    the blocks of matmul_bwd_plan_bf16, mapped as matmul.cu's kernel maps
    them."""
    da_blocks, db_blocks = build.matmul_bwd_plan_bf16(m, k, n, need_a, need_b)
    da, db = np.zeros((m, k), int), np.zeros((k, n), int)
    slabs, ntiles = -(-k // build.BWD16_R), -(-n // build.BWD16_TN)
    for i in range(da_blocks):
        r0, m0 = i % slabs * build.BWD16_R, i // slabs * build.BWD16_MT
        da[m0:m0 + build.BWD16_MT, r0:r0 + build.BWD16_R] += 1
    for t in range(db_blocks):
        k0, n0 = t // ntiles * build.BWD16_TK, t % ntiles * build.BWD16_TN
        db[k0:k0 + build.BWD16_TK, n0:n0 + build.BWD16_TN] += 1
    return da, db


@pytest.mark.parametrize("need_a,need_b", [(True, True), (False, True), (True, False)])
@pytest.mark.parametrize("case", checks.BF16_MATMUL_BWD_CASES,
                         ids=[c[0] for c in checks.BF16_MATMUL_BWD_CASES])
def test_matmul_bwd_plan_bf16_covers_each_element_once(case, need_a, need_b):
    _, m, k, n, *_ = case
    da, db = _covered(m, k, n, need_a, need_b)
    assert (da == need_a).all() and (db == need_b).all()


def test_plans_mirror_the_sources():
    """The planners' view of the kernels: the FC backward's block shapes
    (matmul.cu bwd16), and the bf16 forward's K chunk (conv.cu) taken as
    bf16_gemm.cuh rounds it, to whole 16-deep steps."""
    mm = (build.CSRC / "matmul.cu").read_text()
    for name, value in (("R", build.BWD16_R), ("MT", build.BWD16_MT),
                        ("TK", build.BWD16_TK), ("TN", build.BWD16_TN)):
        assert f"constexpr int {name} = {value};" in mm.split("namespace bwd16")[1], name
    fwd = (build.CSRC / "conv.cu").read_text().split("bf16 forward on wgb_gemm.cuh")[1]
    assert "bfg::k_chunk_for(K, splits)" in fwd
    assert "constexpr int KSTEP = 16;" in (build.CSRC / "bf16_gemm.cuh").read_text()


def test_matmul_bwd_plan_bf16_fills_the_card_at_the_fc():
    """The FC at batch 32: da's 2048 columns in 128 slabs and db's 128
    tiles, together at least one block per SM."""
    da, db = build.matmul_bwd_plan_bf16(32, 2048, 1000)
    assert (da, db) == (128, 128) and da + db >= 132
    assert build.matmul_bwd_plan_bf16(32, 2048, 1000, need_a=False) == (0, 128)


@pytest.mark.parametrize("need_a,need_b", [(True, True), (False, True), (True, False)])
def test_matmul_bwd_bf16_is_one_launch_with_its_plan(launches, need_a, need_b):
    m, k, n = 32, 2048, 1000
    a, b, g = (torch.zeros(s, dtype=torch.bfloat16) for s in ((m, k), (k, n), (m, n)))
    da, db = matmul.matmul_bwd(a, b, g, need_a, need_b)
    assert (da is None, db is None) == (not need_a, not need_b)
    (name, args), = launches
    assert name == "rt_matmul_bwd_bf16"
    assert args[3] is None if not need_a else args[3] == da.data_ptr()
    assert args[4] is None if not need_b else args[4] == db.data_ptr()
    assert args[5:] == (m, k, n, *build.matmul_bwd_plan_bf16(m, k, n, need_a, need_b))
