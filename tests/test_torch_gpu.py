"""The port's CUDA kernels against their plain PyTorch versions on the card.

The same checks as phase 3 of chip_smoke.py (resnet_tpu_torch.kernels.checks),
one test per kernel and shape, so each can be rerun alone on a GPU:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

the kernels on tc_gemm.cuh's tensor-core core alone with
``-k "conv2d or fused_conv"``, and K10 on the wgmma core (wg_gemm.cuh) with
its weight split alone with ``-k "block_fused or split_tf32"``, and the
clean variant's batch-224 shapes (K1's stem, K2, K2b, K4) with
``-k "batch 224"``, and the bf16 entry points (each element within one
bf16 ulp of the plain value plus 1e-5 of max) with ``-k bf16``, the
kernels on the bf16 wgmma + TMA core (wgb_gemm.cuh: K1's bf16 dW, K8- and
K10-bf16) with ``-k "conv2d_dw_bf16 or fused_conv_bf16 or block_fused_bf16"``,
K1's bf16 forward on that core's persistent kernel and K3's one-launch bf16
backward with ``-k "conv2d_bf16 or matmul_bwd_bf16"``, K1's bf16 dx and K3's
bf16 forward on the same persistent kernel, with the witnesses of their bits
through bf16_gemm.cuh, with ``-k "conv2d_dx_bf16 or matmul_bf16"``, the int8
serving kernels (Q1, Q3, Q2; each bit for bit against its plain version,
Q1 also on the shapes its tiles and K splits must get right, Q3 on the
edges of its halo tiles and column blocks and on ragged and misaligned
shapes, and a quantized ResNet-50 and ResNeXt-50 forward
against the plain int8 forward) with ``-k "qconv or quant_act or
quantized"``, and what the parallel steps add (K10's stage entries against
its one call, the statistics' sums Function on K8's sums, K3 on a class
slice) with ``-k "stage_entries or sum_stats_on or class_slice"``.

Without a CUDA device every test here skips.
"""

import pytest
import torch

from resnet_tpu_torch.kernels import checks

pytestmark = pytest.mark.gpu

CASES = [(name, case) for name, (*_, cases) in checks.KERNELS.items() for case in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checks.fp32_strict()


@pytest.mark.parametrize("name,case", CASES, ids=[f"{n}: {c[0]}" for n, c in CASES])
def test_kernel_matches_plain(cuda, name, case):
    mod, counter, per_call, _ = checks.KERNELS[name]
    before = getattr(mod, counter)
    r = checks.check_case(name, case, timing=False)
    if not name.endswith("_bf16"):  # a bf16 case is held per element by check_case
        assert r["rel_err"] <= checks.REL_TOL
    # the kernel ran, not the plain version (twice for a repeated GEMM)
    runs = 2 if name in checks.REPEAT_KERNELS else 1
    assert getattr(mod, counter) == before + runs * per_call


DW_REPEAT = [c for c in checks.TRAIN_DW_CASES
             if c[0].startswith(("stem", "proj", "split K"))]


@pytest.mark.parametrize("case", DW_REPEAT, ids=[c[0] for c in DW_REPEAT])
def test_conv2d_dw_repeats_bit_for_bit(cuda, case):
    """dW splits K (131, 4 and 3 splits here) through a workspace added in
    split order, with no atomics: two runs on the same inputs give the same
    bits."""
    from resnet_tpu_torch.kernels import conv

    _, n, h, cin, cout, k, s = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda")
    g = torch.randn(n, h // s, h // s, cout, generator=gen, device="cuda")
    first = conv.conv2d_dw(x, g, k, s)
    assert torch.equal(first, conv.conv2d_dw(x, g, k, s))


DX_REPEAT = [c for c in checks.TRAIN_DX_CASES
             if c[0].startswith(("proj", "split K", "ragged"))]


@pytest.mark.parametrize("case", DX_REPEAT, ids=[c[0] for c in DX_REPEAT])
def test_conv2d_dx_repeats_bit_for_bit(cuda, case):
    """dx on tc_gemm.cuh: the strided phases, a K split (5 splits) through
    the workspace in split order, and the 4-byte copies give the same bits
    on a second run."""
    from resnet_tpu_torch.kernels import conv

    _, n, h, cin, cout, k, s = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(n, h // s, h // s, cout, generator=gen, device="cuda")
    w = torch.randn(k, k, cin, cout, generator=gen, device="cuda")
    first = conv.conv2d_dx(g, w, (n, h, h, cin), s)
    assert torch.equal(first, conv.conv2d_dx(g, w, (n, h, h, cin), s))


FWD_REPEAT = [c for c in checks.FWD_CONV_CASES
              if c[0].startswith(("stem", "1x1 7^2", "ragged"))]


@pytest.mark.parametrize("case", FWD_REPEAT, ids=[c[0] for c in FWD_REPEAT])
def test_conv2d_repeats_bit_for_bit(cuda, case):
    """The forward on tc_gemm.cuh: the stem (K = 147, 4-byte copies), the
    stage-4 1x1 whose GEMM splits K (build.tc_split), and the ragged widths
    give the same bits on a second run."""
    from resnet_tpu_torch.kernels import conv

    _, n, h, cin, cout, k, s = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda")
    w = torch.randn(k, k, cin, cout, generator=gen, device="cuda")
    first = conv.conv2d(x, w, s)
    assert torch.equal(first, conv.conv2d(x, w, s))


@pytest.mark.parametrize("case", checks.MATMUL_BWD_CASES,
                         ids=[c[0] for c in checks.MATMUL_BWD_CASES])
def test_matmul_bwd_repeats_bit_for_bit(cuda, case):
    """The FC backward: each block sums its contraction in one fixed order
    (da's warps added in warp order), so two runs give the same bits, and
    one launch computes whichever products are asked for."""
    from resnet_tpu_torch.kernels import matmul

    _, m, k, n, offset, need_a, need_b = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda")
    b = torch.randn(k * n + offset, generator=gen, device="cuda")[offset:].view(k, n)
    g = torch.randn(m, n, generator=gen, device="cuda")
    before = matmul.BWD_LAUNCHES
    first = matmul.matmul_bwd(a, b, g, need_a, need_b)
    again = matmul.matmul_bwd(a, b, g, need_a, need_b)
    assert matmul.BWD_LAUNCHES == before + 2
    assert [t is None for t in first] == [not need_a, not need_b]
    assert all(x is None or torch.equal(x, y) for x, y in zip(first, again))


FUSED_REPEAT = [c for c in checks.FUSED_CONV_CASES
                if c[0].startswith(("reduce", "proj", "ragged"))]


@pytest.mark.parametrize("case", FUSED_REPEAT, ids=[c[0] for c in FUSED_REPEAT])
def test_fused_conv_repeats_bit_for_bit(cuda, case):
    """K8 on tc_gemm.cuh: y and its sums (the epilogue's per-tile partials,
    or the column pass over a split-K y, added in double in a fixed order)
    give the same bits on a second run."""
    from resnet_tpu_torch.kernels import fused_conv

    _, n, h, cin, cout, k, s, prologue, cap = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda")
    w = torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.1
    scale = 1 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    shift = 0.5 * torch.randn(cin, generator=gen, device="cuda")
    y, sums = fused_conv.fused_conv(x, w, scale, shift, s, None, prologue, True, cap)
    y2, sums2 = fused_conv.fused_conv(x, w, scale, shift, s, None, prologue, True, cap)
    assert torch.equal(y, y2) and torch.equal(sums, sums2)


def test_fused_conv_halo_is_exact_against_plain(cuda):
    """K8's halo case: a 3x3 prologue whose shift makes act(shift) = shift
    > 0 on every channel, on integer values that any order of summation
    keeps exact: y and both sums equal the plain version's bit for bit, so
    no tap outside the image became act(shift)."""
    case = next(c for c in checks.FUSED_CONV_CASES if c[0].startswith("halo"))
    r = checks.check_case("fused_conv", case, timing=False)
    assert r["max_abs_err"] == 0.0


FUSED_TILES = [(name, c) for name in ("fused_conv", "fused_conv_bf16")
               for c in checks.FUSED_TILE_CASES]


@pytest.mark.parametrize("name,case", FUSED_TILES, ids=[f"{n}: {c[0]}" for n, c in FUSED_TILES])
def test_fused_conv_tiles_repeat_bit_for_bit(cuda, name, case):
    """K8 and K8-bf16 on a rank's tile under spatial partitioning (JAX's
    explicit padding: an interior tile, an odd first row at stride 2 with
    padding 0 and -1, stage 4's 4- and 3-row tiles, the seam): two launches
    give the same y and sums, each launch counted."""
    from resnet_tpu_torch.kernels import fused_conv

    counter = "LAUNCHES_BF16" if name.endswith("_bf16") else "LAUNCHES"
    c = checks._make(name, case, torch.Generator(device="cuda").manual_seed(0), "cuda")
    before = getattr(fused_conv, counter)
    first, again = c.run(), c.run()
    torch.cuda.synchronize()
    assert getattr(fused_conv, counter) == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))


@pytest.mark.parametrize("name", ["fused_conv", "fused_conv_bf16"])
def test_fused_conv_seam_is_exact_against_plain(cuda, name):
    """The seam tile (a halo row of the rank above, the image's edge below,
    padding (0, 1)) with act(shift) > 0 on integer values: y and both sums
    equal the plain version's with the same padding bit for bit, so the
    halo row took the prologue once and the padded row stayed 0."""
    case = next(c for c in checks.FUSED_TILE_CASES if "seam" in c[0])
    r = checks.check_case(name, case, timing=False)
    assert r["max_abs_err"] == 0.0


def test_default_config_runs_plain_convs_in_fp32(monkeypatch):
    """matmul_precision on the card: under the default config ('highest'),
    with the flags as torch ships them (cuDNN's TF32 on) and no
    fp32_strict(), every plain conv inside ``forward`` sees both TF32 flags
    off, and the caller's flags are back after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.nn.functional as F

    from resnet_tpu_torch.config import ExecutionConfig, tiny_model_config
    from resnet_tpu_torch.models import forward, init_params

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen, conv2d = [], F.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording_conv2d)
    mcfg = tiny_model_config()
    params = init_params(torch.Generator().manual_seed(0), mcfg, device="cuda")
    x = torch.randn(2, mcfg.input_dim, mcfg.input_dim, 3, device="cuda")
    logits, _ = forward(params, x, mcfg, ExecutionConfig(), train=True)
    torch.cuda.synchronize()
    assert logits.is_cuda and seen and all(flags == (False, False) for flags in seen)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
        True, True)


def test_backward_on_cuda_moves_the_backward_counters(cuda):
    """A tiny conv -> add_relu -> matmul graph on the card: its backward runs
    the dx, dW and mask kernels and one matmul-backward launch for both of
    the FC's gradients, and matches the plain versions' gradients on the
    CPU."""
    from resnet_tpu_torch.kernels import conv, fused, matmul

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 8, 4, generator=gen)
    w = torch.randn(3, 3, 4, 6, generator=gen) * 0.2
    fc = torch.randn(6 * 16, 5, generator=gen) * 0.1

    def run(device):
        leaves = [t.to(device).requires_grad_(True) for t in (x, w, fc)]
        y = conv.conv2d(leaves[0], leaves[1], 2)
        y = fused.add_relu(y, y * 0.5)
        out = matmul.matmul(y.reshape(2, -1), leaves[2])
        return torch.autograd.grad(out.square().sum(), leaves)

    before = (conv.DX_LAUNCHES, conv.DW_LAUNCHES, fused.MASK_LAUNCHES,
              matmul.BWD_LAUNCHES)
    got = run("cuda")
    after = (conv.DX_LAUNCHES, conv.DW_LAUNCHES, fused.MASK_LAUNCHES,
             matmul.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    for g, want in zip(got, run("cpu")):
        torch.testing.assert_close(g.cpu(), want, rtol=1e-4, atol=1e-5)


def test_fused_conv_keeps_the_halo_at_zero_on_cuda(cuda):
    """K8 with scale 0 and shift 1: every in-image element of u is 1, so an
    all-ones 3x3 filter counts each window's in-image taps (4 in a corner,
    6 on an edge, 9 inside, times Cin); relu(shift) in the halo would make
    them all 9. Stride 1 and 2, and the sums of those counts."""
    from resnet_tpu_torch.kernels import fused_conv

    cin = 3
    x = torch.randn(1, 6, 6, cin, device="cuda")
    w = torch.ones(3, 3, cin, 1, device="cuda")
    scale, shift = torch.zeros(cin, device="cuda"), torch.ones(cin, device="cuda")
    taps = torch.tensor([2.0, 3, 3, 3, 3, 2])
    for stride in (1, 2):
        before = fused_conv.LAUNCHES
        y, sums = fused_conv.fused_conv(x, w, scale, shift, stride)
        assert fused_conv.LAUNCHES == before + 1
        want = torch.outer(taps, taps)[::stride, ::stride] * cin
        assert torch.equal(y[0, :, :, 0].cpu(), want)
        assert torch.equal(sums[:, 0].cpu(), torch.stack([want.sum(), (want ** 2).sum()]))


def test_block_fused_on_cuda_matches_the_cpu(cuda):
    """K10 through block_fused on the card: one launch per call, and its
    outputs and the closed-form gradients of all ten inputs match the plain
    version's on the CPU, with a cap that clips and the sums in the loss."""
    from resnet_tpu_torch.kernels import block_fused

    gen = torch.Generator().manual_seed(0)
    c4, c = 36, 9
    t = [torch.randn(*s, generator=gen) * 0.3
         for s in ((c4, c), (3, 3, c, c), (c, c4), (c,), (c,), (c,), (c,), (c4,), (c4,))]
    args = [torch.randn(2, 5, 5, c4, generator=gen).clamp_min(0.0), *t]
    for i in (4, 6, 8):
        args[i] = args[i] + 1.0  # the gammas near 1
    cts = [torch.randn(2, 5, 5, c4, generator=gen), torch.randn(2, c, generator=gen),
           torch.randn(2, c, generator=gen), torch.randn(2, c4, generator=gen)]

    def run(device):
        leaves = [a.to(device).requires_grad_(True) for a in args]
        outs = block_fused.block_fused(*leaves, 1e-7, 1.5)
        grads = torch.autograd.grad(outs, leaves, [ct.to(device) for ct in cts])
        return [o.detach().cpu() for o in outs] + [g.cpu() for g in grads]

    before = block_fused.LAUNCHES
    got = run("cuda")
    assert block_fused.LAUNCHES == before + 1
    for g, want in zip(got, run("cpu"), strict=True):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("case", checks.SPLIT_CASES, ids=[c[0] for c in checks.SPLIT_CASES])
def test_split_tf32_is_its_plain_version_bit_for_bit(cuda, case):
    """K10's weight split (the wgmma core's K-major tf32 hi and lo, cvt.rna)
    at the shapes of the twelve weights of ResNet-50's identity blocks and
    two ragged ones, every eighth element an exact tie: the kernel equals
    split_tf32_reference bit for bit, one launch per call."""
    from resnet_tpu_torch.kernels import block_fused

    before = block_fused.SPLIT_LAUNCHES
    checks.check_split(case, timing=False)
    assert block_fused.SPLIT_LAUNCHES == before + 1


# (x shape, C): 64 channels on 128 x 64 tiles with M = 162 rows, not a
# multiple of the 128-row tile, and the same rows at C = 128 (128 x 128 tiles)
BLOCK_RAGGED_ROWS = [((2, 9, 9, 256), 64), ((2, 9, 9, 512), 128)]


@pytest.mark.parametrize("shape,c", BLOCK_RAGGED_ROWS, ids=["C64", "C128"])
def test_block_fused_ragged_rows(cuda, shape, c):
    """K10 where M = 162 leaves the last 128-row tile a third full: within
    1e-4 of max|plain| on every output, the same bits on a second run, one
    launch per call."""
    from resnet_tpu_torch.kernels import block_fused

    before = block_fused.LAUNCHES
    r = checks.check_case("block_fused", (f"rows 162 C={c}", shape, c, None), timing=False)
    assert r["rel_err"] <= checks.REL_TOL
    assert block_fused.LAUNCHES == before + 2


@pytest.mark.parametrize("case", checks.MOMENTS_CASES, ids=[c[0] for c in checks.MOMENTS_CASES])
def test_moments_repeats_bit_for_bit(cuda, case):
    """K4 adds its chunk partials in one fixed order with no atomics in any
    sum: two calls give the same bits, one launch each, and the last block
    of every tile leaves its ticket at 0 (in the raw-sums mode too)."""
    from resnet_tpu_torch.kernels import bn

    _, m, c, *mode = case
    fn = bn.moments_sums if mode else bn.moments
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5
    before = bn.LAUNCHES
    first, again = fn(x), fn(x)
    assert bn.LAUNCHES == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    _, tickets = bn._WORKSPACES[(x.device.index, stream)]
    torch.cuda.synchronize()
    assert not tickets.any()


def test_moments_back_to_back_at_two_shapes(cuda):
    """Calls at other shapes enqueued one after another on one stream with
    no synchronize among them share the workspace: each finds its tickets
    at 0 and gives the bits of the same call made alone."""
    from resnet_tpu_torch.kernels import bn

    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [torch.randn(m, c, generator=gen, device="cuda") + 1.0
          for m, c in ((32 * 56 * 56, 256), (1000, 33), (32 * 7 * 7, 2048))]
    alone = []
    for x in xs:
        alone.append(bn.moments(x))
        torch.cuda.synchronize()
    queued = [bn.moments(x) for x in (*xs, *xs)]
    torch.cuda.synchronize()
    for i, got in enumerate(queued):
        assert all(torch.equal(a, b) for a, b in zip(got, alone[i % 3], strict=True))


# (label, M, C, relu, storage offset in elements): K6 at phase 3's eight
# cases, then ragged channels, M below one row chunk, and views off a
# 16-byte boundary (its one-value lanes)
BN_BWD_GPU = [(label, m, c, relu, 0) for label, m, c, relu in checks.BN_BWD_CASES] + [
    ("(200, 9) relu", 200, 9, True, 0), ("(50, 64) below a chunk", 50, 64, False, 0),
    ("(1568, 2048) relu, offset 1", 1568, 2048, True, 1),
    ("(1000, 64), offset 4", 1000, 64, False, 4)]


def _bn_bwd_inputs(m, c, offset, dtype, seed=0):
    """x (an (m, c) view ``offset`` elements into its storage), dy and the
    fp32 rows mean, inv_std, gamma, beta of a K6 call."""
    from resnet_tpu_torch.kernels import bn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.empty(m * c + offset, dtype=dtype, device="cuda")[offset:].view(m, c)
    x.copy_(torch.randn(m, c, generator=gen, device="cuda") * 2.0
            + torch.randn(1, c, generator=gen, device="cuda"))
    dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
    mean, var = bn.moments_reference(x)
    gamma = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    return x, dy, mean, torch.rsqrt(var + 1e-7), gamma, beta


def _held_to(got, want):
    """K6's outputs against the plain version's: fp32 within 1e-4 of
    max|plain|, a bf16 dx by ``_held_bf16`` (its fp32 dγ, dβ within 1e-5)."""
    for g, w in zip(got, want, strict=True):
        if got[0].dtype is torch.bfloat16:
            _held_bf16(g, w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert (g - w).abs().max() <= checks.REL_TOL * w.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("label,m,c,relu,offset", BN_BWD_GPU, ids=[c[0] for c in BN_BWD_GPU])
def test_bn_bwd_matches_plain_and_repeats_bit_for_bit(cuda, dtype, label, m, c, relu, offset):
    """K6 (``bn.bn_bwd``) against ``bn_bwd_reference`` on the same inputs,
    one launch counted a call; a second call gives the same bits (one fixed
    order in every sum, the ticket the only atomic) and the kernel leaves
    every ticket at 0."""
    from resnet_tpu_torch.kernels import bn

    args = _bn_bwd_inputs(m, c, offset, dtype)
    counter = "BWD_LAUNCHES_BF16" if dtype is torch.bfloat16 else "BWD_LAUNCHES"
    before = getattr(bn, counter)
    first = bn.bn_bwd(*args, relu=relu)
    again = bn.bn_bwd(*args, relu=relu)
    assert getattr(bn, counter) == before + 2
    _held_to(first, bn.bn_bwd_reference(*args, relu=relu))
    assert all(torch.equal(a, b) for a, b in zip(first, again, strict=True))
    stream = torch._C._cuda_getCurrentRawStream(args[0].device.index)
    _, tickets = bn._WORKSPACES[(args[0].device.index, stream)]
    torch.cuda.synchronize()
    assert not tickets.any()


def test_bn_bwd_back_to_back_finds_its_tickets_at_zero(cuda):
    """K6 calls at other shapes and dtypes enqueued one after another on one
    stream, with no synchronize among them and K4 between them (the two
    share the workspace): each finds its tickets at 0 and gives
    the bits of the same call made alone."""
    from resnet_tpu_torch.kernels import bn

    cases = [(32 * 28 * 28, 512, True, torch.bfloat16), (1000, 33, False, torch.float32),
             (32 * 7 * 7, 2048, True, torch.float32), (50, 64, True, torch.bfloat16)]
    inputs = [(_bn_bwd_inputs(m, c, 0, dtype, seed=i), relu)
              for i, (m, c, relu, dtype) in enumerate(cases)]
    alone = []
    for args, relu in inputs:
        alone.append(bn.bn_bwd(*args, relu=relu))
        torch.cuda.synchronize()
    queued = []
    for _ in range(2):
        for args, relu in inputs:
            queued.append(bn.bn_bwd(*args, relu=relu))
            bn.moments(args[0])
    torch.cuda.synchronize()
    for i, got in enumerate(queued):
        assert all(torch.equal(a, b) for a, b in zip(got, alone[i % len(cases)], strict=True))


def test_bn_bwd_streams_do_not_share_a_workspace(cuda):
    """Two K6 calls in flight at once on two streams, each with its own
    partials and tickets: both give the bits of the call made alone."""
    from resnet_tpu_torch.kernels import bn

    shapes = [(32 * 112 * 112, 64, torch.bfloat16), (32 * 28 * 28, 512, torch.float32)]
    inputs = [_bn_bwd_inputs(m, c, 0, dtype, seed=i) for i, (m, c, dtype) in enumerate(shapes)]
    alone = [bn.bn_bwd(*args, relu=True) for args in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for _ in range(3):
        for stream, args in zip(streams, inputs):
            with torch.cuda.stream(stream):
                got.append(bn.bn_bwd(*args, relu=True))
    torch.cuda.synchronize()
    for i, out in enumerate(got):
        assert all(torch.equal(a, b) for a, b in zip(out, alone[i % 2], strict=True))
    index = inputs[0][0].device.index
    spaces = [bn._WORKSPACES[(index, s.cuda_stream)] for s in streams]
    assert spaces[0][0].data_ptr() != spaces[1][0].data_ptr()
    assert spaces[0][1].data_ptr() != spaces[1][1].data_ptr()
    assert not any(ws[1].any() for ws in spaces)


def _adam_step_against_plain(p, g, m, v, h):
    """fused_adam in place on (p, m, v) against adam_leaf_reference from the
    same state: one launch count, the same non-finite positions, the finite
    values within 1e-4 of max|plain| per list."""
    from resnet_tpu_torch.kernels import adam

    want = [adam.adam_leaf_reference(*t, h) for t in zip(p, g, m, v)]
    before = adam.LAUNCHES
    adam.fused_adam(p, g, m, v, h)
    assert adam.LAUNCHES == before + 1
    for k, got in enumerate((p, m, v)):
        a = torch.cat([t.reshape(-1) for t in got])
        b = torch.cat([w[k].reshape(-1) for w in want])
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        assert (a[fin] - b[fin]).abs().max() <= checks.REL_TOL * b[fin].abs().max()


def _adam_tensors(sizes, gen, offset=0):
    """(p, g, m, v) lists of the given sizes on the card, each tensor cut
    ``offset`` floats into its own storage."""
    def make(n, scale, square=False):
        t = torch.randn(n + offset, generator=gen, device="cuda") * scale
        return (t * t if square else t)[offset:]

    return ([make(n, 0.1) for n in sizes], [make(n, 1e-2) for n in sizes],
            [make(n, 1e-3) for n in sizes], [make(n, 1e-2, True) for n in sizes])


def _hyper():
    from resnet_tpu_torch.kernels import adam

    return adam.hyper_row(1e-3, 1e-2, 0.9, 0.999, 1e-7, 0.9 ** 3, 0.999 ** 3, True, "cuda")


def test_fused_adam_beyond_one_parameter_bank(cuda):
    """More tensors than one launch's parameters hold (MAX_ROWS rows): the
    call launches once per group, counts one launch, and every tensor of
    every group matches the plain version, with non-finite gradients and a
    non-finite parameter kept by the guard and a tensor without elements."""
    from resnet_tpu_torch.kernels import adam

    gen = torch.Generator(device="cuda").manual_seed(2)
    sizes = [(i * 37) % 5000 + 1 for i in range(2 * adam.MAX_ROWS + 37)]
    sizes[5] = 0
    p, g, m, v = _adam_tensors(sizes, gen)
    g[3][:2] = torch.tensor([float("nan"), float("inf")])
    g[-1][-1] = float("nan")
    p[adam.MAX_ROWS + 1][0] = float("inf")
    _adam_step_against_plain(p, g, m, v, _hyper())


@pytest.mark.parametrize("where", ["all misaligned", "gradients misaligned"])
def test_fused_adam_misaligned_and_ragged(cuda, where):
    """Tensors whose base is not 16-byte aligned and sizes not a multiple of
    4 take the one-element loop, aligned ones with 4 | numel the 16-byte
    one; a misaligned gradient alone takes its tensor off the 16-byte loop
    (the C entry point's check)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = [4096 * 3 + 1, 4096 * 2, 7, 4, 12345, 8192 + 4]
    if where == "all misaligned":
        p, g, m, v = _adam_tensors(sizes, gen, offset=1)
        assert all(t.data_ptr() % 16 for t in (*p, *g, *m, *v))
    else:
        p, _, m, v = _adam_tensors(sizes, gen)
        _, g, _, _ = _adam_tensors(sizes, gen, offset=1)
        assert all(t.data_ptr() % 16 for t in g)
        assert not any(t.data_ptr() % 16 for t in (*p, *m, *v))
    _adam_step_against_plain(p, g, m, v, _hyper())


def test_fused_adam_rebuilds_its_rows_for_a_new_tensor(cuda):
    """A parameter replaced by a new tensor, and a moment moved to another
    storage, between two steps: the second step updates the new tensors and
    leaves the old ones alone."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = [300, 4096, 10]
    p, g, m, v = _adam_tensors(sizes, gen)
    h = _hyper()
    _adam_step_against_plain(p, g, m, v, h)
    old_p, old_m = p[1], m[2].clone()
    p[1] = p[1].clone()
    m[2].data = m[2].clone()
    kept = old_p.clone()
    _adam_step_against_plain(p, g, m, v, h)
    torch.cuda.synchronize()
    assert torch.equal(old_p, kept)
    assert not torch.equal(m[2], old_m)


@pytest.mark.parametrize("transfer", [None, "bfloat16"])
def test_prefetcher_stages_batches_on_the_card(cuda, transfer):
    """data.prefetch on the card: batches through 3 pinned slots and a side
    stream arrive in order and intact. The consumer reads each batch only
    after long work on its own stream and drops it at once, so a slot
    refilled before its copy ended, or memory handed out again to the side
    stream without record_stream, shows as a wrong copy. The bf16 cast
    rounds on the host as torch's CPU cast does."""
    import numpy as np

    from resnet_tpu_torch.data import prefetch_to_device

    rng = np.random.default_rng(0)
    batches = [{"images": rng.normal(0, 50, (32, 224, 224, 3)).astype(np.float32),
                "labels": np.arange(32, dtype=np.int32) + i, "cursor": i} for i in range(10)]
    pre = prefetch_to_device(iter(batches), depth=2, transfer_dtype=transfer)
    copies = []
    try:
        for i in range(len(batches)):
            got = next(pre)
            assert got["cursor"] == i and got["images"].is_cuda
            churn = torch.randn(4096, 4096, device="cuda")
            for _ in range(8):
                churn = churn @ churn / 64
            copies.append((got["images"].clone(), got["labels"].clone()))
            del got
        with pytest.raises(StopIteration):
            next(pre)
    finally:
        pre.stop()
    for i, (want, (images, labels)) in enumerate(zip(batches, copies)):
        expect = torch.from_numpy(want["images"])
        expect = expect.to(torch.bfloat16) if transfer else expect
        assert torch.equal(images.cpu(), expect), f"batch {i}"
        assert torch.equal(labels.cpu(), torch.from_numpy(want["labels"])), f"batch {i}"


def test_bf16_step_launches_the_bf16_entry_points_only(cuda):
    """A bf16 training step of the tiny model on every standard-path hand
    kernel moves the bf16 counters and, of the fp32 ones, Adam's alone."""
    from resnet_tpu_torch import config as tcfg
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, make_train_step

    cfg = tcfg.TrainConfig(
        model=tcfg.tiny_model_config(),
        execution=tcfg.ExecutionConfig(kernels="pallas", conv_kernels="pallas",
                                       compute_dtype="bfloat16"),
        optimizer=tcfg.OptimizerConfig(fused=True))
    state = init_train_state(cfg, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(SyntheticDataset(4, image_dim=16, num_classes=8)).items()}
    before = {n: getattr(m, c) for n, (m, c, *_) in checks.KERNELS.items()}
    state, metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    moved = {n: getattr(m, c) - before[n] for n, (m, c, *_) in checks.KERNELS.items()
             if getattr(m, c) != before[n]}
    assert moved == {"conv2d_bf16": 9, "conv2d_dx_bf16": 8, "conv2d_dw_bf16": 9,
                     "moments_bf16": 9, "add_relu_bf16": 2, "add_relu_mask_bf16": 2,
                     "matmul_bf16": 1, "matmul_bwd_bf16": 1, "adam": 1}
    assert torch.isfinite(metrics["loss"]).item()


def test_bf16_frozen_bn_check_catches_a_wrong_dw(cuda, monkeypatch):
    """chip_smoke.py's well-conditioned check of the bf16 kernel step
    (phase 11, ``_bf16_frozen_held``) passes ResNet-50's bf16 step at batch
    32 on every standard-path hand kernel, and fails it once the bf16 dW
    kernel's results are scaled by 1.1."""
    import dataclasses

    import chip_smoke
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.kernels import conv
    from resnet_tpu_torch.train import init_train_state

    base = variant_config("resnet")

    def with_(**execution):
        return dataclasses.replace(base, execution=dataclasses.replace(base.execution,
                                                                       **execution))

    kcfg = with_(conv_kernels="pallas", compute_dtype="bfloat16")
    p16, p32 = with_(kernels="xla", compute_dtype="bfloat16"), with_(kernels="xla")
    state0 = init_train_state(kcfg, torch.Generator().manual_seed(1234), device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(SyntheticDataset(
        32, image_dim=224, num_classes=base.model.num_classes, seed=1234)).items()}
    chip_smoke._bf16_frozen_held(kcfg, p16, p32, state0, batch)
    dw = conv.conv2d_dw
    monkeypatch.setattr(conv, "conv2d_dw", lambda x, g, k, stride=1, padding=None: dw(
        x, g, k, stride, padding) * (1.1 if x.dtype is torch.bfloat16 else 1.0))
    with pytest.raises(RuntimeError, match="BN frozen"):
        chip_smoke._bf16_frozen_held(kcfg, p16, p32, state0, batch)


# (engine, tiny-model overrides, counts of one bf16 step): the tiny model's
# 2 blocks hold 8 fused-conv sites (3 convs and a projection each; the stem
# conv, the FC and the gradient convs are plain) and 2 joins; with two
# blocks per stage, 'blockfused' routes the 2 identity blocks to K10
ENGINE_BF16_STEPS = [
    ("fused", {}, {"fused_conv_bf16": 8, "fused_join_bf16": 2, "bias_act_bf16": 1,
                   "moments_bf16": 1, "adam": 1}),
    ("hybrid", {}, {"fused_join_bf16": 2, "bias_act_bf16": 1, "moments_bf16": 1,
                    "adam": 1}),
    ("fusedxla", {}, {"adam": 1}),
    ("blockfused", dict(block_sizes=(2, 2)), {"block_fused_bf16": 2, "adam": 1}),
]


@pytest.mark.parametrize("kernels,model,expect", ENGINE_BF16_STEPS,
                         ids=[e for e, *_ in ENGINE_BF16_STEPS])
@pytest.mark.parametrize("param", ["float32", "bfloat16"])
def test_bf16_engine_step_launches_the_bf16_entry_points_only(cuda, kernels, model, expect,
                                                               param):
    """A bf16 training step of the tiny model under a fused or whole-block
    engine, with fp32 or bf16 parameters, moves the bf16 counters of its
    kernels and, of the fp32 ones, Adam's alone; the parameters keep their
    dtype."""
    from resnet_tpu_torch import bridge
    from resnet_tpu_torch import config as tcfg
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, make_train_step

    cfg = tcfg.TrainConfig(
        model=tcfg.tiny_model_config(**model),
        execution=tcfg.ExecutionConfig(kernels=kernels, compute_dtype="bfloat16",
                                       param_dtype=param),
        optimizer=tcfg.OptimizerConfig(fused=True))
    state = init_train_state(cfg, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in next(SyntheticDataset(4, image_dim=16, num_classes=8)).items()}
    before = {n: getattr(m, c) for n, (m, c, *_) in checks.KERNELS.items()}
    state, metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    moved = {n: getattr(m, c) - before[n] for n, (m, c, *_) in checks.KERNELS.items()
             if getattr(m, c) != before[n]}
    assert moved == expect
    assert torch.isfinite(metrics["loss"]).item()
    assert all(p.dtype == tcfg.resolve_dtype(param) for p in bridge.leaves(state.params))


def test_fused_conv_bf16_sums_are_the_accumulators_on_cuda(cuda):
    """K8-bf16's [Σy, Σy²] come from its fp32 accumulator: within 1e-5 of
    max of the plain version's (the fp32 conv of the rounded u and w) and
    farther than that from the sums of the kernel's own rounded y, at one
    split and at a K split (statistics from the fp32 split sum)."""
    from resnet_tpu_torch.kernels import fused_conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, h, cin, cout in ((8, 14, 256, 256), (2, 7, 129, 33)):
        x = torch.randn(n, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 0.05).to(
            torch.bfloat16)
        scale = 1 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
        shift = 0.5 * torch.randn(cin, generator=gen, device="cuda")
        y, sums = fused_conv.fused_conv(x, w, scale, shift, 1)
        _, want = fused_conv.fused_conv_reference(x, w, scale, shift, 1)
        scale_ = want.abs().amax(1, keepdim=True)
        assert ((sums - want).abs() <= 1e-5 * scale_).all()
        rounded = fused_conv.channel_sums(y)
        assert ((rounded - want).abs().amax(1) > 1e-5 * scale_[:, 0]).all()


def _held_bf16(got, want):
    """got within one bf16 ulp of each plain value plus 1e-5 of max|plain|
    (checks.check_case's rule for a bf16 output; an fp32 one within 1e-5
    of max)."""
    w = want.float()
    slack = checks.bf16_slack(want) + checks.BF16_REL_TOL * w.abs().max()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert ((got.float() - w).abs() <= slack).all()


def _recording(monkeypatch):
    """build.launch still launching, each entry point's name recorded."""
    from resnet_tpu_torch.kernels import build

    names, launch = [], build.launch

    def record(name, *args, device):
        names.append(name)
        launch(name, *args, device=device)

    monkeypatch.setattr(build, "launch", record)
    return names


def _resnet50_dw_shapes():
    from resnet_tpu_torch.config import model_config

    m = model_config("resnet50")
    sites = {(h, cin, cout, k, s) for _, _, h, cin, cout, k, s, *_ in checks.fused_sites(2)}
    return [(m.input_dim, m.in_channels, m.init_filters, m.init_kernel, m.init_stride)] + sorted(
        sites)


DW_SHAPES = _resnet50_dw_shapes()


@pytest.mark.parametrize("shape", DW_SHAPES, ids=[str(s) for s in DW_SHAPES])
def test_conv2d_dw_bf16_takes_the_wgmma_route_on_cuda(cuda, monkeypatch, shape):
    """Each ResNet-50 conv's bf16 dW at batch 2 launches the wgmma core's
    entry point (the stem through its 8-channel padded copy) and holds to
    the plain dW by the bf16 rule."""
    from resnet_tpu_torch.kernels import conv

    h, cin, cout, k, s = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(2, h // s, h // s, cout, generator=gen, device="cuda").to(torch.bfloat16)
    names = _recording(monkeypatch)
    got = conv.conv2d_dw(x, g, k, s)
    assert names == ["rt_conv2d_dw_nhwc_bf16"]
    _held_bf16(got, conv.conv2d_dw_reference(x, g, k, s))


def test_conv2d_dw_bf16_misaligned_takes_the_mma_route_on_cuda(cuda, monkeypatch):
    """x and g whose data start 2 bytes past a 16-byte boundary are no TMA
    boxes: dW takes bf16_gemm.cuh's route (2-byte loads) and holds to the
    plain dW; the same values aligned take the wgmma core to the same
    rule."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, cin, cout = 4, 14, 64, 128
    xa = torch.randn(n * h * h * cin + 1, generator=gen, device="cuda").to(torch.bfloat16)
    ga = torch.randn(n * h * h * cout + 1, generator=gen, device="cuda").to(torch.bfloat16)
    x, g = xa[1:].view(n, h, h, cin), ga[1:].view(n, h, h, cout)
    assert x.data_ptr() % 16 and g.data_ptr() % 16
    names = _recording(monkeypatch)
    want = conv.conv2d_dw_reference(x, g, 3, 1)
    _held_bf16(conv.conv2d_dw(x, g, 3, 1), want)
    _held_bf16(conv.conv2d_dw(x.clone(), g.clone(), 3, 1), want)
    assert names == ["rt_conv2d_dw_nhwc_bf16_mma", "rt_conv2d_dw_nhwc_bf16"]


BF16_DW_REPEAT = [c for c in checks.BF16_DW_CASES if c[0].startswith(("stem", "proj", "1x1"))]


@pytest.mark.parametrize("case", BF16_DW_REPEAT, ids=[c[0] for c in BF16_DW_REPEAT])
def test_conv2d_dw_bf16_repeats_bit_for_bit(cuda, case):
    """K1's bf16 dW on the wgmma core splits K over its pixels (the stem's
    narrow tiles, the 3x3/s2 projection's four stride phases, the 1x1s'
    pixel rows) through fp32 partials added in split order, no atomics:
    two runs give the same bits."""
    from resnet_tpu_torch.kernels import build, conv

    _, n, h, cin, cout, k, s = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(n, h // s, h // s, cout, generator=gen, device="cuda").to(torch.bfloat16)
    first = conv.conv2d_dw(x, g, k, s)
    assert torch.equal(first, conv.conv2d_dw(x, g, k, s))
    assert conv.dw_bf16_route(cin, cout, s) == "wgmma"
    assert build.wgb_split(k * k * max(cin, conv.DW_NARROW), cout, build.WGB_BK *
                           build.dw_slices(n, h // s, h // s, k, s)) > 1


def test_fused_conv_bf16_misaligned_on_cuda(cuda):
    """K8-bf16 on x and w that start 2 bytes past a 16-byte boundary: no
    cp.async or TMA box takes them, so both operands go through the
    threads' 2-byte loads (the prologue applied on the way, the halo left
    at 0); y within the bf16 rule and the fp32 sums within 1e-5 of max of
    the plain version's."""
    from resnet_tpu_torch.kernels import fused_conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, cin, cout = 2, 14, 64, 128
    xa = torch.randn(n * h * h * cin + 1, generator=gen, device="cuda").to(torch.bfloat16)
    wa = (torch.randn(9 * cin * cout + 1, generator=gen, device="cuda") * 0.05).to(
        torch.bfloat16)
    x, w = xa[1:].view(n, h, h, cin), wa[1:].view(3, 3, cin, cout)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    scale = 1 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    shift = 0.5 * torch.randn(cin, generator=gen, device="cuda")
    y, sums = fused_conv.fused_conv(x, w, scale, shift, 1)
    want_y, want_sums = fused_conv.fused_conv_reference(x, w, scale, shift, 1)
    _held_bf16(y, want_y)
    assert ((sums - want_sums).abs() <= 1e-5 * want_sums.abs().amax(1, keepdim=True)).all()


BF16_FUSED_REPEAT = [c for c in checks.BF16_FUSED_CONV_CASES
                     if " proj " in c[0] or c[0].startswith("ragged")]


@pytest.mark.parametrize("case", BF16_FUSED_REPEAT, ids=[c[0] for c in BF16_FUSED_REPEAT])
def test_fused_conv_bf16_repeats_bit_for_bit(cuda, case):
    """K8-bf16 on the wgmma core: y and its sums (the per-tile epilogue, or
    the split sum's statistics where K splits) give the same bits on a
    second run."""
    from resnet_tpu_torch.kernels import fused_conv

    _, n, h, cin, cout, k, s, prologue, cap = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    scale = 1 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    shift = 0.5 * torch.randn(cin, generator=gen, device="cuda")
    y, sums = fused_conv.fused_conv(x, w, scale, shift, s, None, prologue, True, cap)
    y2, sums2 = fused_conv.fused_conv(x, w, scale, shift, s, None, prologue, True, cap)
    assert torch.equal(y, y2) and torch.equal(sums, sums2)


def _resnet50_fwd_shapes():
    from resnet_tpu_torch.config import model_config

    m = model_config("resnet50")
    sites = {(h, cin, cout, k, s) for _, _, h, cin, cout, k, s, *_ in checks.fused_sites(2)}
    return [(m.input_dim, m.in_channels, m.init_filters, m.init_kernel, m.init_stride)] + sorted(
        sites)


FWD_SHAPES = _resnet50_fwd_shapes()


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=[str(s) for s in FWD_SHAPES])
def test_conv2d_bf16_takes_the_wgmma_route_on_cuda(cuda, monkeypatch, shape):
    """Each ResNet-50 conv's bf16 forward at batch 2 launches the wgmma
    core's persistent kernel (the stem on the threads' loads, a 1x1/s1 by
    TMA boxes) and holds to the plain conv by the bf16 rule."""
    from resnet_tpu_torch.kernels import conv

    h, cin, cout, k, s = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    names = _recording(monkeypatch)
    got = conv.conv2d(x, w, s)
    assert names == ["rt_conv2d_nhwc_bf16"]
    _held_bf16(got, conv.conv2d_reference(x, w, s))


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_conv2d_bf16_misaligned_on_cuda(cuda, monkeypatch, k, stride):
    """x whose data start 2 bytes past a 16-byte boundary is no 16-byte
    chunk: the forward takes the threads' 2-byte loads, holds to the plain
    conv, and gives the bits of the same values aligned (the gather, or a
    1x1's TMA boxes): every loader sums the same k16 steps in K order."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, cin, cout = 4, 14, 64, 128
    xa = torch.randn(n * h * h * cin + 1, generator=gen, device="cuda").to(torch.bfloat16)
    x = xa[1:].view(n, h, h, cin)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    assert x.data_ptr() % 16
    m = n * (h // stride) ** 2
    assert conv.fwd_bf16_route(m, cin, cout, k, stride, False) == "scalar"
    assert conv.fwd_bf16_route(m, cin, cout, k, stride) != "scalar"
    names = _recording(monkeypatch)
    got = conv.conv2d(x, w, stride)
    _held_bf16(got, conv.conv2d_reference(x, w, stride))
    assert torch.equal(got, conv.conv2d(x.clone(), w, stride))
    assert names == ["rt_conv2d_nhwc_bf16"] * 2


@pytest.mark.parametrize("m,cin,cout", [(2 * 56 * 56, 64, 256), (8 * 14 * 14, 1024, 512),
                                        (32 * 7 * 7, 2048, 512)])
def test_conv2d_bf16_1x1_has_bf16_gemm_bits_on_cuda(cuda, m, cin, cout):
    """A 1x1/s1 forward y = x @ w on the persistent kernel against the same
    product through K1's bf16 dx (dx = g @ w^T with g = x), with the same
    K split (tc_split of the same shape): the same bits, K split or not.
    Both run on the persistent kernel, the forward with w MN-major, dx with
    it K-major, each keeping bf16_gemm.cuh's 16-deep folds (the witness
    against that core is test_conv2d_dx_bf16_1x1_has_bf16_gemm_bits_on_cuda)."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, 1, 1, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(cin, cout, generator=gen, device="cuda") * cin ** -0.5).to(torch.bfloat16)
    y = conv.conv2d(x, w.view(1, 1, cin, cout), 1)
    dx = conv.conv2d_dx(x, w.t().contiguous().view(1, 1, cout, cin), (m, 1, 1, cout), 1)
    assert torch.equal(y, dx)


@pytest.mark.parametrize("n,h", [(2, 30), (3, 16), (1, 224)])
def test_conv2d_bf16_stem_on_cuda(cuda, n, h):
    """The stem's 3 channels on the threads' loads, at sizes whose rows end
    inside a tile and whose windows meet both image edges: within the bf16
    rule of the plain conv, and exact on integer values, whose sums every
    order keeps."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, 3, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(7, 7, 3, 64, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    _held_bf16(conv.conv2d(x, w, 2), conv.conv2d_reference(x, w, 2))
    xi, wi = (torch.randint(-4, 5, t.shape, generator=gen, device="cuda").to(torch.bfloat16)
              for t in (x, w))
    assert torch.equal(conv.conv2d(xi, wi, 2), conv.conv2d_reference(xi, wi, 2))


BF16_FWD_REPEAT = [c for c in checks.BF16_CONV_CASES
                   if c[0].startswith(("stem", "1x1 7^2", "proj", "3x3 7^2 16"))]


@pytest.mark.parametrize("case", BF16_FWD_REPEAT, ids=[c[0] for c in BF16_FWD_REPEAT])
def test_conv2d_bf16_repeats_bit_for_bit(cuda, case):
    """K1's bf16 forward on the persistent kernel: the stem's 2-byte loads,
    the 1x1's TMA boxes split over K, the projection's gather: each unit's
    sum in one fixed order, splits added in split order, no atomics, so two
    runs give the same bits."""
    from resnet_tpu_torch.kernels import conv

    _, n, h, cin, cout, k, s, *_ = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    first = conv.conv2d(x, w, s)
    assert torch.equal(first, conv.conv2d(x, w, s))


@pytest.mark.parametrize("case", checks.BF16_MATMUL_BWD_CASES,
                         ids=[c[0] for c in checks.BF16_MATMUL_BWD_CASES])
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)],
                         ids=["da+db", "db", "da"])
def test_matmul_bwd_bf16_one_launch_on_cuda(cuda, monkeypatch, case, need):
    """K3's bf16 backward: one launch for whichever products are asked for,
    each within the bf16 rule of the plain product, twice to the same
    bits."""
    from resnet_tpu_torch.kernels import matmul

    _, m, k, n, offset, *_ = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(k * n + offset, generator=gen, device="cuda") * 0.01).to(
        torch.bfloat16)[offset:].view(k, n)
    g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    names = _recording(monkeypatch)
    got = matmul.matmul_bwd(a, b, g, *need)
    assert names == ["rt_matmul_bwd_bf16"]
    for t, want, needed in zip(got, matmul.matmul_bwd_reference(a, b, g), need):
        assert (t is None) == (not needed)
        if needed:
            _held_bf16(t, want)
    again = matmul.matmul_bwd(a, b, g, *need)
    assert all(x is None or torch.equal(x, y) for x, y in zip(got, again))


def _dw_mma(x, g, splits):
    """dW = x^T @ g of x (P, M) and g (P, N) through
    rt_conv2d_dw_nhwc_bf16_mma, the one entry point left on bf16_gemm.cuh's
    mma.sync kernel: a 1x1/s1 conv's dW over P pixels, K = the pixels split
    ``splits`` ways in that core's chunks; (M, N)."""
    from resnet_tpu_torch.kernels import build

    (p, m), n = x.shape, g.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    ws_ptr, _ws = build.gemm_workspace(splits, m, n, x)
    build.launch("rt_conv2d_dw_nhwc_bf16_mma", x.data_ptr(), g.data_ptr(), out.data_ptr(), 1,
                 1, p, m, n, 1, 1, 0, 0, 1, p, ws_ptr, splits, device=x.device)
    return out


@pytest.mark.parametrize("m,cin,cout", [(2 * 56 * 56, 64, 256), (32 * 7 * 7, 2048, 512),
                                        (8 * 7 * 7, 512, 2048), (2 * 14 * 14, 256, 1024)])
def test_conv2d_dx_bf16_1x1_has_bf16_gemm_bits_on_cuda(cuda, m, cin, cout):
    """A 1x1/s1 dx = g @ w^T on the persistent kernel (w read K-major as it
    lies) against the same product through bf16_gemm.cuh's mma.sync kernel:
    dW of x = g^T and g = w^T, with dx's K split (1, 1, 4 and 2 splits
    here), so both sum the same products in the same 16-deep chunks and
    order: the same bits."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(m, cout, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(cin, cout, generator=gen, device="cuda") * cout ** -0.5).to(torch.bfloat16)
    dx = conv.conv2d_dx(g.view(m, 1, 1, cout), w.view(1, 1, cin, cout), (m, 1, 1, cin), 1)
    witness = _dw_mma(g.t().contiguous(), w.t().contiguous(),
                      conv.dx_splits(m, cin, cout, 1, 1))
    assert torch.equal(dx.view(m, cin), witness)


@pytest.mark.parametrize("m", [1, 3, 8, 24, 32, 64])
def test_matmul_bf16_has_bf16_gemm_bits_on_cuda(cuda, m):
    """The FC c = a @ b on the persistent kernel (9 splits of 240 at batch
    1-32 with the operands swapped, c^T = b^T a^T; 4 of 512 at 64 on K1's
    bf16 forward by TMA boxes) against the same product through
    bf16_gemm.cuh's mma.sync kernel: dW of x = a^T and g = b with the FC's
    split: the same bits."""
    from resnet_tpu_torch.kernels import matmul

    k, n = 2048, 1000
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    assert torch.equal(matmul.matmul(a, b), _dw_mma(a.t().contiguous(), b,
                                                    matmul.fwd_splits(m, n, k)))


@pytest.mark.parametrize("m,k,n,offset", [(5, 300, 33, 0), (3, 2048, 1000, 1),
                                           (32, 2048, 1000, 1)])
def test_matmul_bf16_swap_scalar_has_bf16_gemm_bits_on_cuda(cuda, m, k, n, offset):
    """The FC's 2-byte swap loader (a ragged N and K, a misaligned b)
    against the same product through bf16_gemm.cuh's mma.sync kernel, dW of
    x = a^T and g = b with the FC's split (19 of 16 columns for the ragged
    case, 9 of 240 at K = 2048): the same bits."""
    from resnet_tpu_torch.kernels import matmul

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(k * n + offset, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)[offset:].view(k, n)
    assert matmul.fwd_bf16_route(m, n, k, b.data_ptr() % 16 == 0) == "swap_scalar"
    assert torch.equal(matmul.matmul(a, b), _dw_mma(a.t().contiguous(), b.contiguous(),
                                                    matmul.fwd_splits(m, n, k)))


# (entry, the loader named, why the entry must refuse it): a loader of
# 16-byte copies or TMA boxes on an operand 2 bytes off a 16-byte boundary
# or on a ragged width, a 1x1's matrix loader on a 3x3, the stem's on a
# 3x3, the swap beyond 32 rows
REFUSED = [("conv2d_dx", "gather", "misaligned g"), ("conv2d_dx", "copy", "ragged Cout"),
           ("conv2d_dx", "matrix", "3x3"), ("conv2d", "gather", "misaligned x"),
           ("conv2d", "stem", "3x3"), ("conv2d", "matrix", "3x3"),
           ("matmul", "swap", "misaligned b"), ("matmul", "swap_scalar", "64 rows")]


@pytest.mark.parametrize("entry,route,why", REFUSED, ids=[f"{e} {r}: {w}" for e, r, w in REFUSED])
def test_bf16_entries_refuse_a_loader_their_operands_do_not_allow(cuda, entry, route, why):
    """The wrapper names the loader; the C entry checks it against the
    shapes and the pointers and reports an error (raised by build.launch)
    rather than run a loader that would read wrong data."""
    from resnet_tpu_torch.kernels import build, conv, matmul

    bf = dict(dtype=torch.bfloat16, device="cuda")
    off = 1 if why.startswith("misaligned") else 0
    cout = 33 if why == "ragged Cout" else 64
    if entry == "matmul":
        m, k, n = (64 if why == "64 rows" else 8), 256, 128
        a, b = torch.zeros(m, k, **bf), torch.zeros(k * n + 1, **bf)[off:][:k * n]
        c = torch.empty(m, n, **bf)
        args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, None, 1,
                matmul.FWD_BF16_ROUTES.index(route))
        name = "rt_matmul_bf16"
    else:
        n, h, cin, k = 2, 14, 64, 3
        t = torch.zeros(n * h * h * max(cin, cout) + 1, **bf)[off:]
        w = torch.zeros(k, k, cin, cout, **bf)
        out = torch.empty(n * h * h * max(cin, cout), **bf)
        routes = conv.DX_ROUTES if entry == "conv2d_dx" else conv.FWD_ROUTES
        args = (t.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, h, cin, cout, k, 1,
                k // 2, k // 2, h, h, None, 1, routes.index(route))
        name = f"rt_{entry}_nhwc_bf16"
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.launch(name, *args, device=torch.device("cuda"))


DX_SHAPES = [s for s in FWD_SHAPES if s[1] != 3]


@pytest.mark.parametrize("shape", DX_SHAPES, ids=[str(s) for s in DX_SHAPES])
def test_conv2d_dx_bf16_takes_the_persistent_kernel_on_cuda(cuda, monkeypatch, shape):
    """Each ResNet-50 block conv's bf16 dx at batch 2: one launch of the
    persistent kernel (the phases of a strided dx its units), held to the
    plain dx by the bf16 rule, twice to the same bits."""
    from resnet_tpu_torch.kernels import conv

    h, cin, cout, k, s = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(2, h // s, h // s, cout, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    names = _recording(monkeypatch)
    got = conv.conv2d_dx(g, w, (2, h, h, cin), s)
    assert names == ["rt_conv2d_dx_nhwc_bf16"]
    _held_bf16(got, conv.conv2d_dx_reference(g, w, (2, h, h, cin), s))
    assert torch.equal(got, conv.conv2d_dx(g, w, (2, h, h, cin), s))


# (n, h, cin, cout, k, stride, route): each loader of the bf16 dx at stride
# 1 and 2; 1x1/s2, whose odd phases have no tap (zeros); a K split that
# ends inside a slice (stage 4's 3x3, 5 splits of 928)
DX_ROUTES = [
    (4, 14, 64, 256, 1, 1, "matrix"), (8, 7, 512, 2048, 1, 1, "matrix"),
    (4, 14, 64, 128, 3, 1, "gather"), (4, 14, 128, 128, 3, 2, "gather"),
    (4, 14, 96, 64, 1, 2, "gather"), (32, 7, 512, 512, 3, 1, "copy"),
    (2, 14, 72, 40, 3, 2, "copy"), (2, 14, 16, 24, 3, 1, "copy"),
    (2, 14, 9, 33, 3, 2, "scalar"), (2, 7, 130, 33, 3, 1, "scalar"),
]


@pytest.mark.parametrize("n,h,cin,cout,k,s,route", DX_ROUTES,
                         ids=[f"{r[-1]} {r[4]}x{r[4]}/s{r[5]} {r[2]}<-{r[3]}" for r in DX_ROUTES])
def test_conv2d_dx_bf16_routes_on_cuda(cuda, n, h, cin, cout, k, s, route):
    """Each of the bf16 dx's loaders against the plain dx by the bf16 rule,
    twice to the same bits."""
    from resnet_tpu_torch.kernels import conv

    assert conv.dx_bf16_route(n * h * h, cin, cout, k, s) == route
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(n, h // s, h // s, cout, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    got = conv.conv2d_dx(g, w, (n, h, h, cin), s)
    _held_bf16(got, conv.conv2d_dx_reference(g, w, (n, h, h, cin), s))
    assert torch.equal(got, conv.conv2d_dx(g, w, (n, h, h, cin), s))


@pytest.mark.parametrize("k,stride", [(3, 1), (1, 1), (3, 2)])
def test_conv2d_dx_bf16_misaligned_on_cuda(cuda, k, stride):
    """g whose data start 2 bytes past a 16-byte boundary: dx takes the
    threads' 2-byte loads, holds to the plain dx, and gives the bits of the
    same values aligned (the gather, or a 1x1's TMA boxes): every loader
    sums the same k16 steps in K order."""
    from resnet_tpu_torch.kernels import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, cin, cout = 4, 14, 128, 64
    ho = h // stride
    ga = torch.randn(n * ho * ho * cout + 1, generator=gen, device="cuda").to(torch.bfloat16)
    g = ga[1:].view(n, ho, ho, cout)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    assert g.data_ptr() % 16
    assert conv.dx_bf16_route(n * h * h, cin, cout, k, stride, False) == "scalar"
    assert conv.dx_bf16_route(n * h * h, cin, cout, k, stride) != "scalar"
    got = conv.conv2d_dx(g, w, (n, h, h, cin), stride)
    _held_bf16(got, conv.conv2d_dx_reference(g, w, (n, h, h, cin), stride))
    assert torch.equal(got, conv.conv2d_dx(g.clone(), w, (n, h, h, cin), stride))


@pytest.mark.parametrize("m,k,n,offset,route", [
    (1, 2048, 1000, 0, "swap"), (8, 2048, 1000, 0, "swap"), (24, 2048, 1000, 0, "swap"),
    (32, 2048, 1000, 0, "swap"), (16, 256, 72, 0, "swap"), (64, 2048, 1000, 0, "matrix"),
    (40, 512, 1000, 0, "matrix"), (5, 300, 33, 0, "swap_scalar"),
    (8, 2048, 1000, 1, "swap_scalar"), (32, 2048, 1000, 1, "swap_scalar"),
    (3, 2048, 1000, 1, "swap_scalar"), (64, 2048, 1000, 1, "scalar")])
def test_matmul_bf16_routes_on_cuda(cuda, monkeypatch, m, k, n, offset, route):
    """K3's bf16 forward: one launch of rt_matmul_bf16 for every M (the
    operands swapped at M <= 32, else K1's bf16 forward), the loaders
    matmul.fwd_bf16_route names, within the bf16 rule of the plain product,
    twice to the same bits; a misaligned b (2-byte loads) gives the bits
    of the same values aligned."""
    from resnet_tpu_torch.kernels import matmul

    assert matmul.fwd_bf16_route(m, n, k, offset == 0) == route
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(k * n + offset, generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)[offset:].view(k, n)
    names = _recording(monkeypatch)
    got = matmul.matmul(a, b)
    assert names == ["rt_matmul_bf16"]
    _held_bf16(got, matmul.matmul_reference(a, b))
    assert torch.equal(got, matmul.matmul(a, b))
    if offset:
        assert torch.equal(got, matmul.matmul(a, b.clone()))


def _stage_gemms():
    """(label, batch, H, Cin, Cout, k) of the three GEMMs of each
    BF16_BLOCK_FUSED_CASES block without a cap: the four identity-block
    shapes at batch 32 (the tap loader), the ragged C = 9 block and the
    split-K C = 129 block (2-byte loads); and a C = 72 block, whose widths
    are multiples of 8 but not of 64 (K8's cp.async gather)."""
    blocks = checks.BF16_BLOCK_FUSED_CASES + [("C=72 (2,6,6,288)", (2, 6, 6, 288), 72, None)]
    for label, (n, h, _, c4), c, cap in blocks:
        if cap is None:
            for what, cin, cout, k in (("reduce", c4, c, 1), ("3x3", c, c, 3),
                                       ("expand", c, c4, 1)):
                yield f"{label} {what}", n, h, cin, cout, k


STAGE_GEMMS = list(_stage_gemms())


@pytest.mark.parametrize("case", STAGE_GEMMS, ids=[c[0] for c in STAGE_GEMMS])
def test_block_fused_bf16_stage_gemm_has_k8_bits_on_cuda(cuda, case):
    """K10-bf16's stage GEMM on the persistent loop (rt_block_gemm_bf16)
    gives y, the tile partials and the sums bit-equal to K8-bf16's GEMM on
    `mainloop` (rt_fused_conv_bf16) on the same inputs at the same K
    splits (build.wgb_split), the prologue on with a scale and a shift that
    move every value (shift > 0 on about half the channels: a halo tap given
    act(shift), or a slot fixed with another slot's channels, shows). The
    partials start from different fills in the two, so an entry neither
    writes shows too; and y holds to the plain version."""
    from resnet_tpu_torch.kernels import build, fused_conv

    _, n, h, cin, cout, k = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, h, cin, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda")
         * (2.0 / (k * k * cin)) ** 0.5).to(torch.bfloat16)
    scale = 1 + 0.2 * torch.randn(cin, generator=gen, device="cuda")
    shift = 0.5 * torch.randn(cin, generator=gen, device="cuda")
    m = n * h * h
    splits = build.wgb_split(m, cout, k * k * cin)
    outs = []
    for entry, fill in (("rt_fused_conv_bf16", 0.0), ("rt_block_gemm_bf16", -1.0)):
        y = torch.empty(n, h, h, cout, dtype=torch.bfloat16, device="cuda")
        part = torch.full((-(-m // build.WGB_BM) * 2 * cout,), fill, device="cuda")
        sums = torch.empty(2, cout, device="cuda")
        ws = torch.empty(splits * m * cout, device="cuda") if splits > 1 else None
        build.launch(entry, x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                     y.data_ptr(), part.data_ptr(), sums.data_ptr(), n, h, h, cin, cout, k, 1,
                     k // 2, k // 2, h, h, 1, 1, 0, 0.0, None if ws is None else ws.data_ptr(),
                     splits, device=x.device)
        outs.append((y, part, sums))
    torch.cuda.synchronize()
    for got, want in zip(outs[1], outs[0]):
        assert torch.equal(got, want)
    _held_bf16(outs[1][0], fused_conv.fused_conv_reference(x, w, scale, shift, 1)[0])


@pytest.mark.parametrize("case", checks.BF16_BLOCK_FUSED_CASES,
                         ids=[c[0] for c in checks.BF16_BLOCK_FUSED_CASES])
def test_block_fused_bf16_repeats_bit_for_bit(cuda, case):
    """K10-bf16 twice on the same inputs: out, r, s, e, the three sums and
    the six rows give the same bits (the persistent loop's units run on
    whichever block, each unit's sum in one fixed order; no atomics)."""
    from resnet_tpu_torch.kernels import block_fused

    _, (n, h, wd, c4), c, cap = case
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    x = torch.clamp_min(randn(n, h, wd, c4), 0.0).to(torch.bfloat16)
    ws = (randn(c4, c, scale=(2.0 / c4) ** 0.5), randn(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5),
          randn(c, c4, scale=(2.0 / c) ** 0.5))
    rows = [t for width in (c, c, c4) for t in (1 + randn(width, scale=0.2),
                                                randn(width, scale=0.5))]
    first = block_fused.block_fused_forward(x, *ws, *rows, 1e-7, cap)
    again = block_fused.block_fused_forward(x, *ws, *rows, 1e-7, cap)
    flat = [t for out in (first, again) for t in (*out[:7], *out[7])]
    half = len(flat) // 2
    assert all(torch.equal(a, b) for a, b in zip(flat[:half], flat[half:]))


# (label, shape, storage offset in elements, cap): K9's join body at the
# widths where its paths part: C a multiple of the vector (8 bf16, 4 fp32)
# with G = C / 8 dividing the block (8, 256, 2048) or not (72: G = 9), C
# not (9: element by element), a misaligned start, a cap
JOIN_BITS = [("C=8", (4, 7, 7, 8), 0, None), ("C=9", (3, 7, 7, 9), 0, None),
             ("C=72", (4, 7, 7, 72), 0, None), ("C=256", (32, 56, 56, 256), 0, None),
             ("C=2048", (32, 7, 7, 2048), 0, None),
             ("misaligned C=2048", (8, 7, 7, 2048), 1, None),
             ("cap 10 C=1024", (32, 14, 14, 1024), 0, 10.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("label,shape,offset,cap", JOIN_BITS, ids=[c[0] for c in JOIN_BITS])
def test_fused_join_is_its_plain_version_bit_for_bit_on_cuda(cuda, dtype, label, shape,
                                                              offset, cap):
    """K9 (rt_fused_join_{f32,bf16}) rounds every product and sum as the
    plain torch ops do, on the vector body and the element-by-element one
    alike: the same bits as fused_join_reference."""
    from resnet_tpu_torch.kernels import fused_conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    numel, c = torch.Size(shape).numel(), shape[-1]

    def tensor():
        flat = (4 * torch.randn(numel + offset, generator=gen, device="cuda")).to(dtype)
        return flat[offset:].view(shape)

    e, r = tensor(), tensor()
    assert (e.data_ptr() % 16 != 0) == (offset != 0)
    rows = [1 + 0.2 * torch.randn(c, generator=gen, device="cuda") if i % 2 == 0
            else 0.5 * torch.randn(c, generator=gen, device="cuda") for i in range(4)]
    before = fused_conv.JOIN_LAUNCHES_BF16 + fused_conv.JOIN_LAUNCHES
    got = fused_conv.fused_join(e, rows[0], rows[1], r, rows[2], rows[3], cap)
    assert fused_conv.JOIN_LAUNCHES_BF16 + fused_conv.JOIN_LAUNCHES == before + 1
    assert torch.equal(got, fused_conv.fused_join_reference(e, *rows[:2], r, *rows[2:], cap))


# Q3 (kernels.quant.qconv with groups > 1) on the shapes its halo tile, its
# column blocks and its stores must get right: label, (batch, H, Cin, Cout,
# k, stride, groups), x's byte offset, the output dtype, relu, cap, bias,
# and a plan (sets a span, images a tile, rows a tile) forced in place of
# build.q3_plan's, or None
QCONV_GROUPED_EXACT = [
    ("16 a group, the cp.async halo", (2, 14, 512, 512, 3, 1, 32), 0, "bf16", True, None,
     True, None),
    ("16 a group at offset 8: the word-by-word halo", (2, 14, 512, 512, 3, 1, 32), 8, "bf16",
     True, None, True, None),
    ("16 a group at offset 4, 3x3/s2: the word-by-word halo", (2, 14, 512, 512, 3, 2, 32), 4,
     "bf16", False, None, True, None),
    ("16 a group at offset 1, cap 6", (2, 14, 512, 512, 3, 1, 32), 1, "bf16", True, 6.0, True,
     None),
    ("4 a group, M = 49 (not a multiple of 16)", (1, 7, 128, 128, 3, 1, 32), 0, "bf16", True,
     None, False, None),
    ("8 a group, 3x3/s2", (3, 28, 256, 256, 3, 2, 32), 0, "bf16", True, None, True, None),
    ("64 a group, 7^2", (2, 7, 2048, 2048, 3, 1, 32), 0, "bf16", True, None, True, None),
    ("ragged: 3 a group, 5 out", (2, 9, 6, 10, 3, 1, 2), 0, "bf16", False, None, True, None),
    ("ragged at offset 3, fp32 out", (3, 6, 12, 8, 3, 2, 4), 3, "f32", False, None, True, None),
    ("a 1x1/s2 grouped conv, 2 outputs a group", (2, 8, 64, 32, 1, 2, 16), 0, "bf16", True,
     None, True, None),
    ("M not a multiple of the tile: 10 rows in tiles of 3", (2, 10, 64, 64, 3, 1, 8), 0,
     "bf16", True, None, True, (1, 1, 3)),
    ("tiles of 3 whole images over 5: m16 tiles across images, the last tile short",
     (5, 7, 256, 256, 3, 1, 32), 0, "bf16", True, None, True, (2, 3, 7)),
    ("stride 2, odd output rows (14 -> 7)", (2, 14, 128, 128, 3, 2, 32), 0, "bf16", True, None,
     True, None),
    ("Ng = 4: two groups a column block", (2, 10, 64, 64, 3, 1, 16), 0, "bf16", True, None,
     True, None),
    ("Ng = 2: four groups a column block", (2, 10, 64, 32, 3, 1, 16), 0, "bf16", True, None,
     True, None),
    ("64 a group, 3x3/s2 14^2", (2, 14, 2048, 2048, 3, 2, 32), 0, "bf16", True, None, True,
     None),
    ("4 a group at offset 3", (2, 14, 256, 256, 3, 1, 32), 3, "bf16", True, None, True, None),
    ("mode 2: fp32 out with a bias", (2, 14, 512, 512, 3, 1, 32), 0, "f32", False, None, True,
     None),
    ("mode 1 with a cap, the cp.async halo", (2, 28, 256, 256, 3, 1, 32), 0, "bf16", True,
     6.0, True, None),
]


@pytest.mark.parametrize("case", QCONV_GROUPED_EXACT, ids=[c[0] for c in QCONV_GROUPED_EXACT])
def test_qconv_grouped_launches_q3_bit_for_bit(cuda, case, monkeypatch):
    """A grouped conv on the card launches Q3 (GROUPED_LAUNCHES, not Q1's
    counter), twice, each time equal to qconv_reference bit for bit."""
    from resnet_tpu_torch.kernels import build, quant

    _, (n, h, cin, cout, k, s, g), offset, out, relu, cap, bias, plan = case
    if plan is not None:
        monkeypatch.setattr(build, "q3_plan", lambda *args: plan)
    gen = torch.Generator(device="cuda").manual_seed(4)
    flat = torch.randint(-127, 128, (n * h * h * cin + offset,), generator=gen,
                         device="cuda", dtype=torch.int8)
    xq = flat[offset:].view(n, h, h, cin)
    w = torch.randint(-127, 128, (k, k, cin // g, cout), generator=gen, device="cuda",
                      dtype=torch.int8)
    dq = (torch.rand(cout, generator=gen, device="cuda") + 0.5) * (
        4.0 / (127 * 127 * (k * k * cin // g) ** 0.5))
    b = torch.randn(cout, generator=gen, device="cuda") if bias else None
    kw = dict(stride=s, groups=g, relu=relu, cap=cap,
              out_dtype=torch.float32 if out == "f32" else torch.bfloat16)
    want = quant.qconv_reference(xq, w, dq, b, **kw)
    for _ in range(2):
        before = quant.LAUNCHES, quant.GROUPED_LAUNCHES
        got = quant.qconv(xq, w, dq, b, **kw)
        assert (quant.LAUNCHES, quant.GROUPED_LAUNCHES) == (before[0], before[1] + 1)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_quantized_resnext50_forward_is_its_plain_version_on_cuda(cuda):
    """A quantized ResNeXt-50 32x4d at 224 (seeded weights, calibrated on a
    batch of 2) at batch 2: the hand-kernel forward launches 38 Q1, 16 Q3
    and 54 Q2 and gives the plain int8 forward's logits bit for bit."""
    import numpy as np

    from resnet_tpu_torch import quantize
    from resnet_tpu_torch.config import model_config
    from resnet_tpu_torch.kernels import quant
    from resnet_tpu_torch.models import init_bn_state, init_params

    mcfg = model_config("resnext50_32x4d")
    params = init_params(torch.Generator().manual_seed(1234), mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    rng = np.random.default_rng(1234)
    calib, x = (torch.from_numpy(rng.normal(0, 50, (2, 224, 224, 3)).astype(np.float32)).cuda()
                for _ in range(2))
    qparams, scales = quantize.quantize_model(params, bn_state, mcfg, calib)
    sites = quantize.prepare_sites(qparams, scales, mcfg)
    before = quant.LAUNCHES, quant.GROUPED_LAUNCHES, quant.ACT_LAUNCHES
    got = quantize.forward_sites(sites, x, mcfg)
    moved = (quant.LAUNCHES - before[0], quant.GROUPED_LAUNCHES - before[1],
             quant.ACT_LAUNCHES - before[2])
    assert moved == (38, 16, 54)
    want = quantize.forward_sites(sites, x, mcfg, plain=True)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_quantized_resnet50_forward_is_its_plain_version_on_cuda(cuda):
    """A quantized ResNet-50 at 224 (seeded weights, non-trivial running
    statistics, calibrated on a batch of 8 at pixel scale) at batch 8: the
    hand-kernel forward launches 54 Q1 and 54 Q2 and gives the plain int8
    forward's logits bit for bit (both share every op outside Q1 and Q2)."""
    import numpy as np

    from resnet_tpu_torch import quantize
    from resnet_tpu_torch.config import model_config
    from resnet_tpu_torch.kernels import quant
    from resnet_tpu_torch.models import init_bn_state, init_params

    mcfg = model_config("resnet50")
    gen = torch.Generator().manual_seed(1234)
    params = init_params(gen, mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    for layer in [bn_state["init_bn"], *[b for blk in bn_state["blocks"] for b in blk.values()]]:
        c = layer["mean"].numel()
        layer["mean"] = (torch.randn(c, generator=gen) * 0.1).to("cuda")
        layer["var"] = (0.5 + 1.5 * torch.rand(c, generator=gen)).to("cuda")
    rng = np.random.default_rng(1234)
    calib, x = (torch.from_numpy(rng.normal(0, 50, (8, 224, 224, 3)).astype(np.float32)).cuda()
                for _ in range(2))
    qparams, scales = quantize.quantize_model(params, bn_state, mcfg, calib)
    sites = quantize.prepare_sites(qparams, scales, mcfg)
    before = quant.LAUNCHES, quant.ACT_LAUNCHES
    got = quantize.forward_sites(sites, x, mcfg)
    assert (quant.LAUNCHES - before[0], quant.ACT_LAUNCHES - before[1]) == (54, 54)
    want = quantize.forward_sites(sites, x, mcfg, plain=True)
    assert (quant.LAUNCHES - before[0], quant.ACT_LAUNCHES - before[1]) == (54, 54)
    assert torch.isfinite(got).all() and torch.equal(got, want)


# Q1 (kernels.quant.qconv) on the shapes its design must get right: label,
# (batch, H, Cin, Cout, k, stride), a (tile width, splits) plan or None for
# the planners', x's byte offset, the output dtype, relu, cap
QCONV_EXACT = [
    ("K of one slice: 1x1 128->64", (4, 9, 128, 64, 1, 1), None, 0, "bf16", True, None),
    ("36 slices in 8 splits, the last short", (2, 7, 512, 256, 3, 1), (128, 8), 0, "bf16",
     True, 6.0),
    ("M below 64 (25 rows), the planners' splits", (1, 5, 256, 128, 3, 1), None, 0, "bf16",
     True, None),
    ("Cout 33, 3x3/s2", (2, 10, 64, 33, 3, 2), None, 0, "bf16", True, None),
    ("Cout 1000, fp32: the FC at batch 3", (3, 1, 2048, 1000, 1, 1), None, 0, "f32", False,
     None),
    ("misaligned x: the byte path at Cin 64", (2, 8, 64, 128, 3, 1), None, 1, "bf16", False,
     None),
    ("the stem at batch 1", (1, 224, 3, 64, 7, 2), None, 0, "bf16", True, None),
    ("128-wide tiles in 3 splits, Cout 320", (2, 14, 256, 320, 3, 1), (128, 3), 0, "bf16",
     False, None),
    ("64-wide tiles, every slice a split", (1, 7, 256, 128, 3, 1), (64, 18), 0, "bf16", True,
     None),
    ("256-wide tiles in 3 splits, Cout 320", (2, 14, 256, 320, 3, 1), (256, 3), 0, "bf16",
     False, None),
    ("256-wide tiles on the byte path, Cout 300", (2, 8, 64, 300, 3, 1), (256, 1), 1, "bf16",
     True, None),
    ("B kept in the ring: 313 tiles of one column", (4, 100, 64, 64, 3, 1), None, 0, "bf16",
     True, None),
    ("B kept in the ring on the byte path", (4, 100, 64, 64, 3, 1), (64, 1), 1, "bf16", False,
     None),
]


@pytest.mark.parametrize("case", QCONV_EXACT, ids=[c[0] for c in QCONV_EXACT])
def test_qconv_is_its_plain_version_bit_for_bit(cuda, monkeypatch, case):
    """Q1 equals qconv_reference bit for bit on each shape, twice, under
    build.qconv_plan's plan or the one named, and leaves its split tickets
    zero."""
    from resnet_tpu_torch.kernels import bn, build, quant

    _, (n, h, cin, cout, k, s), plan, offset, out, relu, cap = case
    gen = torch.Generator(device="cuda").manual_seed(3)
    flat = torch.randint(-127, 128, (n * h * h * cin + offset,), generator=gen,
                         device="cuda", dtype=torch.int8)
    xq = flat[offset:].view(n, h, h, cin)
    assert (xq.data_ptr() % 16 != 0) == (offset != 0)
    w = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device="cuda",
                      dtype=torch.int8)
    dq = (torch.rand(cout, generator=gen, device="cuda") + 0.5) * (4.0 / (127 * 127 * (k * k * cin) ** 0.5))
    b = torch.randn(cout, generator=gen, device="cuda")
    kw = dict(stride=s, relu=relu, cap=cap,
              out_dtype=torch.float32 if out == "f32" else torch.bfloat16)
    want = quant.qconv_reference(xq, w, dq, b, **kw)
    wk = quant.pack_weight(w)
    if plan is not None:
        monkeypatch.setattr(build, "qconv_plan", lambda m, n, k: plan)
    for _ in range(2):
        before = quant.LAUNCHES
        got = quant.qconv(xq, w, dq, b, wk=wk, **kw)
        assert quant.LAUNCHES == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    for _, tickets in bn._WORKSPACES.values():
        assert not tickets.any()


def _qconv_operands(gen, n, h, cin, cout):
    xq = torch.randint(-127, 128, (n, h, h, cin), generator=gen, device="cuda",
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=gen, device="cuda",
                      dtype=torch.int8)
    return xq, w, torch.rand(cout, generator=gen, device="cuda") * 1e-5 + 1e-6


def test_qconv_split_launches_of_growing_tile_counts_share_the_scratch(cuda, monkeypatch):
    """Split launches on one stream share one scratch: after a launch of few
    tiles whose partials fill the scratch, one of more tiles (more tickets)
    still counts from zero and gives the plain version's bits."""
    from resnet_tpu_torch.kernels import bn, build, quant

    gen = torch.Generator(device="cuda").manual_seed(5)
    for n, h, cin, cout, plan in ((1, 7, 512, 64, (64, 4)), (8, 7, 512, 512, (64, 4)),
                                  (1, 7, 512, 64, (64, 9)), (8, 14, 256, 512, (128, 3))):
        xq, w, dq = _qconv_operands(gen, n, h, cin, cout)
        monkeypatch.setattr(build, "qconv_plan", lambda m, n, k: plan)
        got = quant.qconv(xq, w, dq, relu=True)
        assert torch.equal(got, quant.qconv_reference(xq, w, dq, relu=True))
    for _, tickets in bn._WORKSPACES.values():
        assert not tickets.any()


def test_qconv_split_calls_from_two_threads_that_grow_the_scratch(cuda, monkeypatch):
    """Two threads on one stream, as the HTTP server's are: one makes split
    calls of one tile while the other makes split calls of ever more tiles,
    each of which grows the stream's scratch. Each call holds the scratch it
    launched on, so no freed block is reused under a queued launch: every
    output is the plain version's bits."""
    import threading

    from resnet_tpu_torch.kernels import bn, build, quant

    monkeypatch.setattr(bn, "_WORKSPACES", {})
    planner = build.qconv_plan
    plans = {(49, 64): (64, 4), **{(49 * n, 512): (64, 9) for n in (1, 4, 8, 16, 32)}}
    monkeypatch.setattr(build, "qconv_plan", lambda m, n, k: plans.get((m, n))
                        or planner(m, n, k))
    gen = torch.Generator(device="cuda").manual_seed(6)
    small = [_qconv_operands(gen, 1, 7, 512, 64) for _ in range(2)]
    growing = [_qconv_operands(gen, n, 7, 512, 512) for n in (1, 4, 8, 16, 32)]
    want = [quant.qconv_reference(xq, w, dq, relu=True) for xq, w, dq in small + growing]
    got, errors = {}, []

    def run(key, operands, repeats):
        try:
            for r in range(repeats):
                for i, (xq, w, dq) in enumerate(operands):
                    got[key, r, i] = quant.qconv(xq, w, dq, relu=True)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=("small", small, 40)),
               threading.Thread(target=run, args=("growing", growing, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for (key, _, i), out in got.items():
        assert torch.equal(out, want[i if key == "small" else len(small) + i]), (key, i)
    assert len(got) == 40 * len(small) + len(growing)
    for _, tickets in bn._WORKSPACES.values():
        assert not tickets.any()


@pytest.mark.parametrize("cin", [240, 256])
def test_qconv_extreme_accumulators(cuda, cin):
    """Every product at (-128) * (-128) or (-128) * 127: the largest
    accumulators a K of 240 and of 256 (2^22) can reach, positive and
    negative, equal the plain version bit for bit in bf16 and fp32."""
    from resnet_tpu_torch.kernels import quant

    xq = torch.full((2, 16, 16, cin), -128, dtype=torch.int8, device="cuda")
    xq[1] = 127
    w = torch.full((1, 1, cin, 64), -128, dtype=torch.int8, device="cuda")
    dq = torch.linspace(1e-7, 1e-5, 64, device="cuda")
    for out_dtype in (torch.bfloat16, torch.float32):
        got = quant.qconv(xq, w, dq, out_dtype=out_dtype)
        assert torch.equal(got, quant.qconv_reference(xq, w, dq, out_dtype=out_dtype))


def _op_calls():
    """(name, op, its CUDA implementation, inputs on the card): each custom
    op of kernels.ops at a served shape, fp32 and bf16, and K1 on a
    spatial tile with an explicit padding."""
    from resnet_tpu_torch.kernels import conv, fused, matmul, ops, quant

    g = torch.Generator(device="cuda").manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, device="cuda",  # noqa: E731
                                  dtype=torch.int8)
    return [
        ("conv2d_nhwc 3x3", ops.conv2d_nhwc, conv._forward, (r(8, 56, 56, 64), r(3, 3, 64, 64), 1)),
        ("conv2d_nhwc stem bf16", ops.conv2d_nhwc, conv._forward,
         (r(2, 224, 224, 3).bfloat16(), r(7, 7, 3, 64).bfloat16(), 2)),
        ("add_relu", ops.add_relu, fused._forward, (r(8, 56, 56, 256), r(8, 56, 56, 256))),
        ("add_relu bf16", ops.add_relu, fused._forward,
         (r(8, 7, 7, 2048).bfloat16(), r(8, 7, 7, 2048).bfloat16())),
        ("matmul", ops.matmul, matmul._forward, (r(8, 2048), r(2048, 1000))),
        ("matmul bf16", ops.matmul, matmul._forward,
         (r(8, 2048).bfloat16(), r(2048, 1000).bfloat16())),
        ("quant_act", ops.quant_act, quant._quant_act, (r(8, 56, 56, 64) * 20, 0.37)),
        ("qconv", ops.qconv, quant._qconv,
         (i8(8, 56, 56, 64), i8(3, 3, 64, 64), r(64).abs() * 1e-4, r(64), None, 1, 1, True,
          None, torch.bfloat16)),
        ("qconv fc", ops.qconv, quant._qconv,
         (i8(8, 1, 1, 2048), i8(1, 1, 2048, 1000), r(1000).abs() * 1e-5, None, None, 1, 1,
          False, None, torch.float32)),
        ("qconv grouped", ops.qconv, quant._qconv,
         (i8(8, 28, 28, 256), i8(3, 3, 8, 256), r(256).abs() * 1e-4, r(256), None, 1, 32, True,
          6.0, torch.bfloat16)),
        # a spatial rank's tile: 29 rows with JAX's padding [lo, hi, lo_w, hi_w]
        ("conv2d_nhwc padded tile", ops.conv2d_nhwc, conv._forward,
         (r(8, 29, 56, 64), r(3, 3, 64, 64), 2, [1, 0, 1, 0])),
    ]


def test_each_op_launches_its_kernel_with_the_direct_launchs_bits(cuda):
    """On CUDA tensors each resnet_tpu_torch:: op runs its CUDA
    implementation: the kernel's counter moves by one a call, and the
    result equals a direct call of that implementation bit for bit."""
    from resnet_tpu_torch.kernels import checks as kchecks

    counters = {name: (mod, attr) for name, (mod, attr, *_) in kchecks.KERNELS.items()}

    def read():
        return {k: getattr(m, a) for k, (m, a) in counters.items()}

    for name, op, impl, args in _op_calls():
        before = read()
        got = op(*args)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in read().items() if v != before[k]}
        assert sum(moved.values()) == 1, (name, moved)
        assert torch.equal(got, impl(*args)), name


@pytest.mark.parametrize("i", range(11))
def test_ops_pass_opcheck_on_cuda(cuda, i):
    name, op, _, args = _op_calls()[i]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8", "int8 resnext"])
def test_exported_program_counts_the_eager_launches_on_cuda(cuda, tmp_path, kind):
    """ResNet-50 (ResNeXt-50 32x4d) at 64^2 exported on the card with a
    symbolic batch, saved and loaded: at batches 1, 3 and 8 each forward of
    the program moves the kernels' counters as the eager model's does (53
    K1, 16 K2, 1 K3 on the fp32 or bf16 entries; 54 Q1, 54 Q2; 38 Q1, 16
    Q3, 54 Q2); the int8 logits equal the eager model's bit for bit, the
    fp ones within 1e-3 of max."""
    import numpy as np

    from resnet_tpu_torch.config import ExecutionConfig, model_config
    from resnet_tpu_torch.export import (export_inference, export_quantized_inference,
                                         load_inference, save_inference)
    from resnet_tpu_torch.kernels import checks as kchecks
    from resnet_tpu_torch.models import init_bn_state, init_params

    arch = "resnext50_32x4d" if "resnext" in kind else "resnet50"
    mcfg = model_config(arch, input_dim=64)
    params = init_params(torch.Generator().manual_seed(1234), mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    rng = np.random.default_rng(1234)
    if kind.startswith("int8"):
        model = export_quantized_inference(
            params, mcfg, rng.normal(0, 50, (4, 64, 64, 3)).astype(np.float32),
            bn_state=bn_state)
    else:
        bf16 = kind == "bf16"
        model = export_inference(params, mcfg, bn_state=bn_state,
                                 weights_dtype="bfloat16" if bf16 else None,
                                 ecfg=ExecutionConfig(kernels="pallas", conv_kernels="pallas",
                                                      compute_dtype="bfloat16" if bf16
                                                      else "float32"))
    served = load_inference(save_inference(str(tmp_path / "m.pt2"), model), device="cuda")
    assert served.device == torch.device("cuda", torch.cuda.current_device())
    counters = {name: (mod, attr) for name, (mod, attr, *_) in kchecks.KERNELS.items()}

    def moved_by(fn):
        before = {k: getattr(m, a) for k, (m, a) in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: getattr(m, a) - before[k] for k, (m, a) in counters.items()
                     if getattr(m, a) != before[k]}

    for n in (1, 3, 8):
        x = rng.normal(0, 50, (n, 64, 64, 3)).astype(np.float32)
        want, eager = moved_by(lambda: model.call(x))
        got, program = moved_by(lambda: served.call(x))
        assert program == eager and sum(eager.values()) >= 54, (n, program, eager)
        if kind.startswith("int8"):
            assert torch.equal(got, want)
        else:
            assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    with pytest.raises(ValueError, match="exported on cuda"):
        load_inference(str(tmp_path / "m.pt2"), device="cpu")


def _identity_sum(t):
    """A statistics group's sum over one rank: changes nothing."""


# (label, x shape, C): ResNet-50's stage 1 and stage 4 identity blocks at
# batch 16
K10_STAGE_SHAPES = [("stage 1", (16, 56, 56, 256), 64), ("stage 4", (16, 7, 7, 2048), 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("label,shape,c", K10_STAGE_SHAPES,
                         ids=[s[0] for s in K10_STAGE_SHAPES])
def test_block_fused_stage_entries_are_the_one_call_bit_for_bit(cuda, dtype, label, shape, c):
    """K10 one stage at a time (rt_block_fused_stage_*, the route of a block
    whose statistics a group sums) under a sum that changes nothing gives
    the one host call's out, r, s, e, sums and rows bit for bit, in four
    stage calls and no one-call launch."""
    from resnet_tpu_torch.kernels import block_fused

    n, h, wd, c4 = shape
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*size, scale=1.0):
        return scale * torch.randn(*size, generator=gen, device="cuda")

    x = torch.clamp_min(randn(n, h, wd, c4), 0.0).to(dtype)
    ws = (randn(c4, c, scale=(2.0 / c4) ** 0.5), randn(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5),
          randn(c, c4, scale=(2.0 / c) ** 0.5))
    rows = [t for width in (c, c, c4) for t in (1 + randn(width, scale=0.2),
                                                randn(width, scale=0.5))]
    one = block_fused.block_fused_forward(x, *ws, *rows, 1e-7, None)
    suffix = "_BF16" if dtype is torch.bfloat16 else ""
    calls, stages = (getattr(block_fused, f"{k}{suffix}") for k in ("LAUNCHES", "STAGE_LAUNCHES"))
    staged = block_fused.block_fused_forward(x, *ws, *rows, 1e-7, None, _identity_sum)
    torch.cuda.synchronize()
    assert getattr(block_fused, f"LAUNCHES{suffix}") == calls
    assert getattr(block_fused, f"STAGE_LAUNCHES{suffix}") == stages + 4
    assert staged[-1].item() == n * h * wd
    flat = [(t for t in (*out[:7], *out[7])) for out in (one, staged)]
    assert all(torch.equal(a, b) for a, b in zip(*flat, strict=True))


def test_sum_stats_on_k8_sums_is_one_process(cuda):
    """The sums Function on K8's [Σy, Σy²] under a sum over one rank: the
    forward gives K8's sums and row count, the backward the cotangent, bit
    for bit, so a group of one computes one process's statistics."""
    from resnet_tpu_torch.kernels import bn, fused_conv

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(16, 28, 28, 128, generator=gen, device="cuda")
    w = 0.05 * torch.randn(3, 3, 128, 128, generator=gen, device="cuda")
    scale, shift = torch.ones(128, device="cuda"), torch.zeros(128, device="cuda")
    _, sums = fused_conv.fused_conv(x, w, scale, shift, 1, None, False, False)
    sums = sums.detach().requires_grad_(True)
    with bn.sync_stats(_identity_sum):
        total, m = bn.sum_stats(sums, 16 * 28 * 28)
    assert torch.equal(total, sums.detach()) and m.item() == 16 * 28 * 28
    cot = torch.randn(2, 128, generator=gen, device="cuda")
    total.backward(cot)
    assert torch.equal(sums.grad, cot)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_matmul_on_a_class_slice_is_the_whole_products_columns(cuda, dtype):
    """K3 on the composite head's class slice, (16, 2048) @ (2048, 500): the
    matching columns of K3 on the whole (2048, 1000) weight, within 1e-5 of
    their max (the two calls may split K differently), and twice to the
    same bits."""
    from resnet_tpu_torch.kernels import matmul

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(16, 2048, generator=gen, device="cuda").to(dtype)
    w = (0.02 * torch.randn(2048, 1000, generator=gen, device="cuda")).to(dtype)
    whole = matmul.matmul(x, w)
    for part in range(2):
        cols = w[:, part * 500:(part + 1) * 500].contiguous()
        got = matmul.matmul(x, cols)
        assert torch.equal(got, matmul.matmul(x, cols))
        want = whole[:, part * 500:(part + 1) * 500].float()
        err = (got.float() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() + (
            0 if dtype is torch.float32 else 2 ** -7 * want.abs().max().item()), err
