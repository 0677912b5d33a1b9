"""The port's CUDA kernels against their plain PyTorch versions on the card.

The same checks as phase 3 of chip_smoke.py (resnet_tpu_torch.kernels.checks),
one test per kernel and shape, so each can be rerun alone on a GPU:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

the kernels on tc_gemm.cuh's tensor-core core alone with
``-k "conv2d or fused_conv"``, and K10 on the wgmma core (wg_gemm.cuh) with
its weight split alone with ``-k "block_fused or split_tf32"``, and the
clean variant's batch-224 shapes (K1's stem, K2, K2b, K4) with
``-k "batch 224"``.

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
    of every tile leaves its ticket at 0."""
    from resnet_tpu_torch.kernels import bn

    _, m, c = case
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5
    before = bn.LAUNCHES
    first, again = bn.moments(x), bn.moments(x)
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
