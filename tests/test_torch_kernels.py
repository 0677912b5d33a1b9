"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU a wrapper runs its plain version (the CUDA kernels are checked
against that plain version on the card, tests/test_torch_gpu.py). Here the
plain version is held against the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, within 1e-4 of max|Pallas|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu_torch.kernels import adam, bn, build, conv, fused, matmul

TOL = 1e-4
COUNTERS = [(conv, "LAUNCHES"), (conv, "DX_LAUNCHES"), (conv, "DW_LAUNCHES"),
            (fused, "LAUNCHES"), (fused, "MASK_LAUNCHES"), (matmul, "LAUNCHES"),
            (matmul, "BWD_LAUNCHES"), (bn, "LAUNCHES"), (adam, "LAUNCHES")]


def close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.fixture
def no_launch():
    """Reset the counters; the CPU path must leave them at 0."""
    for mod, name in COUNTERS:
        setattr(mod, name, 0)
    yield
    assert [getattr(mod, name) for mod, name in COUNTERS] == [0] * len(COUNTERS)


# tests/test_kernels.py TestPallasConv.CASES plus the 7x7/s2 stem at 32
CONV_CASES = [
    (16, 3, 8, 7, 2),
    (8, 8, 16, 1, 1),
    (8, 16, 16, 3, 1),
    (8, 16, 16, 3, 2),
    (8, 8, 32, 3, 2),
    (32, 3, 8, 7, 2),
]


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES)
def test_conv2d_matches_pallas(rng, no_launch, h, cin, cout, k, stride):
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride)
    close(got, conv2d_pallas(jnp.asarray(x), jnp.asarray(w), stride, None, True))


def test_matmul_matches_pallas(rng, no_launch):
    from resnet_tpu.kernels import matmul as pallas_matmul

    a = rng.normal(size=(3, 2048)).astype(np.float32)
    b = (rng.normal(size=(2048, 1000)) * 0.01).astype(np.float32)
    got = matmul.matmul(torch.from_numpy(a), torch.from_numpy(b))
    close(got, pallas_matmul(jnp.asarray(a), jnp.asarray(b), True))


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 7, 7, 9)])
def test_add_relu_matches_pallas(rng, no_launch, shape):
    from resnet_tpu.kernels import add_relu as pallas_add_relu

    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    got = fused.add_relu(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pallas_add_relu(jnp.asarray(a), jnp.asarray(b), True)))


@pytest.mark.parametrize("call", [
    lambda: fused.add_relu(torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)),
    lambda: fused.add_relu(torch.zeros(4, 4).t(), torch.zeros(4, 4)),
    lambda: fused.add_relu(torch.zeros(4), torch.zeros(5)),
    lambda: fused.add_relu(torch.zeros(4, device="meta"), torch.zeros(4, device="meta")),
    lambda: matmul.matmul(torch.zeros(2, 3), torch.zeros(4, 5)),
    # bf16 operands are taken since the bf16 entry points; one beside fp32 is not
    lambda: matmul.matmul(torch.zeros(2, 3, dtype=torch.bfloat16), torch.zeros(3, 5)),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(2, 2, 3, 4)),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 4, 4)),
    lambda: conv.conv2d(torch.zeros(1, 7, 7, 3), torch.zeros(3, 3, 3, 4), 2),
    lambda: conv.conv2d(torch.zeros(1, 8, 8, 3), torch.zeros(3, 3, 3, 4, device="meta")),
], ids=["f64", "strided", "shapes", "meta", "mm-shapes", "mm-bf16",
        "even-k", "cin", "ragged-stride", "mixed-devices"])
def test_wrappers_reject_what_the_kernels_do_not_take(no_launch, call):
    with pytest.raises((TypeError, ValueError)):
        call()


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no library: load() raises instead of handing back anything
    that would compute on the CPU."""
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load()
    finally:
        build.load.cache_clear()
    assert not (tmp_path / "build").exists()


def test_sources_and_signatures_agree():
    """Every C entry point the loader binds is defined in csrc/, and the
    library hash changes with the sources."""
    text = "".join(p.read_text() for p in build.sources())
    for name, argtypes in build.SIGNATURES.items():
        assert f'extern "C" int {name}(' in text, name
        assert argtypes[-1] is build.ctypes.c_void_p  # the stream
    assert {p.name for p in build.sources()} == {
        "conv.cu", "matmul.cu", "add_relu.cu", "moments.cu", "adam.cu", "bn.cu",
        "fused_conv.cu", "block_fused.cu", "qconv.cu"}
    # the headers are in the hash too: the GEMM cores and the shared device code
    assert {p.name for p in build.CSRC.glob("*.cuh")} == {
        "tiled_gemm.cuh", "tc_gemm.cuh", "wg_gemm.cuh", "fused_conv.cuh", "rowwise.cuh",
        "im2col.cuh", "bf16_gemm.cuh", "wgb_gemm.cuh"}
    text = "".join(p.read_text() for p in build.CSRC.glob("*.cu*"))
    assert '#include "tc_gemm.cuh"' in text
    assert build.library_path().name == f"libkernels-{build.source_hash()}.so"
    # the planners' and the statistics workspaces' view of the tc core
    tc = (build.CSRC / "tc_gemm.cuh").read_text()
    for name, value in (("BM", build.TC_BM), ("BK", build.TC_BK), ("STAGES", build.TC_STAGES)):
        assert f"constexpr int {name} = {value};" in tc, name
    # ... and of the wgmma core (K10): its tile, ring depths and residency
    wg = (build.CSRC / "wg_gemm.cuh").read_text()
    assert f"constexpr int BM = {build.WG_BM};" in wg
    assert build.WG_BK == build.TC_BK and "constexpr int BK = tc::BK;" in wg
    assert (f"STAGES = BN == 64 ? {build.WG_STAGES[64]} : {build.WG_STAGES[128]};" in wg)
    assert (f"MIN_BLOCKS = BN == 64 ? {build.WG_BLOCKS_PER_SM[64]} : "
            f"{build.WG_BLOCKS_PER_SM[128]};" in wg)
    # ... and of the bf16 wgmma core (K1's bf16 dW, K8-bf16, K10-bf16)
    wgb = (build.CSRC / "wgb_gemm.cuh").read_text()
    assert f"constexpr int BM = {build.WGB_BM};" in wgb
    assert f"constexpr int BK = {build.WGB_BK};" in wgb
    assert (f"STAGES = BN == 64 ? {build.WGB_STAGES[64]} : {build.WGB_STAGES[128]};" in wgb)
    assert (f"MIN_BLOCKS = BN == 64 ? {build.WGB_BLOCKS_PER_SM[64]} : "
            f"{build.WGB_BLOCKS_PER_SM[128]};" in wgb)


# --- backward passes and the training kernels, against the JAX VJPs ---

def _vjp(fn, *args):
    """(output, VJP at a fixed cotangent) of a JAX function."""
    import jax

    out, pullback = jax.vjp(fn, *args)
    ct = jax.tree.map(lambda o: jnp.asarray(
        np.random.default_rng(7).normal(size=o.shape).astype(np.float32)), out)
    return out, ct, pullback(ct)


def _torch_vjp(fn, cts, *args):
    """(output, input gradients) of a port function at the given cotangents."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in args]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cts = cts if isinstance(cts, tuple) else (cts,)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(np.array(c)) for c in cts])
    return out, grads


@pytest.mark.parametrize("h,cin,cout,k,stride", CONV_CASES[:5])
def test_conv2d_vjp_matches_pallas(rng, no_launch, h, cin, cout, k, stride):
    """dx and dW through the autograd Function's plain versions against the
    Pallas custom VJP in interpret mode (dilate + flip + conv, per-tap
    matmuls), within 1e-4 of max|JAX| per gradient."""
    from resnet_tpu.kernels.conv import conv2d_pallas

    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) * 0.1).astype(np.float32)
    want, ct, (dx, dw) = _vjp(lambda a, b: conv2d_pallas(a, b, stride, None, True),
                              jnp.asarray(x), jnp.asarray(w))
    got, (gx, gw) = _torch_vjp(lambda a, b: conv.conv2d(a, b, stride), ct, x, w)
    close(got.detach(), want)
    close(gx, dx)
    close(gw, dw)


def test_conv2d_skips_dx_for_an_input_without_grad(rng, no_launch):
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)).astype(np.float32))
    w.requires_grad_(True)
    conv.conv2d(x, w, 2).sum().backward()
    assert x.grad is None and w.grad.shape == w.shape


@pytest.mark.parametrize("m,k,n", [(3, 2048, 1000), (8, 40, 24), (1, 7, 5),
                                   (32, 2048, 1000)])
def test_matmul_vjp_matches_pallas(rng, no_launch, m, k, n):
    """g @ b^T and a^T @ g, ragged shapes and the training FC's own shape
    included, within 1e-4."""
    from resnet_tpu.kernels import matmul as pallas_matmul

    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.01).astype(np.float32)
    want, ct, (da, db) = _vjp(lambda x, y: pallas_matmul(x, y, True),
                              jnp.asarray(a), jnp.asarray(b))
    got, (ga, gb) = _torch_vjp(matmul.matmul, ct, a, b)
    close(got.detach(), want)
    close(ga, da)
    close(gb, db)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (3, 7, 7, 9)])
def test_add_relu_vjp_matches_pallas(rng, no_launch, shape):
    """The mask backward: the same gradient for both inputs, exactly; a sum
    of exactly 0 passes none (strict >)."""
    from resnet_tpu.kernels import add_relu as pallas_add_relu

    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    b.reshape(-1)[:5] = -a.reshape(-1)[:5]
    _, ct, (da, db) = _vjp(lambda x, y: pallas_add_relu(x, y, True),
                           jnp.asarray(a), jnp.asarray(b))
    _, (ga, gb) = _torch_vjp(fused.add_relu, ct, a, b)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(da))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(db))
    assert (ga.numpy().reshape(-1)[:5] == 0).all()


@pytest.mark.parametrize("m,c,grad", [
    pytest.param(m, c, grad, id=f"{m}-{c}" + ("" if grad else "-no-grad"))
    for grad in (True, False) for m, c in [(2 * 8 * 8, 16), (1000, 33), (3, 2048)]])
def test_moments_matches_pallas(rng, no_launch, m, c, grad):
    """mean, biased var and their closed-form VJP against the Pallas stats
    kernel in interpret mode, within 1e-4 of max|JAX|; an input without a
    gradient skips the autograd Function and gives the same values."""
    from resnet_tpu.kernels.bn import moments as pallas_moments

    x = (rng.normal(size=(m, c)) * 3 + rng.normal(size=(1, c))).astype(np.float32)
    (mean, var), ct, (dx,) = _vjp(lambda a: pallas_moments(a, True), jnp.asarray(x))
    if grad:
        (gm, gv), (gx,) = _torch_vjp(bn.moments, ct, x)
        assert gm.grad_fn is not None
        close(gx, dx)
    else:
        gm, gv = bn.moments(torch.from_numpy(x))
        assert gm.grad_fn is None and gv.grad_fn is None
    close(gm.detach(), mean)
    close(gv.detach(), var)
    pm, pv = bn.moments_reference(torch.from_numpy(x))
    np.testing.assert_array_equal(pm.numpy(), gm.detach().numpy())


# (M, C, load width): the 16-byte loads where C % 4 == 0
PLAN_CASES = [(m, c, vec) for m, c in [(1, 4), (1000, 33), (1000, 36), (401408, 64),
                                       (100352, 256), (1568, 2048), (7, 3), (2000, 132)]
              for vec in (1, 4) if vec == 1 or c % 4 == 0]


@pytest.mark.parametrize("m,c,vec", PLAN_CASES)
def test_moments_plan_covers_every_row_and_tile_once(m, c, vec):
    """K4's one-launch grid, walked as csrc/moments.cu walks it: block
    (tile, chunk), thread (lane, row lane), each lane vec channels. Every
    (row, channel) is read by exactly one thread, each tile's chunk
    partials come from n_chunks blocks (its ticket's count), the
    partials fit the workspace, and the plan is cached."""
    plan = bn.moments_plan(m, c, vec)
    assert bn.moments_plan(m, c, vec) is plan
    ctv, tiles, chunk, n_chunks, part, threads = plan
    tc = vec * ctv
    assert threads in bn._MOMENTS_THREADS
    assert ctv & (ctv - 1) == 0 and vec * ctv <= 32 and threads % ctv == 0
    assert 2 * tc <= threads  # one thread per (sum, channel) of a tile
    # 1024 threads for a few tiles where two blocks per SM give each
    # thread at least 4 rows
    two_per_sm = bn._chunk_rows(m, tiles, 2 * 132)
    assert (threads == 1024) == (tiles <= 4 and two_per_sm >= 4 * (1024 // ctv))
    assert (tiles - 1) * tc < c <= tiles * tc
    assert chunk % 8 == 0 and chunk >= 64 and n_chunks <= 65535
    assert (n_chunks - 1) * chunk < m <= n_chunks * chunk
    assert part == 2 * n_chunks * c
    if m * c > 2_000_000:
        return  # the walk below at the small shapes
    row_lanes = threads // ctv
    reads = np.zeros((m, c), dtype=np.int64)
    for tile in range(tiles):
        for k in range(n_chunks):
            r0, r1 = k * chunk, min(m, (k + 1) * chunk)
            for lane in range(ctv):
                c0 = tile * tc + lane * vec
                if c0 >= c:
                    continue
                for row_lane in range(row_lanes):
                    reads[r0 + row_lane:r1:row_lanes, c0:c0 + vec] += 1
    assert (reads == 1).all()


def test_moments_constants_match_the_kernel():
    src = (build.CSRC / "moments.cu").read_text()
    large, small = bn._MOMENTS_THREADS
    assert f"constexpr int LARGE = {large};" in src and f"constexpr int SMALL = {small};" in src
    src = (build.CSRC / "adam.cu").read_text()
    assert f"constexpr int64_t CHUNK = {adam._CHUNK};" in src
    assert f"constexpr int MAX_ROWS = {adam.MAX_ROWS};" in src
    assert f"constexpr int COLS = {adam._COLS};" in src
    # a row of (p, g, m, v, numel, first, flag) is 48 bytes; the table stays
    # inside the 32,764 bytes a kernel's parameters may hold
    assert 8 + 48 * adam.MAX_ROWS <= 32764


@pytest.mark.parametrize("c,offset,want", [(64, 0, 4), (33, 0, 1), (64, 1, 1), (64, 4, 4)])
def test_moments_loads_16_bytes_where_aligned(c, offset, want):
    base = torch.zeros(10 * c + offset)
    assert base.data_ptr() % 16 == 0
    assert bn.vector_width(base[offset:].view(10, c)) == want


def test_adam_rows_group_at_the_parameter_bank_capacity():
    """Rows in order, one per tensor with elements; the first block counts
    from 0 again at each group of MAX_ROWS rows (one launch each); the flag
    where p, m, v are aligned and numel % 4 == 0."""
    cap = adam.MAX_ROWS
    numels = [(i % 7) * 1000 + (i % 3) for i in range(2 * cap + 50)]
    aligned = [i % 5 != 0 for i in range(len(numels))]
    rows = adam.pack_rows(numels, aligned)
    assert [r[0] for r in rows] == [i for i, n in enumerate(numels) if n]
    assert len(rows) > 2 * cap
    for g in range(0, len(rows), cap):
        group = rows[g:g + cap]
        first = 0
        for i, n, start, flag in group:
            assert n == numels[i] and start == first
            assert flag == int(aligned[i] and n % 4 == 0)
            first += -(-n // adam._CHUNK)
    assert adam.pack_rows([0, 0], [True, True]) == []
    assert adam.pack_rows([4096, 1, 0, 8], [True] * 4) == [
        (0, 4096, 0, 1), (1, 1, 1, 0), (3, 8, 2, 1)]


def _adam_state(shapes, offset=0):
    def make(s):
        n = int(np.prod(s))
        return torch.zeros(n + offset)[offset:].view(s)

    return ([make(s) for s in shapes], [make(s) for s in shapes],
            [make(s) for s in shapes])


def test_adam_state_plan_is_cached_until_a_tensor_or_its_storage_changes():
    """The (p, m, v) rows are made once: the same tensors give the same plan;
    a replaced tensor or a moved storage makes a new one. Run on CPU
    tensors (device index -1), as the plan's checks and pointers are the
    same there."""
    adam._PLANS.clear()
    shapes = [(3, 3, 4, 8), (0,), (5, 7), (8,)]
    p, m, v = _adam_state(shapes)
    plan = adam._state_plan(p, m, v, -1)
    assert adam._state_plan(list(p), list(m), list(v), -1) is plan
    assert plan.n_rows == 3  # the empty tensor gets no row
    table = np.ctypeslib.as_array(plan.table).reshape(plan.n_rows, adam._COLS)
    assert table[:, 6].tolist() == [0, 2, 3]
    assert table[:, 0].tolist() == [p[i].data_ptr() for i in (0, 2, 3)]
    assert table[:, 3].tolist() == [288, 35, 8]
    assert table[:, 5].tolist() == [int(p[i].data_ptr() % 16 == 0 and i != 2)
                                    for i in (0, 2, 3)]
    m[2] = m[2].clone()  # a new tensor
    replaced = adam._state_plan(p, m, v, -1)
    assert replaced is not plan
    assert np.ctypeslib.as_array(replaced.table)[1 * adam._COLS + 1] == m[2].data_ptr()
    assert adam._state_plan(p, m, v, -1) is replaced
    v[0].data = torch.ones_like(v[0])  # the same tensor on another storage
    moved = adam._state_plan(p, m, v, -1)
    assert moved is not replaced
    assert np.ctypeslib.as_array(moved.table)[2] == v[0].data_ptr()


def test_adam_gradients_are_checked_on_every_call():
    p, m, v = _adam_state([(2, 3), (4,)])
    plan = adam._state_plan(p, m, v, -1)
    g = [torch.ones(2, 3), torch.ones(4)]
    assert list(adam._grad_pointers(g, plan)) == [t.data_ptr() for t in g]
    with pytest.raises(ValueError, match="shape"):
        adam._grad_pointers([torch.ones(3, 2), g[1]], plan)
    with pytest.raises(TypeError):
        adam._grad_pointers([g[0].double(), g[1]], plan)
    with pytest.raises(ValueError, match="contiguous"):
        adam._grad_pointers([torch.ones(3, 2).t(), g[1]], plan)
    with pytest.raises(ValueError, match="shapes"):
        adam._state_plan(p, [torch.zeros(3, 2), m[1]], v, -1)
    with pytest.raises(TypeError):
        adam._state_plan(p, m, [v[0].double(), v[1]], -1)


def test_launches_hand_their_arguments_to_the_entry_points(monkeypatch):
    """K4's and K7's launch helpers, run on CPU tensors with the C entry
    point recorded instead of called: the argument order of
    build.SIGNATURES, the workspace and the tables they pass."""
    calls = []
    monkeypatch.setattr(build, "entry", lambda name: name)
    monkeypatch.setattr(build, "launch_on", lambda index, stream, fn, *args:
                        calls.append((fn, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7,
                        raising=False)
    x = torch.zeros(1000, 64)
    plan = bn.moments_plan(1000, 64, 4)
    out = torch.empty(2, 64)
    monkeypatch.setitem(bn._WORKSPACES, (None, 7), [torch.empty(plan.part),
                                                    torch.zeros(plan.tiles, dtype=torch.int32)])
    bn._launch(x, out, plan, 4)
    part, tickets = bn._WORKSPACES[(None, 7)]
    assert calls[-1] == ("rt_moments_f32", (
        x.data_ptr(), part.data_ptr(), tickets.data_ptr(), out.data_ptr(), 1000, 64,
        plan.chunk, plan.n_chunks, 4, plan.ctv, plan.threads))
    assert len(calls[-1][1]) + 1 == len(build.SIGNATURES["rt_moments_f32"])
    p, m, v = _adam_state([(2, 3), (4,)])
    state = adam._state_plan(p, m, v, -1)
    g = [torch.ones(2, 3), torch.ones(4)]
    h = torch.zeros(8)
    adam._launch(state, adam._grad_pointers(g, state), h)
    fn, args = calls[-1]
    assert fn == "rt_adam_f32" and len(args) + 1 == len(build.SIGNATURES[fn])
    assert args[0] == build.ctypes.addressof(state.table) and args[1] == 2
    assert args[2] == build.ctypes.addressof(state.grads) and args[3] == h.data_ptr()
    assert list(state.grads) == [t.data_ptr() for t in g]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_count_moves_the_counter_of_the_tensors_dtype(monkeypatch, dtype):
    """build.count adds one to a wrapper's counter for fp32 and to its
    _BF16 twin for bfloat16, and to nothing else."""
    pairs = [(mod, name) for mod, name in COUNTERS if mod is not adam]
    for mod, name in pairs:
        for key in (name, name + "_BF16"):
            monkeypatch.setattr(mod, key, 0)
    t = torch.zeros(2, dtype=dtype)
    for mod, name in pairs:
        build.count(mod.__name__, name, t)
        build.count(mod.__name__, name, t)
    for mod, name in pairs:
        key, other = (name + "_BF16", name) if dtype is torch.bfloat16 else (name, name + "_BF16")
        assert (getattr(mod, key), getattr(mod, other)) == (2, 0), (mod.__name__, name)


@pytest.mark.parametrize("lr_kind", ["float", "device scalar", "mixed"])
def test_hyper_row_values(lr_kind):
    """The same 8 fp32 values whether lr and the decay products come as
    Python numbers or as scalars on the device, the constant hypers copied
    to the device once."""
    lr, cmd, cvd = 3e-4, np.float32(0.9) ** 3, np.float32(0.999) ** 3
    want = torch.tensor([lr, 1e-2, 0.9, 0.999, 1e-7, cmd, cvd, 1.0], dtype=torch.float32)
    if lr_kind == "float":
        h = adam.hyper_row(lr, 1e-2, 0.9, 0.999, 1e-7, cmd, cvd, True, "cpu")
    elif lr_kind == "mixed":
        h = adam.hyper_row(torch.tensor(lr), 1e-2, 0.9, 0.999, 1e-7, cmd, cvd, True, "cpu")
    else:
        adam._device_row.cache_clear()
        for _ in range(2):
            adam.hyper_row(torch.tensor(lr), 1e-2, 0.9, 0.999, 1e-7, torch.tensor(cmd),
                           torch.tensor(cvd), True, "cpu")
        assert adam._device_row.cache_info().misses == 1
        h = adam.hyper_row(torch.tensor(lr), 1e-2, 0.9, 0.999, 1e-7, torch.tensor(cmd),
                           torch.tensor(cvd), True, "cpu")
    assert h.dtype == torch.float32 and torch.equal(h, want)
    off = adam.hyper_row(lr, 1e-2, 0.9, 0.999, 1e-7, cmd, cvd, False, "cpu")
    assert off[7].item() == 0.0 and torch.equal(off[:7], want[:7])


@pytest.mark.parametrize("m", [1, 1000, 401408])
@pytest.mark.parametrize("c", [3, 64, 2048])
def test_moments_chunking_covers_every_row(m, c):
    """K6's row chunks (``bn.bn_bwd_plan``) cover every row once, in both
    load widths its C allows."""
    for vec in {1, 4 if c % 4 == 0 else 1, 8 if c % 8 == 0 else 1}:
        plan = bn.bn_bwd_plan(m, c, vec, 132)
        rows, chunks = plan.chunk, plan.n_chunks
        assert rows % 8 == 0 and rows >= 8 and chunks <= 65535
        assert (chunks - 1) * rows < m <= chunks * rows


@pytest.mark.parametrize("guard,lr_kind", [
    pytest.param(guard, lr_kind, id=str(guard) + ("" if lr_kind == "float" else "-device-lr"))
    for lr_kind in ("float", "device scalar") for guard in (True, False)])
def test_fused_adam_matches_pallas(rng, no_launch, guard, lr_kind):
    """The in-place list update against fused_adam_flat in interpret mode,
    with NaN and inf in the gradients and an inf parameter, the guard on and
    off: every finite value within 1e-6 of max|JAX| (fp32 elementwise, one
    rounding apart), non-finite positions identical."""
    from resnet_tpu.kernels import fused_adam_flat

    shapes = [(3, 3, 4, 8), (8,), (5, 7)]
    ps = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    gs = [rng.normal(size=s).astype(np.float32) * 1e-2 for s in shapes]
    ms = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in shapes]
    vs = [rng.normal(size=s).astype(np.float32) ** 2 * 1e-4 for s in shapes]
    gs[0].reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    ps[2].reshape(-1)[4] = np.inf
    hyper = dict(learning_rate=1e-3, weight_decay=1e-2, beta1=0.9, beta2=0.999,
                 eps=1e-7, cur_mean_decay=np.float32(0.9) ** 3,
                 cur_var_decay=np.float32(0.999) ** 3)
    flat = [jnp.asarray(np.concatenate([a.reshape(-1) for a in t]))
            for t in (ps, gs, ms, vs)]
    want = fused_adam_flat(*flat, nonfinite_guard=guard, interpret=True, **hyper)
    tp, tm, tv = ([torch.from_numpy(a.copy()) for a in t] for t in (ps, ms, vs))
    lr = hyper["learning_rate"]
    lr = torch.tensor(lr, dtype=torch.float32) if lr_kind == "device scalar" else lr
    h = adam.hyper_row(lr, hyper["weight_decay"], hyper["beta1"],
                       hyper["beta2"], hyper["eps"], hyper["cur_mean_decay"],
                       hyper["cur_var_decay"], guard, "cpu")
    adam.fused_adam(tp, [torch.from_numpy(g) for g in gs], tm, tv, h)
    for got, w in zip((tp, tm, tv), want):
        got = torch.cat([t.reshape(-1) for t in got]).numpy()
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(w))
        fin = np.isfinite(w)
        assert np.abs(got[fin] - w[fin]).max() <= 1e-6 * np.abs(w[fin]).max()
    # the guard keeps m, v at a non-finite gradient and rolls the inf back
    assert np.isfinite(tm[0].numpy().reshape(-1)[:3]).all() == guard
    assert (tp[2].numpy().reshape(-1)[4] == np.inf) == guard


@pytest.mark.parametrize("m,n,k,want", [
    (147, 64, 401408, 88), (8, 1000, 2048, 4), (2048, 512, 1568, 1), (64, 64, 500, 1)])
def test_split_k_depends_on_the_shapes_only(m, n, k, want):
    assert build.split_k(m, n, k) == want


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (7, 1), (1, 2), (3, 2), (7, 2)])
def test_dx_phases_cover_every_tap_once(k, stride):
    """The phase split of the dx kernel: every tap (i, j) belongs to exactly
    one phase (py, px), the one whose input rows it reaches, and the phase
    weights hold w^T's taps in the kernel's (phase, ti, tj, co) order."""
    w = torch.arange(k * k * 2 * 3, dtype=torch.float32).reshape(k, k, 2, 3)
    wp = conv.dx_phase_weights(w, stride)
    assert wp.shape == (k * k * 3, 2)
    taps = [(py, first + stride * t)
            for py in range(stride)
            for first, count in [conv.phase_taps(py, k, stride)]
            for t in range(count)]
    assert sorted(i for _, i in taps) == list(range(k))
    for py, i in taps:  # tap i reaches input rows iy with (iy + k/2 - i) % s == 0
        assert (py + k // 2 - i) % stride == 0
    rows, off = [], 0
    for py in range(stride):
        for px in range(stride):
            fy, ny = conv.phase_taps(py, k, stride)
            fx, nx = conv.phase_taps(px, k, stride)
            for ti in range(ny):
                for tj in range(nx):
                    rows.append(w[fy + stride * ti, fx + stride * tj].t())
    assert torch.equal(wp, torch.cat(rows))


# --- the redesigned dW and FC kernels: plans, routes and their arithmetic ---

def _chunks(k, splits, step):
    """The [lo, hi) K ranges the C launchers give each split."""
    chunk = build.k_chunk(k, splits, step)
    return chunk, [(z * chunk, min(k, (z + 1) * chunk)) for z in range(splits)]


def _assert_covers(k, ranges):
    """Every K element in exactly one non-empty range, in order."""
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(k, k)]):
        assert lo < hi == nlo


# (m = k*k*Cin, n = Cout, k = pixels, splits): ResNet-50's dW at batch 32
# (the check cases of kernels/checks.py), the two ragged check cases, and
# edges
DW_PLANS = [
    (147, 64, 401408, 131), (64, 64, 100352, 196), (64, 256, 100352, 66),
    (576, 64, 100352, 52), (1152, 128, 25088, 14), (2304, 512, 25088, 11),
    (2048, 512, 1568, 2), (81, 33, 98, 1), (180, 24, 1458, 3),
    (4608, 512, 1568, 3), (9, 1, 1, 1), (27, 8, 10**6, 255)]


def _waves_times_steps(m, n, k, splits):
    """The plan's cost: waves of resident blocks x (chunk steps + fill)."""
    bn = build.tc_tile_n(n)
    tiles = -(-m // build.TC_BM) * -(-n // bn)
    resident = 132 * build.TC_BLOCKS_PER_SM[bn]
    return (-(-tiles * splits // resident)
            * (build.k_chunk(k, splits, build.TC_BK) // build.TC_BK + build.TC_STAGES - 1))


def _candidates(k):
    """The split counts tc_split may take for depth k: up to ceil(k / 512),
    and, past one split, only those whose chunks, rounded to whole K-steps,
    are 16 K-steps deep or more."""
    most = min(256, max(1, -(-k // (16 * build.TC_BK))))
    counts = {build._drop_empty(k, s, build.TC_BK) for s in range(1, most + 1)}
    return sorted(s for s in counts
                  if s == 1 or build.k_chunk(k, s, build.TC_BK) >= 16 * build.TC_BK)


@pytest.mark.parametrize("m,n,k,want", DW_PLANS)
def test_dw_split_covers_every_pixel_once(m, n, k, want):
    """tc_gemm.cuh's split-K plan for dW: the pinned count, every pixel in
    exactly one split, chunks of whole 32-pixel K-steps, grid within its
    limits, each split 512 pixels deep or more (as far as the shapes
    allow), no count in range that finishes in fewer waves x steps, and
    nothing but the shapes decides it."""
    splits = build.tc_split(m, n, k)
    assert splits == want == build.tc_split(m, n, k)
    chunk, ranges = _chunks(k, splits, build.TC_BK)
    assert chunk % build.TC_BK == 0
    _assert_covers(k, ranges)
    assert -(-n // build.tc_tile_n(n)) <= 65535 and 1 <= splits <= 256
    most = min(256, max(1, -(-k // (16 * build.TC_BK))))
    assert splits <= most
    assert splits == 1 or chunk >= 16 * build.TC_BK
    cost = _waves_times_steps(m, n, k, splits)
    assert all(_waves_times_steps(m, n, k, s) >= cost for s in _candidates(k))


@pytest.mark.parametrize("n,k,want", [
    (1000, 2048, 9), (33, 300, 19), (1000, 4096, 16), (5, 17, 2), (1000, 1, 1),
    (70000, 64, 1), (1000, 16, 1)])
def test_skinny_split_covers_every_row_once(n, k, want):
    """The skinny FC kernel's plan: the FC's 9 splits of 240 rows over 32
    slabs (288 blocks), every K row in exactly one chunk, chunks of whole
    16-row stages and at most 256 rows (A's chunk in shared memory), two
    blocks per SM unless the depth runs out, and a function of the shapes
    only."""
    splits = build.skinny_split(8, n, k)
    assert splits == want == build.skinny_split(8, n, k) == build.skinny_split(32, n, k)
    chunk, ranges = _chunks(k, splits, build.SKINNY_STAGE)
    assert chunk % build.SKINNY_STAGE == 0 and chunk <= build.SKINNY_MAX_CHUNK
    _assert_covers(k, ranges)
    slabs = -(-n // build.SKINNY_COLS)
    assert slabs <= 65535 and splits < 2**31
    assert slabs * (splits + 1) >= 2 * 132 or splits + 1 >= -(-k // build.SKINNY_STAGE)


@pytest.mark.parametrize("m,route", [(1, "skinny"), (3, "skinny"), (8, "skinny"),
                                     (32, "skinny"), (33, "tiled"), (64, "tiled"),
                                     (256, "tiled")])
def test_matmul_route_by_batch(m, route):
    """The FC at batch 1-32 takes the skinny kernel, larger batches the
    tiled one; the check cases name their route."""
    assert matmul.matmul_route(m, 1000, 2048) == route
    from resnet_tpu_torch.kernels import checks

    labels = [c[0] for c in checks.MATMUL_CASES]
    if m in (1, 3, 8, 32, 64):
        assert f"fc ({m},2048)@(2048,1000) {route}" in labels


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to nearest onto 10 mantissa bits, ties away from zero, as
    cvt.rna.tf32.f32 does: add half of the 13 dropped bits to the
    magnitude's bit pattern and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2.0**-10, 1 + 2.0**-11, 1 + 3 * 2.0**-11, -(1 + 2.0**-11),
                      1 + 2.0**-12], dtype=torch.float32)
    want = [1.0, 1 + 2.0**-10, 1 + 2.0**-10, 1 + 2 * 2.0**-10, -(1 + 2.0**-10), 1.0]
    assert _tf32(x).tolist() == want


# the deepest GEMM of each tc_gemm.cuh user in ResNet-50's reference
# topology: dW's projection (25,088 pixels at batch 32), dx's stage-4 3x3
# (9 * 512) and its 3x3/s2 projection's deepest phase (2 x 2 taps * 2048),
# and K8's stage-4 3x3/s2 projection (9 * 1024)
SPLIT_DEPTHS = {"dw proj": 25088, "dx 3x3 512": 4608, "dx proj phase": 8192,
                "fused conv proj": 9216}


@pytest.mark.parametrize("depth", SPLIT_DEPTHS.values(), ids=SPLIT_DEPTHS.keys())
def test_split_tf32_meets_the_fp32_contract_at_dw_depth(rng, depth):
    """The numerical ground of tc_gemm.cuh: at the depth of each of its
    users' deepest GEMM (a 32 x 32 output), the split a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi of tf32 values, summed in fp32 (a product of two tf32 values
    is exact in fp32), stays within 1e-5 of max|fp64|, as plain fp32 does;
    one TF32 pass misses the port's 1e-4 contract."""
    a = torch.from_numpy(rng.normal(size=(32, depth)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(depth, 32)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()

    def rel(out):
        return (out.double() - exact).abs().max().item() / scale

    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    split = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    assert rel(split) <= 1e-5
    assert rel(a @ b) <= 1e-5
    assert rel(a_hi @ b_hi) > 1e-4


# --- the K-major A tile of tc_gemm.cuh and the planner of its three users ---

def _tc_source():
    return (build.CSRC / "tc_gemm.cuh").read_text()


def _constant(src, name):
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _fragment_reads(src, kmajor):
    """The A fragment's base expression and its four reads in mma_slice's
    branch for one layout, as the source writes them."""
    import re

    body = src[src.index("void mma_slice("):]
    body = body[:body.index("const float* br")]
    kbranch, mbranch = body.split("} else {")
    branch = kbranch if kmajor else mbranch
    base = re.search(r"const float\* ar = as \+ (.+);", branch).group(1)
    reads = re.findall(r"split_tf32\(ar\[(.+?)\], ah", branch)
    assert len(reads) == 4
    return base, reads


@pytest.mark.parametrize("kmajor", [True, False], ids=["K-major", "M-fast"])
def test_a_fragment_reads_hit_32_banks(kmajor):
    """tc_gemm.cuh's A fragment reads, evaluated as its source writes them:
    lane (gid, tig) of every m16 tile reads A(gid, tig), A(gid + 8, tig),
    A(gid, tig + 4) and A(gid + 8, tig + 4) of the warp's rows and the
    8-deep step (the m16n8k8 tf32 layout), and the 32 lanes of each of the
    four loads hit 32 distinct banks. K-major slices are [BM][BK + KPAD],
    M-fast ones [BK][BM + PAD]; the K-major row stride keeps 16-byte copies
    of four columns aligned."""
    src = _tc_source()
    bm, bk = _constant(src, "BM"), _constant(src, "BK")
    ld = bk + _constant(src, "KPAD") if kmajor else bm + _constant(src, "PAD")
    if kmajor:
        assert ld % 4 == 0 and (bm * ld) % 4 == 0
    base, reads = _fragment_reads(src, kmajor)
    want = [(0, 0), (8, 0), (0, 4), (8, 4)]  # (row, column) past (gid, tig)
    for wm0 in (0, 32, 64):
        for ks in range(0, bk, 8):
            for i in range(2):
                for read, (dm, dk) in zip(reads, want):
                    banks = set()
                    for lane in range(32):
                        gid, tig = lane >> 2, lane & 3
                        env = dict(wm0=wm0, ks=ks, gid=gid, tig=tig, i=i, LDK=ld, LDA=ld)
                        addr = eval(base, env) + eval(read, env)
                        m, k = divmod(addr, ld) if kmajor else divmod(addr, ld)[::-1]
                        assert (m, k) == (wm0 + i * 16 + gid + dm, ks + tig + dk)
                        banks.add(addr % 32)
                    assert len(banks) == 32


def _resnet50_convs():
    """(k, Cin, Cout, stride, input H=W) of each block conv of ResNet-50 in
    the reference topology at 224^2 (the fused engine's 52 convs)."""
    from resnet_tpu_torch.config import model_config
    from resnet_tpu_torch.models import init_params

    mcfg = model_config("resnet50")
    params = init_params(torch.Generator().manual_seed(0), mcfg, device="meta")
    h = mcfg.input_dim // mcfg.init_stride // mcfg.maxpool_stride
    convs = []
    for i, bp in enumerate(params["blocks"]):
        s = 2 if mcfg.is_reduction_block(i) else 1
        for name, stride, size in (("reduce", 1, h), ("spatial", s, h),
                                   ("expand", 1, h // s), ("proj", s, h)):
            if name in bp:
                k, _, cin, cout = bp[name]["w"].shape
                convs.append((k, cin, cout, stride, size))
        h //= s
    assert len(convs) == 52
    return convs


def _tc_gemms(batch=32):
    """(m, n, k) of the K-split GEMMs dx (stride 1; a strided dx does not
    split) and K8 run for ResNet-50's block convs, without repeats."""
    out = []
    for k, cin, cout, s, h in _resnet50_convs():
        if s == 1:
            out.append(("dx", batch * h * h, cin, k * k * cout))
        out.append(("fused conv", batch * (h // s) ** 2, cout, k * k * cin))
    return sorted(set(out))


def _conv_forward_gemms(batch):
    """(m, n, k) of K1's forward GEMMs for ResNet-50 at a batch: the 7x7/s2
    stem (K = 147) and the 52 block convs, without repeats."""
    from resnet_tpu_torch.config import model_config

    mcfg = model_config("resnet50")
    ho = mcfg.input_dim // mcfg.init_stride
    out = [("conv", batch * ho * ho, mcfg.init_filters, mcfg.init_kernel ** 2 * 3)]
    out += [("conv", batch * (h // s) ** 2, cout, k * k * cin)
            for k, cin, cout, s, h in _resnet50_convs()]
    return sorted(set(out))


TC_GEMMS = _tc_gemms() + _conv_forward_gemms(8) + _conv_forward_gemms(32)


@pytest.mark.parametrize("what,m,n,k", TC_GEMMS, ids=[f"{w} {m}x{n}x{k}" for w, m, n, k in TC_GEMMS])
def test_tc_split_covers_every_k_step_once(what, m, n, k):
    """The planner of tc_gemm.cuh's users at ResNet-50's dx and fused-conv
    GEMMs (batch 32) and the conv forward's (batch 8 and 32, the stem's
    K = 147 with a ragged last K-step): every K column in exactly one
    split, chunks of whole 32-deep K-steps, at most 256 splits, each at
    least 16 K-steps deep unless the depth has fewer, no count in range
    finishing in fewer waves x steps, and a function of the shapes only."""
    splits = build.tc_split(m, n, k)
    assert splits == build.tc_split(m, n, k)
    chunk, ranges = _chunks(k, splits, build.TC_BK)
    assert chunk % build.TC_BK == 0 and 1 <= splits <= 256
    _assert_covers(k, ranges)
    assert splits == 1 or chunk >= 16 * build.TC_BK
    cost = _waves_times_steps(m, n, k, splits)
    assert all(_waves_times_steps(m, n, k, s) >= cost for s in _candidates(k))


def test_tc_split_splits_the_stage_4_gemms():
    """At 7^2 a batch-32 GEMM has 13 row tiles: the deep ones split K (the
    dx of the 3x3 over 4,608 columns, K8's 3x3/s2 projection over 9,216),
    the 56^2 ones (784 row tiles) do not."""
    assert build.tc_split(32 * 49, 512, 4608) > 1
    assert build.tc_split(32 * 49, 2048, 9216) > 1
    assert build.tc_split(32 * 56 * 56, 64, 576) == 1


# (C, M) of ResNet-50's identity blocks at batch 32, stages 1-4, and the
# (Cout, K) of each block's three GEMMs (reduce, 3x3, expand)
BLOCK_STAGES = [(64, 32 * 56 * 56), (128, 32 * 28 * 28), (256, 32 * 14 * 14), (512, 32 * 7 * 7)]


def _block_gemms(c):
    return ((c, 4 * c), (c, 9 * c), (4 * c, c))


def _wg_cost(m, n, k, splits):
    """wg_split's cost: waves of resident blocks x (chunk steps + fill)."""
    bn = build.wg_tile_n(n)
    tiles = -(-m // build.WG_BM) * -(-n // bn)
    resident = 132 * build.WG_BLOCKS_PER_SM[bn]
    return (-(-tiles * splits // resident)
            * (build.k_chunk(k, splits, build.WG_BK) // build.WG_BK + build.WG_STAGES[bn] - 1))


WG_GEMMS = [(m, cout, k) for c, m in BLOCK_STAGES for cout, k in _block_gemms(c)] + [
    (75, 9, 36), (75, 9, 81), (75, 36, 9), (32, 129, 516), (32, 129, 1161), (32, 516, 129)]


@pytest.mark.parametrize("m,n,k", WG_GEMMS, ids=[f"{m}x{n}x{k}" for m, n, k in WG_GEMMS])
def test_wg_split_covers_every_k_step_once(m, n, k):
    """The planner of K10's GEMMs on the wgmma core (the four batch-32
    identity-block stages, then the ragged and split-K check cases):
    deterministic, every K column in exactly one split, chunks of whole
    32-deep K-steps, every split at least 16 K-steps deep unless the depth
    has fewer, and no count in range finishing in fewer waves x steps."""
    splits = build.wg_split(m, n, k)
    assert splits == build.wg_split(m, n, k)
    build.wg_split.cache_clear()
    assert splits == build.wg_split(m, n, k)
    chunk, ranges = _chunks(k, splits, build.WG_BK)
    assert chunk % build.WG_BK == 0 and 1 <= splits <= 256
    _assert_covers(k, ranges)
    assert splits == 1 or chunk >= 16 * build.WG_BK
    assert all(hi - lo >= min(k, 16 * build.WG_BK) for lo, hi in ranges[:-1])
    cost = _wg_cost(m, n, k, splits)
    assert all(_wg_cost(m, n, k, s) >= cost for s in _candidates(k))


def test_wg_split_fills_the_card_at_stage_4():
    """Stage 4 at batch 32 has 13 row tiles (M = 1,568): its reduce and 3x3
    (4 column tiles of 128, 52 tiles) split K, so they run on more blocks
    than they have tiles, and the deepest, the 3x3 over 4,608 columns, on
    more blocks than one wave of resident blocks (132); stage 1's GEMMs
    (784 row tiles) do not split."""
    c, m = BLOCK_STAGES[3]
    blocks = []
    for cout, k in _block_gemms(c):
        bn = build.wg_tile_n(cout)
        tiles = -(-m // build.WG_BM) * -(-cout // bn)
        blocks.append((tiles, tiles * build.wg_split(m, cout, k), 132 * build.WG_BLOCKS_PER_SM[bn]))
    (reduce_tiles, reduce_blocks, _), (tiles3, blocks3, wave3), _ = blocks
    assert reduce_blocks > reduce_tiles and blocks3 > tiles3
    assert blocks3 > wave3
    c, m = BLOCK_STAGES[0]
    assert all(build.wg_split(m, cout, k) == 1 for cout, k in _block_gemms(c))
    # the card check's split-K block (2, 4, 4, 516), C = 129: its 3x3 splits,
    # so its statistics come from the column pass over the summed y
    assert build.wg_split(2 * 4 * 4, 129, 9 * 129) > 1


# --- the FC backward: one launch for da = g @ b^T and db = a^T @ g ---

def _bwd_source():
    return (build.CSRC / "matmul.cu").read_text()


def test_matmul_bwd_constants_match_the_kernel():
    """build.py's view of matmul.cu's backward tiles is the kernel's."""
    src = _bwd_source()
    src = src[src.index("namespace bwd {"):src.index("}  // namespace bwd")]
    for name, value in (("R", build.BWD_R), ("MT", build.BWD_MT), ("NC", build.BWD_NC),
                        ("TK", build.BWD_TK), ("TN", build.BWD_TN), ("MC", build.BWD_MC)):
        assert _constant(src, name) == value, name


def _chunk_ranges(total, step):
    """The [lo, hi) contraction ranges a block walks: step columns (or rows)
    at a time, the last one ragged, in order."""
    return [(lo, min(total, lo + step)) for lo in range(0, total, step)]


# (m, k, n): the training FC, the check cases' ragged N and two row tiles,
# a batch-1 FC, and small ragged edges
BWD_SHAPES = [(32, 2048, 1000), (5, 300, 33), (64, 2048, 1000), (1, 2048, 1000),
              (33, 17, 129), (1, 1, 1)]


@pytest.mark.parametrize("need_a,need_b", [(True, True), (True, False), (False, True)],
                         ids=["both", "da", "db"])
@pytest.mark.parametrize("m,k,n", BWD_SHAPES)
def test_matmul_bwd_plan_gives_each_output_one_owner(m, k, n, need_a, need_b):
    """rt_matmul_bwd_f32's plan, decoded as the kernel decodes blockIdx: da's
    blocks come first, every element of da and of db (where needed) has
    exactly one owning block, every contraction row of a block lies in
    exactly one chunk (its slices of N for da, its steps of M for db), and
    the plan is a function of the shapes only (so a run repeats)."""
    da_blocks, db_blocks = build.matmul_bwd_plan(m, k, n, need_a, need_b)
    assert (da_blocks, db_blocks) == build.matmul_bwd_plan(m, k, n, need_a, need_b)
    assert (da_blocks > 0) == need_a and (db_blocks > 0) == need_b
    da_owner = np.zeros((m, k), dtype=int)
    db_owner = np.zeros((k, n), dtype=int)
    slabs = -(-k // build.BWD_R)
    ntiles = -(-n // build.BWD_TN)
    for block in range(da_blocks + db_blocks):
        if block < da_blocks:
            slab, mtile = block % slabs, block // slabs
            rows = slice(mtile * build.BWD_MT, (mtile + 1) * build.BWD_MT)
            cols = slice(slab * build.BWD_R, (slab + 1) * build.BWD_R)
            da_owner[rows, cols] += 1
            ranges, total = _chunk_ranges(n, build.BWD_NC), n
        else:
            t = block - da_blocks
            rows = slice((t // ntiles) * build.BWD_TK, (t // ntiles + 1) * build.BWD_TK)
            cols = slice((t % ntiles) * build.BWD_TN, (t % ntiles + 1) * build.BWD_TN)
            db_owner[rows, cols] += 1
            ranges, total = _chunk_ranges(m, build.BWD_MC), m
        _assert_covers(total, ranges)
    assert (da_owner == int(need_a)).all()
    assert (db_owner == int(need_b)).all()


def test_matmul_bwd_plan_at_the_training_fc():
    """The FC at batch 32: 128 da blocks (16 rows of b each) and 256 db
    tiles, one launch of 384 blocks; frozen features (db alone) 256."""
    assert build.matmul_bwd_plan(32, 2048, 1000) == (128, 256)
    assert build.matmul_bwd_plan(32, 2048, 1000, False, True) == (0, 256)
    assert build.matmul_bwd_plan(64, 2048, 1000, True, False) == (256, 0)


def _bwd_float4_reads():
    """The da slice's two float4 reads as matmul.cu writes them: the base
    expression of g's and of b's, and the row offset of each."""
    import re

    src = _bwd_source()
    body = src[src.index("void da_block("):src.index("float* red = sm;")]
    bases = dict(re.findall(r"const float\* (gs|bs) = (.+);", body))
    reads = dict(re.findall(
        r"(gv|bv)\[\w\] = \*reinterpret_cast<const float4\*>\((?:gs|bs) \+ (.+?)\);", body))
    return bases, reads


def test_matmul_bwd_float4_reads_hit_distinct_banks():
    """The da slice's float4 reads, evaluated as matmul.cu writes them: each
    quarter-warp (8 lanes; a 16-byte read is served 8 lanes at a time)
    reads g's rows mg + 8i and b's rows rg + 4j at the warp's 4 contraction
    columns, and its distinct float4s fall on distinct groups of 4 banks
    (same-address lanes are a broadcast)."""
    src = _bwd_source()
    ldn = _constant(src, "NC") + 4
    assert "constexpr int LDN = NC + 4;" in src and ldn % 4 == 0
    bases, reads = _bwd_float4_reads()
    assert set(reads) == {"gv", "bv"}
    mt = _constant(src, "MT")
    for ng in range(8):
        for idx in range(4):
            for quarter in range(4):
                for which in ("gv", "bv"):
                    starts = set()
                    for lane in range(8 * quarter, 8 * quarter + 8):
                        env = dict(sm=0, t=0, STAGES=5, DA_STAGE=0, ng=ng, mg=lane >> 2,
                                   rg=lane & 3, LDN=ldn, MT=mt, i=idx, j=idx)
                        env["gs"] = eval(bases["gs"], env)  # slot 0 of the ring
                        env["bs"] = eval(bases["bs"], env)
                        addr = env["gs" if which == "gv" else "bs"] + eval(reads[which], env)
                        assert addr % 4 == 0
                        starts.add(addr)
                    groups = {(a % 32) // 4 for a in starts}
                    assert len(groups) == len(starts), (which, ng, idx, quarter)
