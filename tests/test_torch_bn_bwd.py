"""K6's launch plan and host path (``bn.bn_bwd_plan``, ``bn.bwd_vector_width``,
``bn.bn_bwd``) on the CPU, as pure functions of the shapes.

The kernel (``csrc/bn.cu`` ``bn_bwd_kernel``) runs only on the card
(tests/test_torch_gpu.py); here its grid is walked as the kernel walks it:
every (row, channel) of the view is summed by exactly one thread and its dx
written by the same thread, which visits its rows in the reverse of its
summing order; the tiles fit one block a SM where the plan fuses both
passes into one launch; and the wrapper hands the entry point the plan, the
workspace and one (2, C) tensor whose rows become dβ and dγ.
"""

import numpy as np
import pytest
import torch

from resnet_tpu_torch.kernels import bn, build

SMS = 132  # an H100 SXM
# (M, C, storage offset in elements): phase 3's four shapes, then ragged
# channels, M below one row chunk, and views off a 16-byte boundary
SHAPES = [(32 * 112 * 112, 64, 0), (32 * 28 * 28, 512, 0), (32 * 7 * 7, 2048, 0),
          (1000, 33, 0), (200, 9, 0), (50, 64, 0), (1568, 2048, 1), (1000, 64, 4)]
DTYPES = [torch.float32, torch.bfloat16]


def _rows(m, plan, chunk, row_lane):
    """The rows one kernel thread (row lane ``row_lane`` of a block of chunk
    ``chunk``) sums, in its order, and the rows it writes dx of, in its
    order, as ``csrc/bn.cu``'s loops walk them: first + i * row_lanes for
    i < rows, then the dx pass's j-th row rows - 1 - j."""
    row_lanes = bn._BWD_THREADS // plan.ctv
    first = chunk * plan.chunk + row_lane
    r1 = min(m, (chunk + 1) * plan.chunk)
    rows = (r1 - 1 - first) // row_lanes + 1 if first < r1 else 0
    summed = [first + i * row_lanes for i in range(rows)]
    return summed, [first + (rows - 1 - j) * row_lanes for j in range(rows)]


def _view(m, c, offset, dtype):
    """An (m, c) contiguous view ``offset`` elements into its storage (torch.empty:
    no page of it is touched)."""
    return torch.empty(m * c + offset, dtype=dtype)[offset:].view(m, c)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("m,c,offset", SHAPES, ids=[f"{m}x{c}+{o}" for m, c, o in SHAPES])
def test_bn_bwd_plan_walks_every_element_once(m, c, offset, dtype):
    x, dy = _view(m, c, offset, dtype), _view(m, c, 0, dtype)
    el = x.element_size()
    vec = bn.bwd_vector_width(x, dy)
    aligned = (offset * el) % 16 == 0
    assert vec == (16 // el if aligned and c % (16 // el) == 0 else 1)
    plan = bn.bn_bwd_plan(m, c, vec, SMS)
    assert bn.bn_bwd_plan(m, c, vec, SMS) is plan
    tc = plan.vec * plan.ctv
    assert plan.ctv & (plan.ctv - 1) == 0 and plan.ctv <= (8 if vec > 1 else 32)
    if vec > 1:
        assert tc * el == 128 or tc >= c  # a tile is 128 bytes of a row
    assert (plan.tiles - 1) * tc < c <= plan.tiles * tc
    assert plan.fused == (plan.tiles <= SMS)
    if plan.fused:  # one block a SM: every block resident in one wave
        assert plan.tiles * plan.n_chunks <= SMS
    assert plan.chunk % 8 == 0 and plan.n_chunks <= 65535
    assert (plan.n_chunks - 1) * plan.chunk < m <= plan.n_chunks * plan.chunk
    assert plan.part == 2 * plan.n_chunks * c
    # channels: lane l of tile t reads vec channels from t * tc + l * vec
    channels = np.zeros(c, np.int64)
    for tile in range(plan.tiles):
        for lane in range(plan.ctv):
            c0 = tile * tc + lane * plan.vec
            if c0 < c:
                assert c0 + plan.vec <= c
                channels[c0:c0 + plan.vec] += 1
    assert (channels == 1).all()
    # rows: each thread's dx walk is its summing walk backwards, and the
    # walks of a tile's blocks cover every row once
    row_lanes = bn._BWD_THREADS // plan.ctv
    summed, written = np.zeros(m, np.int64), np.zeros(m, np.int64)
    for k in range(plan.n_chunks):
        for row_lane in range(row_lanes):
            forward, backward = _rows(m, plan, k, row_lane)
            assert backward == forward[::-1]
            summed[forward] += 1
            written[backward] += 1
    assert (summed == 1).all() and (written == 1).all()


@pytest.mark.parametrize("m,c,sms,fused,n_chunks", [
    (401408, 64, 132, True, 132),   # the stem in bf16: one tile, a chunk a SM
    (401408, 64, 114, True, 114),   # a card with fewer SMs
    (100352, 8448, 132, True, 1),   # 132 bf16 tiles: one chunk each
    (100352, 8456, 132, False, 4),  # 133 tiles: two launches, ~4 blocks a SM
    (50, 64, 132, True, 1),         # M below one chunk
])
def test_bn_bwd_plan_fuses_where_one_wave_holds_the_grid(m, c, sms, fused, n_chunks):
    plan = bn.bn_bwd_plan(m, c, 8, sms)
    assert (plan.fused, plan.n_chunks) == (fused, n_chunks)
    if not fused:
        assert plan.tiles * plan.n_chunks >= 4 * sms


@pytest.mark.parametrize("dtype,param", [(torch.float32, torch.float32),
                                         (torch.bfloat16, torch.float32),
                                         (torch.bfloat16, torch.bfloat16)],
                         ids=["fp32", "bf16", "bf16-params"])
@pytest.mark.parametrize("relu", [True, False])
def test_bn_bwd_hands_its_plan_to_the_entry_point(monkeypatch, dtype, param, relu):
    """``bn.bn_bwd`` down to the C call with the card's checks passed and
    the entry point recorded: the argument order of build.SIGNATURES, the
    shared workspace, one launch counted on the dtype's counter, and dγ and
    dβ the rows of one (2, C) tensor in γ's and β's dtype."""
    calls = []
    monkeypatch.setattr(build, "on_card", lambda *a, **k: True)
    monkeypatch.setattr(build, "entry", lambda name: name)
    monkeypatch.setattr(build, "launch_on", lambda index, stream, fn, *args:
                        calls.append((index, stream, fn, args)))
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(bn, "_sms", lambda index: SMS)
    monkeypatch.setattr(bn, "BWD_LAUNCHES", 0)
    monkeypatch.setattr(bn, "BWD_LAUNCHES_BF16", 0)
    m, c = 3000, 64
    x, dy = torch.zeros(m, c, dtype=dtype), torch.zeros(m, c, dtype=dtype)
    rows = [torch.zeros(c), torch.ones(c), torch.ones(c, dtype=param), torch.zeros(c, dtype=param)]
    plan = bn.bn_bwd_plan(m, c, 16 // x.element_size(), SMS)
    ws = [torch.empty(plan.part), torch.zeros(plan.tiles, dtype=torch.int32)]
    monkeypatch.setitem(bn._WORKSPACES, (None, 7), ws)
    dx, dgamma, dbeta = bn.bn_bwd(x, dy, *rows, relu=relu)
    (index, stream, fn, args), = calls
    name = "rt_bn_bwd_" + ("bf16" if dtype is torch.bfloat16 else "f32")
    assert (index, stream, fn) == (None, 7, name)
    assert len(args) + 1 == len(build.SIGNATURES[name])
    assert args[:2] == (x.data_ptr(), dy.data_ptr())
    assert args[6:8] == (ws[0].data_ptr(), ws[1].data_ptr())
    assert args[9] == dx.data_ptr() and dx.shape == x.shape and dx.dtype == dtype
    assert args[10:] == (m, c, plan.chunk, plan.n_chunks, 1, plan.ctv, 1, int(relu))
    assert dgamma.dtype == dbeta.dtype == param and dgamma.shape == dbeta.shape == (c,)
    if param is torch.float32:  # the rows of the sums tensor the kernel writes
        assert dbeta.data_ptr() == args[8] and dgamma.data_ptr() == args[8] + 4 * c
    counters = (bn.BWD_LAUNCHES, bn.BWD_LAUNCHES_BF16)
    assert counters == ((0, 1) if dtype is torch.bfloat16 else (1, 0))
