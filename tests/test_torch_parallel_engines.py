"""The global batch's BN statistics on every engine across ranks, and the
data x model grid with a tensor-parallel FC head (resnet_tpu_torch.parallel)
on the CPU.

Two gloo ranks of ``resnet_tpu_torch.tools.distributed_worker`` (one spawn)
run the 'auto' step on the fused, hybrid, fusedxla and whole-block engines
in fp32, 'fused' with grad_accum=2, and ghost BN with its sample inside rank
0's rows and across both ranks, on the tiny model with an identity block in
each stage (``block_sizes=(2, 2)``, so that blocks take K10's route), batch
8, SGD; each is held to the JAX package's one-device step on the global
batch (Pallas in interpret mode) and to the port's one-process step at
DP_TOL (rtol 2e-4, atol 1e-5, JAX's bound for its own 8-device step), and
both ranks must hold the same statistics bit for bit. Four gloo ranks (one
spawn) run the composite step on ``make_mesh_2d(2, 2)`` against JAX's on
its own 2 x 2 mesh with ``composite_shardings``, at that test's tolerances
(tests/test_parallel.py:166-180). In one process, without a spawn: the
statistics audit (every BN layer of every accepted configuration takes its
statistics through the group's sum), the sums Function, K10's stage route
against its one call, and the composite plan against JAX's rule.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.parallel import composite_shardings as j_composite_shardings
from resnet_tpu.parallel import make_mesh_2d as j_make_mesh_2d
from resnet_tpu.parallel import shard_batch as j_shard_batch
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.kernels import bn
from resnet_tpu_torch.kernels import block_fused as tbf
from resnet_tpu_torch.parallel import composite_shardings
from resnet_tpu_torch.parallel.mesh import Mesh, Mesh2D
from resnet_tpu_torch.train import make_train_step

from test_torch_parallel import BATCH, DP_TOL, KERNELS, SGD, _close, _spawn

MODEL = dict(block_sizes=(2, 2))
# name -> the case's execution fields (over KERNELS)
ENGINE_CASES = {
    "fused": dict(kernels="fused"),
    "hybrid": dict(kernels="hybrid"),
    "fusedxla": dict(kernels="fusedxla"),
    "blockfused": dict(kernels="blockfused"),
    "fused_accum2": dict(kernels="fused", grad_accum=2),
    # the sample inside rank 0's 4 rows, and across both ranks
    "ghost_k2": dict(bn_stats_batch=2),
    "ghost_k6": dict(bn_stats_batch=6),
}
SPAWN_TIMEOUT = 240


def _j_cfg(execution=None, optimizer=SGD):
    return jcfg.TrainConfig(model=jcfg.tiny_model_config(**MODEL),
                            execution=jcfg.ExecutionConfig(**(execution or {})),
                            optimizer=jcfg.OptimizerConfig(**optimizer),
                            data=jcfg.DataConfig(batch_size=BATCH))


def _t_cfg(execution):
    return tcfg.TrainConfig(model=tcfg.tiny_model_config(**MODEL),
                            execution=tcfg.ExecutionConfig(**execution),
                            optimizer=tcfg.OptimizerConfig(**SGD),
                            data=tcfg.DataConfig(batch_size=BATCH))


def _inputs(tmp):
    """The JAX init of the tiny model and one global batch, saved for the
    ranks."""
    rng = np.random.default_rng(25)
    jstate = j_init_train_state(_j_cfg())
    numpy_state = jax.tree.map(np.asarray, jstate)
    init = {"params": bridge.params_from_numpy(numpy_state.params, device="cpu"),
            "bn_state": bridge.params_from_numpy(numpy_state.bn_state, device="cpu")}
    batch = {"images": rng.normal(0, 50, (BATCH, 16, 16, 3)).astype(np.float32),
             "labels": rng.integers(0, 8, BATCH).astype(np.int32)}
    torch.save(init, tmp / "state.pt")
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, tmp / "batch.pt")
    model = dataclasses.asdict(tcfg.tiny_model_config(**MODEL))
    base = {"model": model, "execution": KERNELS, "optimizer": SGD,
            "data": {"batch_size": BATCH}}
    return {"config": base, "state": str(tmp / "state.pt"), "batch": str(tmp / "batch.pt")}, \
        numpy_state, batch


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """One spawn of two ranks over every engine case."""
    tmp = tmp_path_factory.mktemp("engines")
    spec, numpy_state, batch = _inputs(tmp)
    spec["cases"] = [{"name": name, "grads": True,
                      "config": {"execution": dict(KERNELS, **kw)}}
                     for name, kw in ENGINE_CASES.items()]
    ranks = _spawn(tmp, spec, "run", timeout=SPAWN_TIMEOUT)
    return {"ranks": ranks, "numpy_state": numpy_state, "batch": batch}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_across_ranks_is_the_global_batch_step(engines, name):
    """The two-rank 'auto' step of each engine (and of ghost BN) equals
    JAX's one-device step on the global batch with that engine and the
    port's one-process step: loss, grad_norm, parameters and running
    statistics at DP_TOL. Both ranks hold the same batch statistics and
    metrics bit for bit."""
    r0, r1 = (r[name] for r in engines["ranks"])
    kw = ENGINE_CASES[name]
    jstate = j_init_train_state(_j_cfg())
    js, jm = j_make_train_step(_j_cfg(dict(kw, pallas_interpret=True)), donate=False)(
        jstate, engines["batch"])
    state = bridge.train_state_from_numpy(engines["numpy_state"], device="cpu")
    ts, tm = make_train_step(_t_cfg(dict(KERNELS, **kw)))(state, engines["batch"])
    assert r0["metrics"] == r1["metrics"]
    for k in ("loss", "loss_sum", "accuracy", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(r0["metrics"][k], tm[k].item(), rtol=2e-4, err_msg=k)
    _close(r0["params"], js.params, "params vs JAX", **DP_TOL)
    _close(r0["bn_state"], js.bn_state, "running stats vs JAX", **DP_TOL)
    _close(r0["params"], bridge.to_numpy(ts.params), "params vs one process", **DP_TOL)
    _close(r0["bn_state"], bridge.to_numpy(ts.bn_state), "running stats vs one process",
           **DP_TOL)
    a, b = bridge.leaves(r0["bn_stats"]), bridge.leaves(r1["bn_stats"])
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_ghost_sample_statistics_are_the_global_samples(engines):
    """Ghost BN's stem statistics across ranks are those of the first k
    images of the global batch: with k = 2 (rank 0's rows only) and k = 6
    (all of rank 0's and 2 of rank 1's) each equals one process's on the
    whole batch, and differs from what rank 1's own rows would give."""
    from resnet_tpu_torch.models import forward

    state = bridge.train_state_from_numpy(engines["numpy_state"], device="cpu")
    x = torch.from_numpy(engines["batch"]["images"])
    for name, k in (("ghost_k2", 2), ("ghost_k6", 6)):
        ecfg = _t_cfg(dict(KERNELS, bn_stats_batch=k)).execution
        with torch.no_grad():
            _, aux = forward(state.params, x, tcfg.tiny_model_config(**MODEL), ecfg,
                             bn_state=state.bn_state)
            _, own = forward(state.params, x[BATCH // 2:], tcfg.tiny_model_config(**MODEL),
                             ecfg, bn_state=state.bn_state)
        got = engines["ranks"][1][name]["bn_stats"]["init_bn"]
        for g, w, o in zip(got, aux["bn_stats"]["init_bn"], own["bn_stats"]["init_bn"]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)
            assert not torch.allclose(g, o), name


@pytest.fixture(scope="module")
def composite(tmp_path_factory):
    """One spawn of four ranks (a 2 x 2 grid) over the composite step, with
    a dump after it."""
    tmp = tmp_path_factory.mktemp("composite")
    spec, numpy_state, batch = _inputs(tmp)
    spec["cases"] = [{"name": "composite", "mesh": [2, 2], "dump": str(tmp / "dumps")}]
    ranks = _spawn(tmp, spec, "run", world=4, timeout=SPAWN_TIMEOUT)
    return {"ranks": ranks, "numpy_state": numpy_state, "batch": batch,
            "dumps": tmp / "dumps"}


def _j_composite(batch):
    mesh = j_make_mesh_2d(2, 2)
    cfg = _j_cfg()
    state = j_init_train_state(cfg)
    shardings = j_composite_shardings(state, mesh)
    step = j_make_train_step(cfg, mesh, donate=False, state_shardings=shardings)
    return step(jax.device_put(state, shardings), j_shard_batch(batch, mesh))


def test_composite_step_matches_jax(composite):
    """The composite step on make_mesh_2d(2, 2) (each data index's two model
    ranks on the same 4 rows, K3 on the FC's class slice, the logit slices
    gathered) against JAX's composite step on its 2 x 2 mesh, at
    test_parallel.py:166-180's tolerances; every rank reports the same
    metrics."""
    ranks = composite["ranks"]
    js, jm = _j_composite(composite["batch"])
    m = ranks[0]["composite"]["metrics"]
    assert all(r["composite"]["metrics"] == m for r in ranks)
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(jm["grad_norm"]), rtol=1e-4)
    _close(ranks[0]["composite"]["params"], js.params, "params", rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def composite13(tmp_path_factory):
    """One spawn of three ranks: the 1 x 3 grid, whose model size does not
    divide the tiny model's 8 classes."""
    tmp = tmp_path_factory.mktemp("composite13")
    spec, numpy_state, batch = _inputs(tmp)
    spec["cases"] = [{"name": "composite", "mesh": [1, 3]}]
    ranks = _spawn(tmp, spec, "run", world=3, timeout=SPAWN_TIMEOUT)
    return {"ranks": ranks, "numpy_state": numpy_state, "batch": batch}


def test_composite_1x3_replicates_the_head_and_matches_jax(composite13):
    """C2: on the 1 x 3 grid composite_shardings replicates the FC (3 does
    not divide 8 classes), so the step is plain data parallelism with a
    replicated head: no split head, nothing summed over the model group,
    no empty norm. Against JAX's composite step on its own make_mesh_2d(1,
    3) (three of the forced CPU devices) and the port's one-process step,
    at DP_TOL; every rank reports the same metrics."""
    ranks = composite13["ranks"]
    mesh = j_make_mesh_2d(1, 3)
    cfg = _j_cfg()
    state = j_init_train_state(cfg)
    shardings = j_composite_shardings(state, mesh)
    step = j_make_train_step(cfg, mesh, donate=False, state_shardings=shardings)
    js, jm = step(jax.device_put(state, shardings), j_shard_batch(composite13["batch"], mesh))
    tstate = bridge.train_state_from_numpy(composite13["numpy_state"], device="cpu")
    ts, tm = make_train_step(_t_cfg(KERNELS))(tstate, composite13["batch"])
    m = ranks[0]["composite"]["metrics"]
    assert all(r["composite"]["metrics"] == m for r in ranks)
    c = 4 * tcfg.tiny_model_config(**MODEL).init_filters * 2
    assert all(r["composite"]["fc_shape"] == [c, 8] for r in ranks)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(m[k], tm[k].item(), rtol=2e-4, err_msg=k)
    _close(ranks[0]["composite"]["params"], js.params, "params vs JAX", **DP_TOL)
    _close(ranks[0]["composite"]["params"], bridge.to_numpy(ts.params),
           "params vs one process", **DP_TOL)
    assert ranks[0]["composite"]["plan"]["fc"] == {"w": None}


def test_composite_splits_the_fc_as_jax_does(composite):
    """Each rank holds its (C, classes / 2) slice of the FC weight, the
    plan splits the leaves JAX's composite_shardings splits (the FC weight
    on its class dimension, bn_reduce.gamma replicated), and a dump written
    from the grid holds whole FC tensors equal to rank 0's gathered ones."""
    ranks = composite["ranks"]
    c = 4 * tcfg.tiny_model_config(**MODEL).init_filters * 2
    assert all(r["composite"]["fc_shape"] == [c, 4] for r in ranks)
    plan = ranks[0]["composite"]["plan"]
    assert plan["fc"]["w"] == 1
    assert plan["blocks"][0]["bn_reduce"]["gamma"] is None
    dump = composite["dumps"] / "00000001"
    reg = {name: (int(i), shape) for i, name, shape in
           (line.split() for line in (dump / "registry.txt").read_text().splitlines())}
    i, shape = reg["fc/w"]
    assert shape == f"{c}x8"
    w = np.fromfile(dump / "model_params" / f"{i:03d}.buffer", np.float32).reshape(c, 8)
    np.testing.assert_array_equal(w, ranks[0]["composite"]["params"]["fc"]["w"].numpy())


def test_composite_plan_is_jax_rule_leaf_by_leaf():
    """composite_shardings over the whole state names, leaf by leaf, the
    dimension JAX's spec splits over 'model' (-1 where it replicates)."""
    from resnet_tpu_torch.parallel.mesh import _tree_map
    from resnet_tpu_torch.utils.debug import _paths

    jstate = j_init_train_state(_j_cfg(optimizer=dict(name="adam")))
    jplan = j_composite_shardings(jstate, j_make_mesh_2d(2, 2))
    want = dict(_paths(jax.tree.map(
        lambda s: next((i for i, a in enumerate(s.spec) if a == "model"), -1), jplan)))
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    grid = Mesh2D(data=Mesh(2, 0), model=Mesh(2, 0, "model"), rank=0)
    plan = composite_shardings(tstate, grid)
    got = dict(_paths(_tree_map(lambda leaf, d: -1 if d is None else d, tstate, plan)))
    assert got == want
    assert sorted(p for p, d in got.items() if d >= 0) == [
        ".opt_state/.means/fc/w", ".opt_state/.vars/fc/w", ".params/fc/w"]


def test_make_mesh_2d_lays_out_the_grid(tmp_path):
    """In a world of one, make_mesh_2d(1, 1) is a grid of one (both groups
    the identity) with JAX's axis names; a grid larger than the world
    raises JAX's message; a second axis named neither "model" nor
    "spatial" needs its kind named."""
    import torch.distributed as dist

    from resnet_tpu_torch.parallel import make_mesh_2d

    with pytest.raises(RuntimeError, match="no torch.distributed"):
        make_mesh_2d(1, 1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        grid = make_mesh_2d(1, 1)
        assert grid.axis_names == ("data", "model") and grid.shape == {"data": 1, "model": 1}
        assert (grid.data.size, grid.data.rank, grid.model.size, grid.model.rank) == (1, 0, 1, 0)
        t = torch.ones(3)
        grid.model.sum_(t)
        assert torch.equal(t, torch.ones(3))
        with pytest.raises(ValueError, match=r"mesh wants 2x2=4 devices, only 1 available"):
            make_mesh_2d(2, 2)
        spatial_grid = make_mesh_2d(1, 1, axes=("data", "spatial"))
        assert spatial_grid.shape == {"data": 1, "spatial": 1}
        assert spatial_grid.is_spatial and not grid.is_spatial
        # the grid's kind is named, never guessed from a free axis name
        assert make_mesh_2d(1, 1, axes=("d", "h"), kind="spatial").spatial is not None
        with pytest.raises(ValueError, match="'tp' names no grid kind"):
            make_mesh_2d(1, 1, axes=("data", "tp"))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match=r"mesh wants 4x4=16 devices, only 8 available"):
        j_make_mesh_2d(4, 4)


def _two_ranks_alike(t):
    """An in-place 'sum' over two ranks that hold the same values."""
    t.mul_(2)


def test_sum_stats_sums_the_sums_and_their_cotangents():
    """sum_stats inside sync_stats: the sums and the row count of every
    rank (here two alike), and the sums' cotangent summed too; outside, its
    arguments themselves."""
    sums = torch.tensor([[1.0, 2.0], [3.0, 4.0]], requires_grad=True)
    assert bn.sum_stats(sums, 5) == (sums, 5)
    with bn.sync_stats(_two_ranks_alike, 0, 2):
        total, m = bn.sum_stats(sums, 5)
    assert torch.equal(total, 2 * sums.detach()) and m.item() == 10.0
    total.backward(torch.tensor([[1.0, 0.0], [0.0, 1.0]]))
    assert torch.equal(sums.grad, torch.tensor([[2.0, 0.0], [0.0, 2.0]]))
    assert bn.sample_rows(4) == (4, 0)
    with bn.sync_stats(_two_ranks_alike, 1, 2):
        assert bn.sample_rows(4) == (8, 4)


def _identity(t):
    pass


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_k10_stage_route_under_an_identity_sum_is_the_one_call(dtype):
    """K10's plain version stage by stage under a sum that changes nothing
    gives the one call's outputs bit for bit, and its backward the one
    call's gradients within 1e-6 of their max: the route the ranks take
    is the block's function."""
    rng = np.random.default_rng(10)
    c4, c = 32, 8
    args = [rng.normal(0, 1, (2, 5, 5, c4)), rng.normal(0, 0.3, (c4, c)),
            rng.normal(0, 0.3, (3, 3, c, c)), rng.normal(0, 0.3, (c, c4)),
            rng.normal(1, 0.1, c), rng.normal(0, 0.1, c), rng.normal(1, 0.1, c),
            rng.normal(0, 0.1, c), rng.normal(1, 0.1, c4), rng.normal(0, 0.1, c4)]
    xs = [torch.tensor(a, dtype=torch.float32) for a in args]
    xs[0] = xs[0].to(dtype)
    one = tbf.block_fused_forward(*xs, 1e-5, 2.0)
    staged = tbf.block_fused_forward(*xs, 1e-5, 2.0, _identity)
    assert staged[-1].item() == 2 * 5 * 5
    for a, b in zip(bridge.leaves(list(one)), bridge.leaves(list(staged[:-1])), strict=True):
        assert torch.equal(a, b)

    def grads(sync):
        leaves_ = [t.detach().clone().requires_grad_(True) for t in xs]
        with bn.sync_stats(sync):
            out, *_ = tbf.block_fused(*leaves_, 1e-5, 2.0)
        out.float().square().sum().backward()
        return [t.grad for t in leaves_]

    for a, b in zip(grads(None), grads(_identity), strict=True):
        np.testing.assert_allclose(b.float(), a.float(), rtol=0,
                                   atol=1e-6 * float(a.float().abs().max()))


class _Audit:
    """A counting identity sum: records every buffer it is given."""

    def __init__(self):
        self.buffers = []

    def __call__(self, t):
        self.buffers.append(t.detach().clone())


class _SpatialPeer:
    """A spatial group of two seen from rank 0, in one process: the
    neighbour's edge rows are this rank's own, its sums the identity."""

    rank, size = 0, 2

    def all_gather(self, t):
        return [t, t.clone()]

    def sum_(self, t):
        pass


def _audit_configs():
    out = []
    # "/spatial": on a data x spatial grid, the rows of rank 0's tile
    for engine in ("xla", "pallas", "fused", "hybrid", "fusedxla", "blockfused",
                   "xla/spatial", "pallas/spatial", "fused/spatial", "hybrid/spatial",
                   "fusedxla/spatial"):
        for remat in ("none", "block", "stage", "elementwise"):
            for ghost in (0, 2):
                for dtype in ("float32", "bfloat16"):
                    out.append((engine, remat, ghost, dtype))
    return out


@pytest.mark.parametrize("engine,remat,ghost,dtype", _audit_configs(),
                         ids=lambda v: str(v))
def test_every_bn_layer_takes_the_group_statistics(engine, remat, ghost, dtype):
    """The audit: every configuration that check_parallel accepts (engines
    x remat x ghost BN x dtype on the tiny model with identity blocks), its
    training forward run as rank 0 of two under a counting identity sum.
    Each BN layer's statistics that the forward returns are those of a
    buffer that went through the sum (its (Σ, Σ², rows)), one buffer a
    layer, so no path takes rank-local statistics in silence. (A remat
    rerun in the backward is the same forward.) On a data x spatial grid
    ('xla' and 'pallas' with K1, the rows of rank 0's tile of each image)
    the sum runs over data x spatial and ghost BN's sample goes by the data
    index: the same, one buffer a layer; the fused engines there (each
    site on rank 0's haloed tile) the same."""
    from resnet_tpu_torch.models import forward
    from resnet_tpu_torch.parallel import spatial
    from resnet_tpu_torch.train import init_train_state

    engine, _, grid = engine.partition("/")
    cfg = _t_cfg(dict(kernels=engine, conv_kernels="pallas" if engine == "pallas" else "xla",
                      remat=remat, bn_stats_batch=ghost, compute_dtype=dtype))
    gen = torch.Generator().manual_seed(3)
    state = init_train_state(cfg, gen, device="cpu")
    x = torch.randn((4, 8 if grid else 16, 16, 3), generator=gen) * 50
    audit = _Audit()
    with bn.sync_stats(audit, 0, 2), torch.no_grad(), spatial.partition(
            _SpatialPeer() if grid else None):
        _, aux = forward(state.params, x, cfg.model, cfg.execution, bn_state=state.bn_state)
    stats = bridge.flatten(aux["bn_stats"])
    assert len(audit.buffers) == len(stats) // 2
    from_buffers = []
    for buf in audit.buffers:
        c = (buf.numel() - 1) // 2
        total = buf.to(torch.float32)
        from_buffers.append(bn.mean_var_from_sums(total[:c], total[c:2 * c], total[2 * c]))
    for i in range(0, len(stats), 2):
        (_, mean), (_, var) = stats[i], stats[i + 1]
        assert any(torch.equal(mean, m) and torch.equal(var, v) for m, v in from_buffers), \
            stats[i][0]
