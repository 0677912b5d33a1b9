"""The port's data parallelism (resnet_tpu_torch.parallel) on the CPU.

Two gloo ranks, each a subprocess of ``resnet_tpu_torch.tools.distributed_worker``
joined through a FileStore under tmp_path, against the JAX package on two of
its eight virtual CPU devices (tests/conftest.py) and against the port's own
one-process step on the global batch. Tiny model, batch 8 (4 rows a rank),
SGD where parameters are compared, as the JAX package's own DP tests do
(tests/test_train.py:78-99): its update is linear in the gradient, so
reduction-order noise stays noise. The checks are grouped into few spawns:
one runs every step case, three the Trainer (uninterrupted, killed, resumed),
one the CLI under torchrun.

Tolerances: the 'auto' and 'shard_map' steps against JAX's at rtol 2e-4,
atol 1e-5 (JAX's bound for its own 8-device step, test_train.py:98-99);
ZeRO against JAX's ZeRO step at test_parallel.py:370-430's (loss rtol 1e-5,
grad_norm 1e-4, parameters rtol 1e-4 atol 2e-6) and against the port's
replicated step bit for bit (both reduce with the same all-reduce); the
statistics Function against one process on the concatenated batch at rtol
1e-5, atol 1e-6.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.parallel import make_mesh as j_make_mesh
from resnet_tpu.parallel import make_shard_map_train_step as j_shard_map_step
from resnet_tpu.parallel import shard_batch as j_shard_batch
from resnet_tpu.parallel import zero_shardings as j_zero_shardings
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu.train.step import make_train_step as j_make_train_step
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import write_shard
from resnet_tpu_torch.parallel import distributed, zero_shardings
from resnet_tpu_torch.parallel.mesh import Mesh, rows_of
from resnet_tpu_torch.train import make_train_step
from resnet_tpu_torch.train.trainer import rank_cursor

REPO = Path(__file__).resolve().parents[1]
WORKER = "resnet_tpu_torch.tools.distributed_worker"
BATCH = 8
SGD = dict(name="sgd", learning_rate=1e-3)
KERNELS = dict(kernels="pallas", conv_kernels="pallas")
DP_TOL = dict(rtol=2e-4, atol=1e-5)


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)  # the port's ranks import no JAX
    return env


def _spawn(tmp_path, spec, name, world=2, kill=False, timeout=300):
    """Run ``world`` ranks of the worker on ``spec``; their results by rank.
    With ``kill`` every rank is expected to end by SIGKILL."""
    d = tmp_path / name
    d.mkdir()
    (d / "spec.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen(
        [sys.executable, "-m", WORKER, str(r), str(world), str(d / "store"),
         str(d / "spec.json"), str(d / "out"), "--device", "cpu"], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        want = -9 if kill else 0
        assert p.returncode == want, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    if kill:
        return None
    return [torch.load(d / "out" / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _j_cfg(**kw):
    return jcfg.TrainConfig(model=jcfg.tiny_model_config(),
                            execution=jcfg.ExecutionConfig(**kw.pop("execution", {})),
                            optimizer=jcfg.OptimizerConfig(**kw.pop("optimizer", SGD)),
                            data=jcfg.DataConfig(batch_size=BATCH), **kw)


def _t_cfg(**kw):
    return tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                            execution=tcfg.ExecutionConfig(**kw.pop("execution", KERNELS)),
                            optimizer=tcfg.OptimizerConfig(**kw.pop("optimizer", SGD)),
                            data=tcfg.DataConfig(batch_size=BATCH), **kw)


def _close(got, want, what, **tol):
    a = bridge.flatten(bridge.to_numpy(got) if not isinstance(bridge.leaves(got)[0], np.ndarray)
                       else got)
    b = bridge.flatten(jax.tree.map(np.asarray, want))
    assert [p for p, _ in a] == [p for p, _ in b], what
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x, y, err_msg=f"{what} {path}", **tol)


def _equal(got, want, what):
    for (path, x), (_, y) in zip(bridge.flatten(got), bridge.flatten(want), strict=True):
        assert torch.equal(x, y), f"{what} {path}"


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One spawn of two ranks over every step case, from the JAX init."""
    tmp = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(1234)
    jstate = j_init_train_state(_j_cfg())
    numpy_state = jax.tree.map(np.asarray, jstate)
    init = {"params": bridge.params_from_numpy(numpy_state.params, device="cpu"),
            "bn_state": bridge.params_from_numpy(numpy_state.bn_state, device="cpu")}
    batch = {"images": rng.normal(0, 50, (BATCH, 16, 16, 3)).astype(np.float32),
             "labels": rng.integers(0, 8, BATCH).astype(np.int32)}
    x = (rng.normal(0, 2, (6, 5, 5, 12)) + rng.normal(0, 1, 12)).astype(np.float32)
    torch.save(init, tmp / "state.pt")
    torch.save({k: torch.from_numpy(v) for k, v in batch.items()}, tmp / "batch.pt")
    torch.save(torch.from_numpy(x), tmp / "x.pt")
    base = {"model": "tiny", "execution": KERNELS, "optimizer": SGD,
            "data": {"batch_size": BATCH}}
    adam = dict(name="adam", fused=True)
    cases = [
        {"name": "auto", "grads": True},
        {"name": "auto_accum2", "config": {"execution": dict(KERNELS, grad_accum=2)}},
        {"name": "shard_map", "config": {"parallel": {"mode": "shard_map"}}},
        {"name": "zero", "zero": True, "config": {"parallel": {"zero_min_bytes": 1024}}},
        {"name": "dp_adam", "config": {"optimizer": adam}},
        {"name": "zero_adam", "zero": True,
         "config": {"optimizer": adam, "parallel": {"zero_min_bytes": 1024}}},
        {"name": "moments", "kind": "moments"},
    ]
    spec = {"config": base, "state": str(tmp / "state.pt"),
            "batch": str(tmp / "batch.pt"), "moments_x": str(tmp / "x.pt"), "cases": cases}
    ranks = _spawn(tmp, spec, "run")
    return {"ranks": ranks, "jstate": jstate, "numpy_state": numpy_state, "batch": batch,
            "x": x}


def _one_process(steps, cfg):
    state = bridge.train_state_from_numpy(steps["numpy_state"], device="cpu")
    return make_train_step(cfg)(state, steps["batch"])


def _jax_step(steps, mesh, step_maker, **kw):
    cfg = _j_cfg(**kw)
    state = j_init_train_state(cfg)
    batch = j_shard_batch(steps["batch"], mesh) if mesh is not None else steps["batch"]
    return step_maker(cfg)(state, batch)


def test_auto_step_is_the_global_batch_step(steps):
    """The two-rank 'auto' step equals JAX's pjit step on make_mesh(2) and
    the port's one-process step on the global batch: the loss summed (not
    averaged) over all 8 rows, the summed gradient's update, the running
    statistics of the global batch's statistics."""
    r0, r1 = (r["auto"] for r in steps["ranks"])
    mesh = j_make_mesh(2)
    js, jm = _jax_step(steps, mesh, lambda c: j_make_train_step(c, mesh, donate=False))
    ts, tm = _one_process(steps, _t_cfg())
    assert r0["metrics"] == r1["metrics"]
    for k in ("loss", "loss_sum", "accuracy", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(r0["metrics"][k], tm[k].item(), rtol=2e-4, err_msg=k)
    # a sum over the global batch, not a mean of the ranks' sums
    np.testing.assert_allclose(r0["metrics"]["loss_sum"], BATCH * r0["metrics"]["loss"],
                               rtol=1e-6)
    _close(r0["params"], js.params, "params vs JAX", **DP_TOL)
    _close(r0["bn_state"], js.bn_state, "running stats vs JAX", **DP_TOL)
    _close(r0["params"], bridge.to_numpy(ts.params), "params vs one process", **DP_TOL)
    # the update is -lr times the summed gradient (SGD from zero momentum)
    p0 = steps["numpy_state"].params
    for (path, g), p, q in zip(bridge.flatten(r0["grads"]), bridge.leaves(p0),
                               bridge.leaves(bridge.to_numpy(r0["params"])), strict=True):
        np.testing.assert_allclose(q, p - np.float32(1e-3) * g.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=path)
    # every BN layer's statistics are the global batch's, on both ranks
    assert all(torch.equal(a, b) for a, b in zip(bridge.leaves(r0["bn_stats"]),
                                                 bridge.leaves(r1["bn_stats"])))


def test_auto_step_with_grad_accum_2(steps):
    """grad_accum=2 across two ranks: each microbatch's statistics are the
    global microbatch's, one reduce after the microbatches; as JAX's
    accumulated pjit step and the port's one-process grad_accum=2 step."""
    r0 = steps["ranks"][0]["auto_accum2"]
    mesh = j_make_mesh(2)
    js, jm = _jax_step(steps, mesh, lambda c: j_make_train_step(c, mesh, donate=False),
                       execution=dict(grad_accum=2))
    ts, tm = _one_process(steps, _t_cfg(execution=dict(KERNELS, grad_accum=2)))
    for k in ("loss_sum", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]), rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(r0["metrics"][k], tm[k].item(), rtol=2e-4, err_msg=k)
    _close(r0["params"], js.params, "params vs JAX", **DP_TOL)
    _close(r0["bn_state"], js.bn_state, "running stats vs JAX", **DP_TOL)
    _close(r0["params"], bridge.to_numpy(ts.params), "params vs one process", **DP_TOL)


def test_shard_map_step_matches_jax(steps):
    """Local BN per rank, gradients summed, running statistics averaged:
    JAX's make_shard_map_train_step on two devices, running statistics
    included, and equal on both ranks."""
    r0, r1 = (r["shard_map"] for r in steps["ranks"])
    mesh = j_make_mesh(2)
    js, jm = _jax_step(steps, None, lambda c: (
        lambda s, b: j_shard_map_step(c, mesh, donate=False)(s, j_shard_batch(b, mesh))),
        parallel=jcfg.ParallelConfig(mode="shard_map"))
    for k in ("loss", "loss_sum", "accuracy", "grad_norm"):
        np.testing.assert_allclose(r0["metrics"][k], float(jm[k]), rtol=2e-4, err_msg=k)
    _close(r0["params"], js.params, "params", **DP_TOL)
    _close(r0["bn_state"], js.bn_state, "running stats", **DP_TOL)
    assert r0["metrics"] == r1["metrics"]
    # local BN: not the global-batch step
    assert r0["metrics"]["loss_sum"] != steps["ranks"][0]["auto"]["metrics"]["loss_sum"]


def test_zero_plan_is_jax_rule_leaf_by_leaf():
    """zero_shardings at min_bytes=1024 over the whole state names, leaf by
    leaf, the dimension JAX's spec shards (-1 below where it replicates)."""
    from resnet_tpu_torch.parallel.mesh import _tree_map
    from resnet_tpu_torch.utils.debug import _paths

    jstate = j_init_train_state(_j_cfg())
    jplan = j_zero_shardings(jstate, j_make_mesh(2), min_bytes=1024)
    want = dict(_paths(jax.tree.map(
        lambda s: next((i for i, a in enumerate(s.spec) if a == "data"), -1), jplan)))
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    plan = zero_shardings(tstate, Mesh(size=2, rank=0), min_bytes=1024)
    got = dict(_paths(_tree_map(lambda leaf, d: -1 if d is None else d, tstate, plan)))
    assert got == want
    assert sum(d >= 0 for d in got.values()) > 4  # the FC and conv weights shard
    assert got[".params/fc/w"] == 0  # (64, 8): the larger dimension


def test_zero_step_matches_jax_and_replicated_dp(steps):
    """The ZeRO step (SGD, min_bytes 1024) against JAX's ZeRO step at its
    own test's tolerances, and bit for bit against the port's replicated
    two-rank step; with fused Adam on its shards, bit for bit against
    fused Adam on the whole replicated state. Each rank keeps less state."""
    r = steps["ranks"][0]
    mesh = j_make_mesh(2)
    cfg = _j_cfg()
    jstate = j_init_train_state(cfg)
    shardings = j_zero_shardings(jstate, mesh, min_bytes=1024)
    placed = jax.device_put(jstate, shardings)
    js, jm = j_make_train_step(cfg, mesh, donate=False, state_shardings=shardings)(
        placed, j_shard_batch(steps["batch"], mesh))
    np.testing.assert_allclose(r["zero"]["metrics"]["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(r["zero"]["metrics"]["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)
    _close(r["zero"]["params"], js.params, "params", rtol=1e-4, atol=2e-6)
    _equal(r["zero"]["params"], r["auto"]["params"], "ZeRO vs replicated params")
    _equal(r["zero_adam"]["params"], r["dp_adam"]["params"], "ZeRO vs replicated Adam")
    _equal(r["zero_adam"]["means"], r["dp_adam"]["means"], "ZeRO vs replicated m")
    assert r["zero"]["metrics"] == r["auto"]["metrics"]
    for rank in steps["ranks"]:
        z = rank["zero_adam"]
        assert z["state_bytes"] < 0.8 * z["replicated_state_bytes"]


def test_sync_moments_forward_and_backward_match_one_process(steps):
    """The statistics Function inside sync_stats, on each rank's rows of one
    batch: mean and var of the concatenated batch, and dx equal to one
    process's on it, the (M, C) kernel path and the NCHW plain path alike.
    Each rank's loss weighs the global statistics by the same fixed weights,
    so the global loss is twice that weighting."""
    from resnet_tpu_torch.kernels import bn

    x = torch.from_numpy(steps["x"])
    c = x.shape[-1]
    cm, cv = torch.linspace(-1.0, 1.0, c), torch.linspace(0.5, 1.5, c)
    xg = x.clone().requires_grad_(True)
    mean, var = bn.moments(xg.reshape(-1, c))
    (2 * ((mean * cm).sum() + (var * cv).sum())).backward()
    for name in ("moments", "moments_plain_nchw"):
        r0, r1 = (r["moments"][name] for r in steps["ranks"])
        for got in (r0, r1):
            np.testing.assert_allclose(got["mean"], mean.detach(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got["var"], var.detach(), rtol=1e-5, atol=1e-6)
        dx = torch.cat([r0["dx"], r1["dx"]])
        np.testing.assert_allclose(dx, xg.grad, rtol=1e-5, atol=1e-6, err_msg=name)
    # without the sum over ranks a rank's statistics are its own rows'
    own, _ = bn.moments(x[:3].reshape(-1, c))
    assert not torch.allclose(own, mean.detach())


@pytest.mark.parametrize("hosts,index", [(1, 0), (4, 3)])
def test_host_batch_slice_matches_jax(monkeypatch, hosts, index):
    """(host batch, host index) as JAX's host_batch_slice gives it for the
    same host count (test_parallel.py:56-70), hosts being torchrun's nodes;
    a global batch the hosts do not divide raises as JAX's."""
    from resnet_tpu.parallel import host_batch_slice as j_host_batch_slice

    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(distributed, "world_size", lambda: 2 * hosts)
    monkeypatch.setattr(distributed, "rank", lambda: 2 * index + 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert distributed.host_batch_slice(256) == j_host_batch_slice(256)
    if hosts > 1:
        for fn in (distributed.host_batch_slice, j_host_batch_slice):
            with pytest.raises(ValueError, match="divisible"):
                fn(255)


def test_rows_of_interleaves_microbatches():
    """With grad_accum a, a rank's microbatch i is its share of the global
    microbatch i; without, its contiguous rows; uneven splits raise."""
    b = {"labels": np.arange(8), "cursor": "c"}
    assert rows_of(b, 1, 2)["labels"].tolist() == [4, 5, 6, 7]
    assert rows_of(b, 1, 2, grad_accum=2)["labels"].tolist() == [2, 3, 6, 7]
    assert rows_of(b, 0, 2)["cursor"] == "c"
    with pytest.raises(ValueError, match="split"):
        rows_of({"labels": np.arange(10)}, 0, 4)


def test_rank_cursor_offsets_every_position():
    """Rank r's stream runs num_shards / ranks shards ahead of rank 0's at
    every position, fresh or resumed (the JAX trainer offsets only the
    cursor (0, 0))."""
    from resnet_tpu_torch.data.shards import ShardCursor

    assert rank_cursor(ShardCursor(), 1, 2, 4, 2) == ShardCursor(2, 0, 0)
    assert rank_cursor(ShardCursor(1, 1, 0), 1, 2, 4, 2) == ShardCursor(3, 1, 0)
    assert rank_cursor(ShardCursor(3, 0, 0), 1, 2, 4, 2) == ShardCursor(1, 0, 1)
    # the Python iterator's end-of-shard form and the native one's agree
    assert rank_cursor(ShardCursor(2, 2, 0), 0, 2, 4, 2) == ShardCursor(3, 0, 0)


def _shards(tmp_path, n=4, per=8):
    """n shards of per constant images whose value is their id, NCHW."""
    d = tmp_path / "shards"
    for s in range(n):
        ids = np.arange(s * per, (s + 1) * per, dtype=np.float32)
        write_shard(str(d), s, np.broadcast_to(ids[:, None, None, None], (per, 3, 16, 16)),
                    np.full((per,), s, np.int32) % 8)
    return str(d)


def _ids(rows):
    return [sorted(r[:, 0].tolist()) for r in rows]


def test_trainer_two_ranks_dump_kill_and_resume(tmp_path):
    """Two ranks train from shards with a dump every 2 steps: U runs 4
    steps; K is killed by SIGKILL after 3 (dumps 0 and 2 on disk); R resumes
    K from its latest dump to step 4. R's final dump equals U's file for
    file, each rank reads rows of its own stream (rank 1 starts num_shards /
    2 shards in), and the resumed ranks read what U's ranks read at those
    steps: two resumed ranks read different rows."""
    shards = _shards(tmp_path)

    def spec(dumps, steps, **kw):
        config = {"model": "tiny", "execution": KERNELS, "optimizer": SGD,
                  "data": {"shard_dir": shards, "batch_size": 4, "shard_images": 8,
                           "num_shards": 4, "layout": "NCHW"},
                  "checkpoint_dir": str(tmp_path / dumps), "checkpoint_every": 2,
                  "log_every": 0, **kw}
        return {"trainer": {"config": config, "steps": steps}}

    u = _spawn(tmp_path, spec("dumps_u", 4), "run_u")
    killed = spec("dumps_k", 3)
    killed["trainer"]["kill"] = True
    _spawn(tmp_path, killed, "run_k", kill=True)
    assert sorted(d for d in os.listdir(tmp_path / "dumps_k") if d.isdigit()) == [
        "00000000", "00000002"]
    r = _spawn(tmp_path, spec("dumps_k", 2, resume_from=tcfg.RESUME_LATEST), "run_r")
    for rank in (0, 1):
        ids = _ids(u[rank]["trainer"]["rows"])
        assert ids[2:] == _ids(r[rank]["trainer"]["rows"]), rank
        assert u[rank]["trainer"]["step"] == r[rank]["trainer"]["step"] == 4
    u0, u1 = (_ids(x["trainer"]["rows"]) for x in u)
    r0, r1 = (_ids(x["trainer"]["rows"]) for x in r)
    assert u0[0] == [0.0, 1.0] and u1[0] == [16.0, 17.0]  # shard 0 and shard 2
    assert all(not set(a) & set(b) for a, b in zip(r0, r1))
    final = tmp_path / "dumps_u" / "77777777"
    for sub in sorted(os.listdir(final)):
        if sub == "trainer_metadata.txt":
            continue
        a, b = final / sub, tmp_path / "dumps_k" / "77777777" / sub
        files = sorted(os.listdir(a)) if a.is_dir() else [""]
        for f in files:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f"{sub}/{f}"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_two_ranks_under_torchrun(tmp_path):
    """The CLI's ranks under torchrun: --num-devices 2 with --zero-sharding,
    a dump in the reference schema from rank 0 with whole tensors, metrics
    logged once."""
    dumps = tmp_path / "dumps"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--rdzv-backend", "c10d",
           "--rdzv-endpoint", f"localhost:{_free_port()}",
           "-m", "resnet_tpu_torch.train.cli", "--model", "tiny", "--synthetic",
           "--batch-size", "8", "--steps", "2", "--device", "cpu",
           "--num-devices", "2", "--zero-sharding", "--checkpoint-dir", str(dumps)]
    done = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    # whole tensors, as the registry names their shapes
    for line in (dumps / "77777777" / "registry.txt").read_text().splitlines():
        i, _, shape = line.split()
        n = int(np.prod([int(v) for v in shape.split("x")])) if shape else 1
        assert os.path.getsize(dumps / "77777777" / "model_params" / f"{i}.buffer") == 4 * n
    lines = (dumps / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2


@pytest.mark.parametrize("execution", [dict(kernels="hybrid"), dict(kernels="fusedxla"),
                                       dict(kernels="pallas", space_to_depth=True)])
def test_spatial_layouts_of_every_engine_are_accepted(execution):
    """On the data x spatial grid the config takes every engine JAX's
    Trainer takes there, and the s2d stem; only 'blockfused' is refused
    (tests/test_torch_spatial.py), with JAX's message."""
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                           execution=tcfg.ExecutionConfig(**execution),
                           parallel=tcfg.ParallelConfig(spatial_devices=2))
    assert cfg.parallel.spatial_devices == 2 and cfg.execution == tcfg.ExecutionConfig(
        **execution)


@pytest.mark.parametrize("kw", [
    dict(execution=tcfg.ExecutionConfig(kernels="fused"),
         parallel=tcfg.ParallelConfig(num_devices=2, mode="shard_map")),
    dict(parallel=tcfg.ParallelConfig(num_devices=2, zero_sharding=True)),
    dict(execution=tcfg.ExecutionConfig(kernels="fused", bn_mode="frozen"),
         parallel=tcfg.ParallelConfig(num_devices=2)),
    dict(execution=tcfg.ExecutionConfig(kernels="fused"),
         parallel=tcfg.ParallelConfig(num_devices=2)),
    dict(execution=tcfg.ExecutionConfig(kernels="blockfused"),
         parallel=tcfg.ParallelConfig(num_devices=2)),
    dict(execution=tcfg.ExecutionConfig(bn_stats_batch=2),
         parallel=tcfg.ParallelConfig(num_devices=2)),
])
def test_data_parallel_layouts_are_accepted(kw):
    """What runs: the fused engines under 'shard_map' (local BN), ZeRO, the
    fused engines with BN frozen, and under 'auto' across ranks the fused
    and whole-block engines and ghost BN (their statistics summed over the
    ranks: tests/test_torch_parallel_engines.py)."""
    tcfg.TrainConfig(model=tcfg.tiny_model_config(), **kw)


@pytest.mark.parametrize("kw,match", [
    (dict(parallel=tcfg.ParallelConfig(zero_sharding=True)), "need a device mesh"),
    (dict(parallel=tcfg.ParallelConfig(num_devices=2)), "no torch.distributed"),
])
def test_trainer_without_a_group_refuses(kw, match):
    """No silent one-device run: ZeRO without a group raises JAX's message,
    and num_devices=2 without a process group raises."""
    from resnet_tpu_torch.train import Trainer

    cfg = dataclasses.replace(_t_cfg(), **kw)
    with pytest.raises((ValueError, RuntimeError), match=match):
        Trainer(cfg, device="cpu")


FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
time.sleep(0.3)
if "-shared" in args:
    with open({links!r}, "a") as f:
        f.write(out + "\\n")
open(out, "w").write("built")
"""

BUILD = """import sys
from pathlib import Path
from resnet_tpu_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
build.find_nvcc = lambda: sys.argv[2]
print(build.build())
"""


def test_ranks_starting_together_build_one_library(tmp_path):
    """Two processes asking for the kernel library at once (two ranks'
    first use) take turns on the build directory's lock file: one compiles
    and links (nvcc stubbed by a script that records each link), the other
    finds its library; both load the same file and no temporary is left."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, links=str(tmp_path / "links")))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(build_dir), str(nvcc)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip().splitlines()[-1] for out in outs}
    assert len(paths) == 1
    assert len((tmp_path / "links").read_text().splitlines()) == 1
    lib = Path(paths.pop())
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [".build-lock", lib.name, lib.with_suffix(".log").name])


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo process group of this process alone."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kw", [
    dict(execution=dict(grad_accum=2), parallel=dict(mode="shard_map")),
    dict(parallel=dict(mode="shard_map", zero_sharding=True)),
    dict(execution=dict(kernels="blockfused"), parallel=dict(zero_sharding=True)),
], ids=["shard_map-grad_accum", "shard_map-zero", "zero-blockfused"])
def test_trainer_rejections_carry_jax_messages(group_of_one, kw):
    """'shard_map' with grad_accum=2, ZeRO under 'shard_map' and ZeRO with
    kernels='blockfused' raise ValueError with the JAX Trainer's own
    message, in a world of one too."""
    from resnet_tpu.train import Trainer as JTrainer
    from resnet_tpu_torch.train import Trainer

    jc = jcfg.TrainConfig(model=jcfg.tiny_model_config(),
                          execution=jcfg.ExecutionConfig(**kw.get("execution", {})),
                          parallel=jcfg.ParallelConfig(**kw["parallel"]),
                          data=jcfg.DataConfig(batch_size=BATCH, synthetic=True),
                          checkpoint_dir="")
    tc = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                          execution=tcfg.ExecutionConfig(**kw.get("execution", {})),
                          parallel=tcfg.ParallelConfig(**kw["parallel"]),
                          data=tcfg.DataConfig(batch_size=BATCH, synthetic=True),
                          checkpoint_dir="")
    with pytest.raises(ValueError) as want:
        JTrainer(jc, use_mesh=True)
    with pytest.raises(ValueError) as got:
        Trainer(tc, device="cpu", use_mesh=True)
    assert str(got.value) == str(want.value)


def test_num_devices_beyond_the_world_raises(group_of_one):
    """num_devices above the ranks running raises as JAX's make_mesh does
    for devices it does not have; below them too (one rank a device)."""
    from resnet_tpu_torch.parallel import make_mesh
    from resnet_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match="mesh wants 2 devices, only 1 available"):
        Trainer(_t_cfg(parallel=tcfg.ParallelConfig(num_devices=2)), device="cpu")
    with pytest.raises(ValueError, match="devices"):
        j_make_mesh(16)
    assert make_mesh(1).size == 1


def test_a_backend_that_cannot_start_raises(tmp_path):
    """No fallback: an unknown backend, NCCL on a host without the rank's
    GPU, a gloo rank whose coordinator never answers, and a rank mapped to
    a missing card all raise, and no group is left running."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="backend"):
        distributed.initialize_distributed(num_processes=2, process_id=0, backend="mpi")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="CUDA device"):
            distributed.initialize_distributed(
                num_processes=2, process_id=0, backend="nccl",
                store=dist.FileStore(str(tmp_path / "store"), 2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        distributed.rank_device("gloo", f"cuda:{torch.cuda.device_count()}")
    with pytest.raises(Exception):  # torch's DistNetworkError or DistStoreError
        distributed.initialize_distributed(f"localhost:{_free_port()}", 2, 1,
                                           backend="gloo", timeout_s=2)
    assert not dist.is_initialized()
    # one process and no torchrun environment: a no-op, as in JAX
    assert distributed.initialize_distributed(num_processes=1, backend="gloo") is False


@pytest.mark.parametrize("execution", [
    dict(kernels="fused"), dict(kernels="hybrid"), dict(kernels="fusedxla"),
    dict(kernels="blockfused"), dict(KERNELS, bn_stats_batch=2)],
    ids=["fused", "hybrid", "fusedxla", "blockfused", "ghost_bn"])
def test_auto_step_across_ranks_takes_every_engine(execution):
    """make_train_step with a mesh of two ranks takes the engines whose
    statistics come from their own kernels and ghost BN: the step sums
    their statistics over the ranks (tests/test_torch_parallel_engines.py)."""
    cfg = _t_cfg(execution=execution)
    for size in (1, 2):
        make_train_step(cfg, Mesh(size=size, rank=0))


def test_ranks_drive_the_card_unless_the_caller_names_the_cpu(tmp_path):
    """A gloo rank drives the card unless the caller names the CPU, an NCCL
    rank only a card; the worker, started without --device, asks for the
    card and so refuses to start on a host without one."""
    assert distributed.rank_device("gloo", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl"):
        distributed.rank_device("nccl", "cpu")
    if torch.cuda.device_count():
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        distributed.rank_device("gloo")
    (tmp_path / "spec.json").write_text("{}")
    done = subprocess.run(
        [sys.executable, "-m", WORKER, "0", "1", str(tmp_path / "store"),
         str(tmp_path / "spec.json"), str(tmp_path / "out")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert "CUDA device" in done.stderr
    assert not (tmp_path / "out").exists()
