"""One rank of a data-parallel run: the counterpart of the JAX package's
``tools/distributed_worker.py``, for the tests and ``chip_smoke.py``.

The parent starts one process per rank, all with the same ``SPEC`` (a JSON
file) and a ``torch.distributed.FileStore`` path; each rank joins the group
with the backend given (a world of 1 too, so that NCCL can be held against
the step without a group on one card), runs what the spec asks on its
device, and writes what it found to ``OUT/rank<r>.pt`` (``torch.save`` of
plain dicts, lists and CPU tensors) for the parent to compare.

What it runs (``spec`` keys; a spec may hold both, run in this order):

``cases``: from one initial state (``spec["state"]``, a saved
``{"params", "bn_state"}``, else the config's seeded init) and one global
batch (``spec["batch"]``), each case of ``spec["cases"]`` runs its steps on
this rank's rows (``parallel.shard_batch``): mode 'auto' (the global-batch
step) or 'shard_map' (local BN, explicit sums), with ``"zero"`` the
ZeRO-sharded state, with ``"state"`` (a saved ``{"params", "bn_state"}``)
its own initial state, with ``"mesh": [data, model]`` the composite step on
``parallel.make_mesh_2d(data, model)`` with the FC head split by
``parallel.composite_shardings`` (the rows of the rank's data index; the
local FC shape and the plan recorded, and with ``"dump"`` a directory, a
dump of the state after the steps), with ``"mesh": [data, spatial]`` and
``"axes": ["data", "spatial"]`` the spatial step on that grid (the rank's
rows and slice of their height, ``parallel.spatial_shard_batch``; with
``"zero"`` the state sharded over the data group); a case's ``"batch"`` (a
saved batch) stands for the spec's, and ``"fresh"`` starts from the
config's seeded init. It records
the launch counters' moves over the steps (the main path), the metrics, the
whole parameters, running statistics and Adam moments after them (rank 0;
those of the case's ``"keep"`` list where it has one), each rank's state
bytes, with ``"grads"`` the summed gradient of the first
forward and backward and its batch statistics (taken apart from the counted
steps), with ``"time"`` that many more steps timed one by one. A case
``{"kind": "moments"}`` holds the statistics Function alone: this rank's
rows of ``spec["moments_x"]`` through ``kernels.bn.moments`` and
``moments_plain`` inside ``sync_stats``, with the gradient of a fixed
weighting of mean and var. A case ``{"kind": "spatial_ops", "mesh": [1,
s]}`` runs each of its ``"ops"`` (a conv, a max pool, the global average
pool, a fused-engine site through ``kernels.fused_conv.fused_conv`` or, with
``"fn": "chain"``, ``conv_chain`` (a prologue with shift > 0 on every
channel, unless ``"prologue"`` is false), or the space-to-depth stem
``ops.space_to_depth.s2d_stem_conv`` with its 7x7 weight, of seeded
inputs, on the rows of the plan it names or the even split) on this rank's
rows inside ``parallel.spatial.partition``, forward and backward against a
seeded cotangent (of the site's sums too), recording the rank's output and
gradients and the shape of every collective the spatial group ran. A step
case with ``"audit"`` records the shape of every collective of its steps
(``Mesh.all_gather`` and ``Mesh.sum_``).

A case's config is ``spec["config"]`` (the TrainConfig's fields as nested
dicts) with the case's ``"config"`` fields in place of those.

``trainer``: the Trainer on ``spec["trainer"]["config"]`` for its
``"steps"`` steps, the rows of every batch it trained recorded (the first
four values of each image); with ``"kill"`` the process then kills itself
with SIGKILL (a crash after the last dump), else it finalizes (the final
dump).

    python -m resnet_tpu_torch.tools.distributed_worker RANK WORLD STORE SPEC OUT \\
        [--backend gloo|nccl] [--device cuda|cpu]

The ranks run on the card (``--device cuda``, the default) unless the
caller names the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import config as tcfg
from ..bridge import flatten, tree_map
from ..parallel import (
    composite_shardings,
    distributed,
    make_mesh,
    make_mesh_2d,
    shard_batch,
    spatial,
    spatial_shard_batch,
)
from ..parallel.multihost import fetch_global, put_global


def train_config(spec: dict) -> tcfg.TrainConfig:
    """A TrainConfig from its fields as nested dicts; ``model`` may name a
    preset ("tiny" the tiny model)."""
    spec = dict(spec)
    model = spec.pop("model", "resnet50")
    if isinstance(model, str):
        model = tcfg.tiny_model_config() if model == "tiny" else tcfg.model_config(model)
    else:
        model = tcfg.ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                                    for k, v in model.items()})
    parts = {"execution": tcfg.ExecutionConfig, "optimizer": tcfg.OptimizerConfig,
             "data": tcfg.DataConfig, "parallel": tcfg.ParallelConfig}
    kw = {k: cls(**spec.pop(k, {})) for k, cls in parts.items()}
    return tcfg.TrainConfig(model=model, **kw, **spec)


def _cpu(tree):
    return None if tree is None else tree_map(lambda t: t.detach().to("cpu").clone(), tree)


def _counts():
    """Every kernel's launch counter (``checks.KERNELS``), and K10's stage
    calls (``block_fused.STAGE_LAUNCHES``, a block whose statistics are
    summed over the ranks)."""
    from ..kernels import block_fused, checks

    counts = {name: getattr(mod, attr) for name, (mod, attr, _, _) in checks.KERNELS.items()}
    counts["block_fused_stage"] = block_fused.STAGE_LAUNCHES
    counts["block_fused_stage_bf16"] = block_fused.STAGE_LAUNCHES_BF16
    return counts


def _state(cfg, init, device):
    """A fresh state of cfg on device, its parameters and running statistics
    ``init``'s where given."""
    from ..train import init_train_state

    state = init_train_state(cfg, device=device)
    if init is None:
        return state
    with torch.no_grad():
        for name in ("params", "bn_state"):
            for (path, t), (_, v) in zip(flatten(getattr(state, name)),
                                         flatten(init[name]), strict=True):
                t.copy_(v.to(t.dtype))
    return state


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _moments_case(case, spec, mesh, device):
    from ..kernels.bn import moments, moments_plain, sync_stats

    x = shard_batch({"x": spec["moments_x"]}, mesh)["x"].to(device)
    c = x.shape[-1]
    cm = torch.linspace(-1.0, 1.0, c, device=device)
    cv = torch.linspace(0.5, 1.5, c, device=device)
    out = {}
    for name, fn in (("moments", lambda t: moments(t.reshape(-1, c))),
                     ("moments_plain_nchw",
                      lambda t: moments_plain(t.permute(0, 3, 1, 2), channel_dim=1))):
        xg = x.detach().clone().requires_grad_(True)
        with sync_stats(mesh.sum_):
            mean, var = fn(xg)
            ((mean * cm).sum() + (var * cv).sum()).backward()
        out[name] = {"mean": _cpu(mean), "var": _cpu(var), "dx": _cpu(xg.grad)}
    return out


class _Collectives:
    """Within the block every ``Mesh.all_gather`` and ``Mesh.sum_`` is
    recorded: (kind, shape of the tensor a rank puts in)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from ..parallel.mesh import Mesh

        self.saved = Mesh.all_gather, Mesh.sum_
        gather, total = self.saved

        def all_gather(mesh, t):
            self.calls.append(("all_gather", list(t.shape)))
            return gather(mesh, t)

        def sum_(mesh, t):
            self.calls.append(("sum", list(t.shape)))
            return total(mesh, t)

        Mesh.all_gather, Mesh.sum_ = all_gather, sum_
        return self

    def __exit__(self, *exc):
        from ..parallel.mesh import Mesh

        Mesh.all_gather, Mesh.sum_ = self.saved


def spatial_op_inputs(op):
    """The seeded inputs of a spatial op: (x, weight, scale, shift), the
    last two a fused site's prologue rows (shift > 0 on every channel, so
    that a halo row that became act(shift) shows)."""
    gen = torch.Generator().manual_seed(op.get("seed", 0))
    n, h, w, cin = op["n"], op["h"], op["w"], op["cin"]
    x = torch.randn(n, h, w, cin, generator=gen)
    k = op.get("k", 1)
    weight = torch.randn(k, k, cin, op.get("cout", cin), generator=gen) * 0.3
    scale = 1 + 0.2 * torch.randn(cin, generator=gen)
    shift = 0.1 + 0.5 * torch.randn(cin, generator=gen).abs()
    return x, weight, scale, shift, gen


def _spatial_op(op, group, device):
    """One op of a spatial_ops case on this rank's rows: (output, input
    gradient, weight gradient or None, the rank's output rows; a fused
    site's sums over the rank's rows and the prologue rows' gradients)."""
    from ..kernels.fused_conv import conv_chain, fused_conv
    from ..ops.dispatch import conv
    from ..ops.space_to_depth import s2d_stem_conv

    n, h, w = op["n"], op["h"], op["w"]
    layout, kind = op.get("layout", "NHWC"), op["op"]
    x, weight, scale, shift, gen = spatial_op_inputs(op)
    k, s = op.get("k", 1), op.get("s", 2 if kind == "s2d" else 1)
    rec = {}
    with spatial.partition(group) as part:
        if op.get("rows"):
            part.plans[w] = (h, tuple(tuple(r) for r in op["rows"]))
        a, b = (op["rows"][group.rank] if op.get("rows")
                else spatial.even_rows(h, group.size)[group.rank])
        xt = x[:, a:b].contiguous().to(device).requires_grad_(True)
        wt = weight.to(device).requires_grad_(True)
        sc, sh = (t.to(device).requires_grad_(True) for t in (scale, shift))
        xl = xt.permute(0, 3, 1, 2) if layout == "NCHW" else xt
        sums = None
        if kind == "conv":
            y = spatial.conv(xl, k, s, layout, lambda t, pad: conv(
                t, wt, stride=s, engine=op.get("engine", "xla"), layout=layout, padding=pad))
        elif kind == "fused":
            pro = op.get("prologue", True)
            fn = conv_chain if op.get("fn") == "chain" else None
            y, sums = spatial.conv(xl, k, s, layout, lambda t, pad: (
                fn(t, wt, sc, sh, s, pro, True, None, pad) if fn
                else fused_conv(t, wt, sc, sh, s, pad, pro, True, None)))
        elif kind == "s2d":
            y = s2d_stem_conv(xl, wt)
        elif kind == "max_pool":
            y = spatial.max_pool(xl, k, s, layout)
        else:
            y = spatial.global_avg_pool(xl, layout)
        if layout == "NCHW" and y.dim() == 4:
            y = y.permute(0, 2, 3, 1)
        if kind == "avg":
            oa, ob = 0, 1
            gy = torch.randn(n, y.shape[-1], generator=gen)
        else:
            _, out_rows = spatial.next_rows(part.plans[w][1], h, s)
            oa, ob = out_rows[group.rank]
            gy = torch.randn(n, h // s, y.shape[2], y.shape[3], generator=gen)[:, oa:ob]
        loss = (y * gy.to(device)).sum()
        if sums is not None:  # the sums' cotangent, the same on every rank
            loss = loss + (sums * torch.randn(sums.shape, generator=gen).to(device)).sum()
        loss.backward()
    if sums is not None:
        rec = {"sums": _cpu(sums), "dscale": _cpu(sc.grad), "dshift": _cpu(sh.grad)}
    weighted = kind in ("conv", "fused", "s2d")
    return dict(rec, y=_cpu(y), dx=_cpu(xt.grad), dw=_cpu(wt.grad) if weighted else None,
                rows=(a, b), out_rows=(oa, ob))


def _spatial_ops_case(case, device):
    mesh = make_mesh_2d(*case["mesh"], axes=("data", "spatial"))
    group = mesh.spatial
    out = []
    for op in case["ops"]:
        with _Collectives() as seen:
            rec = _spatial_op(op, group, device)
        rec["collectives"] = seen.calls
        out.append(rec)
    return out


def _step_case(case, spec, mesh, device, init):
    from ..kernels.bn import sync_stats
    from ..train import loss_and_grads, make_train_step
    from ..train.state import state_bytes, zero_plan
    from ..train.step import reduce_grads, reduce_spatial, stats_sum

    cfg = train_config(dict(spec["config"], **case.get("config", {})))
    mode = cfg.parallel.mode
    if case.get("state"):
        init = torch.load(case["state"], weights_only=True)
    state = _state(cfg, None if case.get("fresh") else init, device)
    whole_batch = torch.load(case["batch"], weights_only=True) if case.get("batch") \
        else spec["batch"]
    accum = cfg.execution.grad_accum if mode == "auto" else 1
    plan = None
    rec = {"replicated_state_bytes": state_bytes(state)}
    sp = None
    if case.get("mesh"):
        mesh = make_mesh_2d(*case["mesh"], axes=tuple(case.get("axes", ("data", "model"))))
        sp = mesh.spatial
        if sp is None:
            # the data x model grid, the FC head split over the model group
            plan = composite_shardings(state, mesh)
            state = put_global(state, plan, mesh)
            rec["fc_shape"] = list(state.params["fc"]["w"].shape)
            rec["plan"] = plan.params
    if sp is not None:
        batch = spatial_shard_batch(whole_batch, mesh, layout=cfg.execution.layout)
        batch = {k: v.to(device) for k, v in batch.items()}
    else:
        batch = {k: v.to(device) for k, v in shard_batch(
            whole_batch, getattr(mesh, "data", mesh), grad_accum=accum).items()}
    if case.get("zero"):
        plan = zero_plan(state, mesh, cfg.parallel.zero_min_bytes)
        state = put_global(state, plan, mesh)
    step = make_train_step(cfg, mesh, plan)
    if case.get("grads"):
        params = fetch_global(state.params, plan.params if plan else None, mesh)
        with sync_stats(stats_sum(cfg, mesh)), spatial.partition(sp):
            loss, _, aux, grads = loss_and_grads(params, batch, state.bn_state, cfg)
        grads, loss = (reduce_grads(mesh, grads, loss) if sp is None
                       else reduce_spatial(mesh, grads, loss))
        stats = aux["bn_stats"]
        rec["grad_loss_sum"] = float(loss)
        if mesh.rank == 0:
            rec["grads"] = _cpu(grads)
        rec["bn_stats"] = {"init_bn": _cpu(list(stats["init_bn"])),
                           "blocks": [{k: _cpu(list(v)) for k, v in b.items()}
                                      for b in stats["blocks"]]}
        del grads, params
    _sync(device)
    before = _counts()
    metrics = {}
    with _Collectives() as seen:
        for _ in range(case.get("steps", 1)):
            state, metrics = step(state, batch)
    if case.get("audit"):
        rec["collectives"] = seen.calls
        rec["param_elements"] = sum(t.numel() for _, t in flatten(state.params))
    _sync(device)
    after = _counts()
    rec["counts"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    rec["metrics"] = {k: float(v) for k, v in metrics.items()}
    rec["state_bytes"] = state_bytes(state)
    whole = fetch_global(state, plan, mesh)
    if mesh.rank == 0:
        kept = {"params": whole.params, "bn_state": whole.bn_state,
                "means": getattr(whole.opt_state, "means", None)}
        for key in case.get("keep", kept):
            rec[key] = _cpu(kept[key])
    del whole
    if case.get("dump"):
        # the dump of a sharded state: rank 0 writes whole tensors
        from ..data import ShardCursor
        from ..train.checkpoint import save_checkpoint

        rec["dump"] = save_checkpoint(case["dump"], int(state.step), state, ShardCursor(),
                                      mesh=mesh, plan=plan)
    times = []
    for _ in range(case.get("time", 0)):
        _sync(device)
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    rec["step_ms"] = times
    return rec


class _Recorder:
    """A host iterator that keeps the first four values of each image of
    every batch it yields, in order."""

    def __init__(self, source):
        self.source, self.rows = iter(source), []

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.source)
        images = np.asarray(batch["images"])
        self.rows.append(images.reshape(len(images), -1)[:, :4].copy())
        return batch


def _trainer(spec, device, batch=None):
    from ..train import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(train_config(spec["config"]), device=device)
    recorder = _Recorder(trainer._host_iter)
    trainer._host_iter = recorder
    n = spec["steps"]
    last = trainer.run(n)
    rec = {"rows": [torch.from_numpy(r) for r in recorder.rows[:n]], "metrics": last,
           "loader": trainer.loader, "step": int(trainer.state.step),
           "cursor": dataclasses.astuple(trainer.cursor),
           "seconds": time.perf_counter() - t0}
    if spec.get("eval"):
        # the global batch, each rank its part of it (rows, height slice)
        whole = {k: v.numpy() for k, v in batch.items()}
        rec["eval"] = trainer.evaluate(
            iter([trainer.rank_batch(whole)] * spec["eval"]), spec["eval"])
    if spec.get("kill"):
        # what rank 0 would have written is on disk (the dumps are
        # synchronous); the final dump is not
        dist.barrier()
        os.kill(os.getpid(), signal.SIGKILL)
    trainer.finalize()
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("store", help="FileStore path shared by the ranks")
    ap.add_argument("spec", help="JSON file: the scenario")
    ap.add_argument("out", help="directory for rank<r>.pt")
    ap.add_argument("--backend", default="gloo", choices=list(distributed.BACKENDS))
    ap.add_argument("--device", default="cuda",
                    help="the device a gloo rank drives (NCCL: cuda:<rank>)")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    for key in ("batch", "state", "moments_x"):
        if spec.get(key):
            spec[key] = torch.load(spec[key], weights_only=True)
    store = dist.FileStore(args.store, args.world)
    if args.world > 1:
        distributed.initialize_distributed(
            num_processes=args.world, process_id=args.rank, backend=args.backend,
            store=store, timeout_s=spec.get("timeout_s", 600))
    else:  # a world of one: the group exists, its collectives are the identity
        if args.backend == "nccl":
            torch.cuda.set_device(distributed.rank_device("nccl"))
        dist.init_process_group(args.backend, store=store, rank=0, world_size=1)
    device = distributed.rank_device(args.backend, args.device)
    out = {"rank": args.rank, "world": args.world, "backend": dist.get_backend()}
    mesh = make_mesh()
    for case in spec.get("cases", []):
        if case.get("kind") == "moments":
            out[case["name"]] = _moments_case(case, spec, mesh, device)
        elif case.get("kind") == "spatial_ops":
            out[case["name"]] = _spatial_ops_case(case, device)
        else:
            out[case["name"]] = _step_case(case, spec, mesh, device, spec.get("state"))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"rank{args.rank}.pt")
    if "trainer" in spec:
        torch.save(out, path)  # the cases' results survive a killed trainer
        out["trainer"] = _trainer(spec["trainer"], device, spec.get("batch"))
    torch.save(out, path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
