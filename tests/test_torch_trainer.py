"""The port's Trainer against resnet_tpu.train.Trainer on the CPU.

A JAX Trainer trains the tiny model for 6 steps from a shard directory of
two shards (three batches each, so the run crosses one shard advance and
ends on the epoch wrap), dumping every 2 steps. The port's
``Trainer(device="cpu")`` resumes from the JAX run's dump 0, so both start
from one state, and trains the same 6 steps. Per-step losses agree within
tests/test_torch_train.py's metric tolerance (1e-5 relative), the final
state within its state tolerances; the dump ids and every dump's cursor are
equal. Then: the dumped cursor is the last trained batch's, not the
prefetcher's; a resume mid-run equals the uninterrupted run bit for bit; a
non-finite parameter raises ``NonFiniteError`` after a 99999999 dump;
``device_batches`` cycles its staged batches; async dumps and resume from
the latest dump; evaluation.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.train import Trainer as JTrainer
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import ShardDataset, ShardIterator, write_shard
from resnet_tpu_torch.train import NonFiniteError, Trainer
from resnet_tpu_torch.train import checkpoint as ckpt

STEPS, EVERY, BATCH, PER_SHARD, SHARDS = 6, 2, 4, 12, 2
LR = 1e-4
METRIC_TOL = 1e-5  # tests/test_torch_train.py
TOL = 1e-4
DUMPS = ["00000000", "00000002", "00000004", "77777777"]


def _write_shards(directory, seed=5):
    """Two NCHW shards of the tiny model's 16x16 images; the labels number
    the images modulo the 8 classes, so a batch is identifiable."""
    rng = np.random.default_rng(seed)
    for s in range(SHARDS):
        imgs = rng.normal(0, 50, (PER_SHARD, 3, 16, 16)).astype(np.float32)
        labels = ((np.arange(PER_SHARD) + PER_SHARD * s) % 8).astype(np.int32)
        write_shard(directory, s, imgs, labels)


def _fields(shard_dir, dumps, **kw):
    data = dict(shard_dir=shard_dir, batch_size=BATCH, shard_images=PER_SHARD,
                num_shards=SHARDS, layout="NCHW")
    data.update(kw.pop("data", {}))
    top = dict(checkpoint_dir=dumps, checkpoint_every=EVERY, log_every=0)
    top.update(kw)
    return data, top


def _port_cfg(shard_dir, dumps, **kw):
    data, top = _fields(shard_dir, dumps, **kw)
    return tcfg.TrainConfig(
        model=tcfg.tiny_model_config(),
        execution=tcfg.ExecutionConfig(kernels="pallas", conv_kernels="pallas"),
        optimizer=tcfg.OptimizerConfig(learning_rate=LR),
        data=tcfg.DataConfig(**data), **top)


def _jax_cfg(shard_dir, dumps):
    data, top = _fields(shard_dir, dumps)
    return jcfg.TrainConfig(model=jcfg.tiny_model_config(),
                            optimizer=jcfg.OptimizerConfig(learning_rate=LR),
                            data=jcfg.DataConfig(**data), **top)


def _losses(dumps):
    with open(os.path.join(dumps, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def _cursor_lines(dumps, dump):
    with open(os.path.join(dumps, dump, "trainer_checkpoint.txt")) as f:
        return [ln for ln in f if ln.split(":")[0] in
                ("cur_shard", "cur_batch_in_shard", "cur_epoch", "cur_dump_id", "opt_step")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run (J), then the port's run (P) resumed from J's dump 0."""
    root = tmp_path_factory.mktemp("trainer")
    shards, jdir, pdir = (str(root / n) for n in ("shards", "jax", "port"))
    _write_shards(shards)
    jt = JTrainer(_jax_cfg(shards, jdir), use_mesh=False)
    jt.run(STEPS)
    jt.finalize()
    os.makedirs(pdir)
    shutil.copytree(os.path.join(jdir, "00000000"), os.path.join(pdir, "00000000"))
    pt = Trainer(_port_cfg(shards, pdir, resume_from=0), device="cpu")
    pt.run(STEPS)
    pt.finalize()
    return shards, jdir, pdir, jax.device_get(jt.state), pt


def test_trainer_matches_jax(runs):
    shards, jdir, pdir, jstate, pt = runs
    assert sorted(d for d in os.listdir(pdir) if d.isdigit()) == DUMPS
    assert sorted(d for d in os.listdir(jdir) if d.isdigit()) == DUMPS
    for dump in DUMPS:
        assert _cursor_lines(pdir, dump) == _cursor_lines(jdir, dump), dump
    jl, pl = _losses(jdir), _losses(pdir)
    assert sorted(pl) == sorted(jl) == list(range(STEPS))
    for s in range(STEPS):
        assert pl[s] == pytest.approx(jl[s], rel=METRIC_TOL), s
    # the final state: tests/test_torch_train.py's tolerances
    assert int(pt.state.step) == STEPS and int(pt.state.opt_state.step) == STEPS
    for tree, want, tol in (
            (pt.state.params, jstate.params, lambda s: TOL * s + 2 * LR * STEPS),
            (pt.state.opt_state.means, jstate.opt_state.means, lambda s: TOL * s),
            (pt.state.opt_state.vars, jstate.opt_state.vars, lambda s: TOL * s),
            (pt.state.bn_state, jstate.bn_state, lambda s: TOL * max(s, 1.0))):
        for (path, x), y in zip(bridge.flatten(bridge.to_numpy(tree)), jax.tree.leaves(want),
                                strict=True):
            y = np.asarray(y)
            assert np.abs(x - y).max() <= tol(np.abs(y).max()), path
    for k in ("mean_decay_prod", "var_decay_prod"):
        assert getattr(pt.state.opt_state, k).item() == float(getattr(jstate.opt_state, k))
    assert pt.loader in ("native", "python")


def test_trainer_resume_mid_run_is_bit_exact(runs, tmp_path):
    """The port resumed from its own dump 2 ends where its uninterrupted
    run ended, bit for bit: every buffer and the checkpoint text."""
    shards, _, pdir, _, _ = runs
    rdir = str(tmp_path / "resumed")
    os.makedirs(rdir)
    shutil.copytree(os.path.join(pdir, "00000002"), os.path.join(rdir, "00000002"))
    cfg = _port_cfg(shards, rdir, resume_from=tcfg.RESUME_LATEST)
    t = Trainer(cfg, device="cpu")
    assert int(t.state.step) == 2
    t.run(STEPS - 2)
    t.finalize()
    for sub in ("model_params", "means", "vars", "bn_state"):
        a, b = os.path.join(pdir, "77777777", sub), os.path.join(rdir, "77777777", sub)
        for name in sorted(os.listdir(a)):
            with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), f"{sub}/{name}"
    for name in ("registry.txt", "trainer_checkpoint.txt"):
        with open(os.path.join(pdir, "77777777", name)) as fa, \
                open(os.path.join(rdir, "77777777", name)) as fb:
            assert fa.read() == fb.read(), name
    full, resumed = _losses(pdir), _losses(rdir)
    assert sorted(resumed) == list(range(2, STEPS))
    assert all(resumed[s] == full[s] for s in resumed)


@pytest.mark.parametrize("flip", [False, True])
def test_checkpoint_cursor_not_skewed_by_prefetch(runs, tmp_path, flip):
    """The prefetcher runs batches ahead of training; a dump records the
    stream position of the last *trained* batch, so a resume re-reads the
    first untrained batch (tests/test_train.py's test of the same name).
    With random_flip the Python loader runs, else the native one where it
    is built."""
    shards = runs[0]
    dumps = str(tmp_path / "dumps")
    cfg = _port_cfg(shards, dumps, data=dict(prefetch=2, random_flip=flip))
    t = Trainer(cfg, device="cpu")
    assert t.loader == "python" if flip else t.loader in ("native", "python")
    t.run(4)  # the dump at step 2 happens BEFORE training batch 2
    t.finalize()
    _, cursor = ckpt.restore_checkpoint(dumps, 2, t.state)
    ds = ShardDataset(shards, num_shards=SHARDS, shard_images=PER_SHARD, image_dim=16,
                      disk_layout="NCHW")
    labels = next(ShardIterator(ds, BATCH, cursor=cursor))["labels"]
    np.testing.assert_array_equal(labels, (np.arange(8, 12) % 8).astype(np.int32))
    # the trainer's own cursor is batch 3's: shard 1, batch 1 (both forms)
    assert (t.cursor.shard, t.cursor.batch_in_shard) == (1, 1)


def test_nonfinite_parameter_dumps_sentinel_and_raises(runs, tmp_path):
    dumps = str(tmp_path / "dumps")
    t = Trainer(_port_cfg(runs[0], dumps, check_errors=True, checkpoint_every=0),
                device="cpu")
    t.run(1)
    t.state.params["fc"]["w"][0, 0] = float("nan")
    with pytest.raises(NonFiniteError, match="fc/w: 1 NaN"):
        t.run(1)
    assert ckpt.discover_latest_dump(dumps) is None  # the sentinel is not resumable
    text = open(os.path.join(dumps, "99999999", "trainer_checkpoint.txt")).read()
    assert "cur_dump_id: 2\n" in text
    t.finalize()


def test_device_batches_cycle(tmp_path):
    """device_batches=K stages K synthetic batches on the device once and
    cycles them: batch i + K is batch i, with no per-step copy."""
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                           data=tcfg.DataConfig(batch_size=BATCH, synthetic=True,
                                                device_batches=3),
                           checkpoint_dir="", log_every=0)
    t = Trainer(cfg, device="cpu")
    it = t._device_iter()
    first = [next(it) for _ in range(3)]
    assert all(isinstance(b["images"], torch.Tensor) for b in first)
    assert not torch.equal(first[0]["images"], first[1]["images"])
    assert all(next(it) is b for b in first)
    last = t.run(4)
    assert np.isfinite(last["loss"]) and int(t.state.step) == 4
    t.finalize()


def test_async_checkpoint_resume_latest_and_evaluate(runs, tmp_path, capsys):
    shards = runs[0]
    dumps = str(tmp_path / "dumps")
    cfg = _port_cfg(shards, dumps, async_checkpoint=True)
    t = Trainer(cfg, device="cpu")
    t.run(5)
    t.checkpointer.wait()
    assert ckpt.discover_latest_dump(dumps) == 4
    t2 = Trainer(dataclasses.replace(cfg, resume_from=tcfg.RESUME_LATEST,
                                     async_checkpoint=False), device="cpu")
    assert int(t2.state.step) == 4
    assert "resumed from dump 4 at step 4" in capsys.readouterr().out
    t.finalize()
    assert ckpt.discover_latest_dump(dumps) == ckpt.FINAL_DUMP_ID
    metrics = t.evaluate(t._build_data(), 2)
    assert set(metrics) == {"loss", "accuracy", "top5"}
    assert all(np.isfinite(v) for v in metrics.values())
    qmetrics = t.evaluate_quantized(t._build_data(), 2)
    assert set(qmetrics) == {"loss", "accuracy", "top5"}
    assert all(np.isfinite(v) for v in qmetrics.values())
    with pytest.raises(FileNotFoundError):
        Trainer(dataclasses.replace(cfg, resume_from=tcfg.RESUME_LATEST,
                                    checkpoint_dir=str(tmp_path / "nowhere")), device="cpu")
