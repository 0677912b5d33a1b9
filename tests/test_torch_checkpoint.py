"""The port's checkpoints against resnet_tpu.train.checkpoint on the CPU.

The gate: for one state (random leaves in the JAX package's tiny-model
tree, bridged with ``bridge.train_state_from_numpy``), both packages write
the same files byte for byte (registry.txt, every %03d.buffer,
trainer_checkpoint.txt and trainer_metadata.txt), for Adam and SGD, with
and without BN running statistics; a JAX dump restores in the port and a
port dump restores in JAX, to equal arrays. Then an actual reference dump
(positional trainer_checkpoint.txt, OIHW buffers in the reference's
registry order), the .npz format both ways, the atomic publish when a
write fails, ``discover_latest_dump``, and the async writer against the
sync one under per-tensor and fused (in-place) Adam.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.data import ShardCursor as JShardCursor
from resnet_tpu.optim import GuardedAdamState as JAdamState
from resnet_tpu.optim.sgd import SGDState as JSGDState
from resnet_tpu.train import checkpoint as jckpt
from resnet_tpu.train.state import TrainState as JTrainState
from resnet_tpu.train.state import init_train_state as j_init_train_state
from resnet_tpu_torch import bridge
from resnet_tpu_torch import config as tcfg
from resnet_tpu_torch.data import ShardCursor
from resnet_tpu_torch.data import SyntheticDataset
from resnet_tpu_torch.train import checkpoint as ckpt
from resnet_tpu_torch.train import init_train_state, make_train_step

CURSOR = (2, 17, 1)
META = {"loss_history": [2.5, 2.25, np.float32(2.125)]}


def _random_state(optimizer: str, bn: bool, seed: int = 0):
    """A JAX TrainState of numpy leaves: the tiny model's trees filled with
    random values, the decay products and steps of step 3."""
    rng = np.random.default_rng(seed)
    base = j_init_train_state(jcfg.TrainConfig(model=jcfg.tiny_model_config()))

    def fill(tree):
        return jax.tree.map(lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), tree)

    params = fill(base.params)
    if optimizer == "adam":
        opt = JAdamState(means=fill(params), vars=jax.tree.map(np.abs, fill(params)),
                         mean_decay_prod=np.float32(0.9) ** 3,
                         var_decay_prod=np.float32(0.999) ** 3, step=np.int32(3))
    else:
        opt = JSGDState(momentum_buf=fill(params), step=np.int32(3))
    bn_state = fill(base.bn_state) if bn else None
    return JTrainState(params=params, opt_state=opt, bn_state=bn_state, step=np.int32(3))


def _port_template(optimizer: str, bn: bool):
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(track_running_stats=bn),
                           optimizer=tcfg.OptimizerConfig(name=optimizer))
    return init_train_state(cfg, device="cpu")


def _jax_template(optimizer: str, bn: bool):
    cfg = jcfg.TrainConfig(model=jcfg.tiny_model_config(track_running_stats=bn),
                           optimizer=jcfg.OptimizerConfig(name=optimizer))
    return j_init_train_state(cfg)


def _equal_states(port_state, jax_state):
    """Every leaf equal bit for bit (the port's through bridge.to_numpy)."""
    a = bridge.to_numpy(port_state)
    for field in ("params", "bn_state"):
        got, want = getattr(a, field), getattr(jax_state, field)
        assert (got is None) == (want is None), field
        if want is not None:
            for (path, x), y in zip(bridge.flatten(got),
                                    jax.tree.leaves(jax.device_get(want)), strict=True):
                np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"{field}/{path}")
    for (path, x), y in zip(bridge.flatten(dict(a.opt_state._asdict())),
                            jax.tree.leaves(jax.device_get(jax_state.opt_state._asdict())),
                            strict=True):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path)
    assert int(a.step) == int(jax_state.step)


def _same_files(a, b):
    """Every file under dump dir a equals b's byte for byte; returns the count."""
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, files in os.walk(a) for f in files)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, files in os.walk(b) for f in files)
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return len(names)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("bn", [True, False])
def test_dumps_byte_identical_and_restore_both_ways(tmp_path, optimizer, bn):
    jstate = _random_state(optimizer, bn)
    pstate = bridge.train_state_from_numpy(jstate, device="cpu")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(jdir, 3, jstate, JShardCursor(*CURSOR), metadata=META)
    ckpt.save_checkpoint(pdir, 3, pstate, ShardCursor(*CURSOR), metadata=META)
    n = _same_files(os.path.join(jdir, "00000003"), os.path.join(pdir, "00000003"))
    n_params, n_bn = len(jax.tree.leaves(jstate.params)), len(jax.tree.leaves(jstate.bn_state))
    # registry, checkpoint, metadata; params, moments, running statistics
    assert n == 3 + n_params * (2 if optimizer == "sgd" else 3) + n_bn
    text = open(os.path.join(pdir, "00000003", "trainer_checkpoint.txt")).read()
    if optimizer == "adam":
        assert f"cur_mean_decay: {float(np.float32(0.9) ** 3)}\n" in text

    # a JAX dump restores in the port, a port dump in JAX
    restored, cur = ckpt.restore_checkpoint(jdir, 3, _port_template(optimizer, bn))
    assert (cur.shard, cur.batch_in_shard, cur.epoch) == CURSOR
    _equal_states(restored, jstate)
    assert restored.step.dtype == torch.int32 and restored.opt_state.step.dtype == torch.int32
    jrestored, jcur = jckpt.restore_checkpoint(pdir, 3, _jax_template(optimizer, bn))
    assert (jcur.shard, jcur.batch_in_shard, jcur.epoch) == CURSOR
    _equal_states(pstate, jax.device_get(jrestored))


def test_optimizer_mismatch_raises(tmp_path):
    for written, other in (("sgd", "adam"), ("adam", "sgd")):
        pstate = bridge.train_state_from_numpy(_random_state(written, True), device="cpu")
        ckpt.save_checkpoint(str(tmp_path / written), 0, pstate, ShardCursor())
        with pytest.raises(ValueError, match=f"rerun with --optimizer {written}"):
            ckpt.restore_checkpoint(str(tmp_path / written), 0, _port_template(other, True))


def test_restore_actual_reference_dump_format(tmp_path):
    """An actual reference dump — bare positional trainer_checkpoint.txt
    (resnet.cu:2743-2751), buffers in init-registry order
    (resnet.cu:805-949), conv weights OIHW — restores in the port as in
    JAX (tests/test_train.py::test_restore_actual_reference_dump_format)."""
    jstate = _random_state("adam", True)
    by_name = dict(jckpt.flat_registry(jstate.params))
    order = ckpt.reference_registry_order(jstate.params)
    assert order == jckpt.reference_registry_order(jstate.params)
    assert order[-1] == "fc/w" and set(order) == set(by_name)
    root = tmp_path / "00001000"
    for sub, tree in (("model_params", jstate.params), ("means", jstate.opt_state.means),
                      ("vars", jstate.opt_state.vars)):
        (root / sub).mkdir(parents=True)
        named = dict(jckpt.flat_registry(tree))
        for i, name in enumerate(order):
            leaf = np.asarray(named[name], np.float32)
            if leaf.ndim == 4:  # our HWIO -> reference OIHW
                leaf = leaf.transpose(3, 2, 0, 1)
            np.ascontiguousarray(leaf).tofile(root / sub / f"{i:03d}.buffer")
    (root / "trainer_checkpoint.txt").write_text("3\n17\n0.99\n0.9975\n1000\n2\n")

    restored, cursor = ckpt.restore_checkpoint(str(tmp_path), 1000,
                                               _port_template("adam", True))
    jrestored, _ = jckpt.restore_checkpoint(str(tmp_path), 1000, _jax_template("adam", True))
    assert (cursor.shard, cursor.batch_in_shard, cursor.epoch) == (3, 17, 2)
    assert int(restored.step) == 1000 and int(restored.opt_state.step) == 1000
    assert restored.opt_state.mean_decay_prod.item() == float(np.float32(0.99))
    _equal_states(restored, jax.device_get(jrestored))
    for (path, x), y in zip(bridge.flatten(bridge.to_numpy(restored.params)),
                            jax.tree.leaves(jstate.params), strict=True):
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_npz_both_ways(tmp_path):
    jstate = _random_state("adam", True)
    pstate = bridge.train_state_from_numpy(jstate, device="cpu")
    ckpt.save_npz(str(tmp_path / "port.npz"), pstate, ShardCursor(1, 2, 3), metadata=META)
    jckpt.save_npz(str(tmp_path / "jax.npz"), jstate, JShardCursor(1, 2, 3), metadata=META)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    jrestored, jcur = jckpt.restore_npz(str(tmp_path / "port.npz"), _jax_template("adam", True))
    restored, cur = ckpt.restore_npz(str(tmp_path / "jax.npz"), _port_template("adam", True))
    assert (cur.shard, cur.batch_in_shard, cur.epoch) == (1, 2, 3)
    assert (jcur.shard, jcur.batch_in_shard, jcur.epoch) == (1, 2, 3)
    _equal_states(restored, jstate)
    _equal_states(pstate, jax.device_get(jrestored))


def test_save_checkpoint_atomic_on_failure(tmp_path, monkeypatch):
    """A dump that dies mid-write is not visible to restore or discovery and
    does not clobber the previous dump."""
    pstate = bridge.train_state_from_numpy(_random_state("adam", True), device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 1000, pstate, ShardCursor())
    orig, calls = ckpt._write_buffers, {"n": 0}

    def failing_write(directory, registry):
        calls["n"] += 1
        if calls["n"] > 1:
            raise IOError("disk full")
        orig(directory, registry)

    monkeypatch.setattr(ckpt, "_write_buffers", failing_write)
    with pytest.raises(IOError):
        ckpt.save_checkpoint(str(tmp_path), 2000, pstate, ShardCursor())
    monkeypatch.setattr(ckpt, "_write_buffers", orig)
    assert not (tmp_path / "00002000").exists()
    assert not any(".tmp-" in name for name in os.listdir(tmp_path))
    assert ckpt.discover_latest_dump(str(tmp_path)) == 1000
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), 1000, _port_template("adam", True))
    _equal_states(restored, _random_state("adam", True))


def test_discover_latest_dump(tmp_path):
    assert ckpt.discover_latest_dump(str(tmp_path)) is None
    pstate = bridge.train_state_from_numpy(_random_state("sgd", False), device="cpu")
    for dump_id in (0, 1000):
        ckpt.save_checkpoint(str(tmp_path), dump_id, pstate, ShardCursor())
    assert ckpt.discover_latest_dump(str(tmp_path)) == 1000
    # the non-finite forensic sentinel is never resumable state
    ckpt.save_checkpoint(str(tmp_path), ckpt.NAN_DUMP_ID, pstate, ShardCursor())
    assert ckpt.discover_latest_dump(str(tmp_path)) == 1000
    # the final sentinel is (a finished run's last state)
    ckpt.save_checkpoint(str(tmp_path), ckpt.FINAL_DUMP_ID, pstate, ShardCursor())
    assert ckpt.discover_latest_dump(str(tmp_path)) == ckpt.FINAL_DUMP_ID
    # incomplete dumps (no trainer_checkpoint.txt) and temp dirs are invisible
    (tmp_path / "99999998").mkdir()
    (tmp_path / "99999997.tmp-1").mkdir()
    assert ckpt.discover_latest_dump(str(tmp_path)) == ckpt.FINAL_DUMP_ID
    assert ckpt.discover_latest_dump(str(tmp_path / "nowhere")) is None


@pytest.mark.parametrize("fused", [False, True])
def test_async_checkpointer_matches_sync(tmp_path, monkeypatch, fused):
    """The async writer's dump equals the sync dump of the same state even
    when the next step runs before the writer starts: under fused Adam that
    step updates params, means and vars in place, so the snapshot must be an
    owned copy taken inside save()."""
    cfg = tcfg.TrainConfig(model=tcfg.tiny_model_config(),
                           optimizer=tcfg.OptimizerConfig(learning_rate=1e-2, fused=fused))
    step = make_train_step(cfg)
    batch = next(SyntheticDataset(4, image_dim=16, num_classes=8))
    state, _ = step(init_train_state(cfg, device="cpu"), batch)
    cursor = ShardCursor(1, 2, 0)
    ckpt.save_checkpoint(str(tmp_path / "sync"), 100, state, cursor, metadata=META)

    released, orig = threading.Event(), ckpt.save_checkpoint

    def held_save(*args, **kwargs):
        assert released.wait(timeout=60)
        return orig(*args, **kwargs)

    monkeypatch.setattr(ckpt, "save_checkpoint", held_save)
    writer = ckpt.AsyncCheckpointer()
    writer.save(str(tmp_path / "async"), 100, state, cursor, metadata=META)
    p0 = state.params["fc"]["w"].clone()
    new_state, _ = step(state, batch)  # before the writer writes
    cursor.shard = 2
    assert (new_state.params["fc"]["w"] is state.params["fc"]["w"]) == fused
    assert not torch.equal(state.params["fc"]["w"], p0) or not fused
    released.set()
    writer.close()
    _same_files(str(tmp_path / "sync" / "00000100"), str(tmp_path / "async" / "00000100"))
