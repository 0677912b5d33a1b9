"""The port's parameter trees against the JAX package's: init structure,
the numpy bridge both ways, JAX npz checkpoints, and no JAX in the port."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from resnet_tpu import config as jcfg
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu_torch import bridge
from resnet_tpu_torch.config import model_config, tiny_model_config
from resnet_tpu_torch.models import init_bn_state, init_params

REPO = Path(__file__).resolve().parent.parent

CONFIGS = {
    "tiny": (tiny_model_config, jcfg.tiny_model_config),
    "resnet18": (lambda: model_config("resnet18"), lambda: jcfg.model_config("resnet18")),
    "resnet50": (lambda: model_config("resnet50"), lambda: jcfg.model_config("resnet50")),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_tree_matches_jax(name):
    tcfg, jc = CONFIGS[name][0](), CONFIGS[name][1]()
    gen = torch.Generator().manual_seed(0)
    ours = bridge.flatten(bridge.to_numpy(init_params(gen, tcfg, device="cpu")))
    theirs = bridge.flatten(_np_tree(j_init_params(jax.random.PRNGKey(0), jc)))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size >= 4096 and path.endswith("w"):  # same per-tensor variance
            np.testing.assert_allclose(a.var(), b.var(), rtol=0.15, err_msg=path)
    ours_bn = bridge.flatten(bridge.to_numpy(init_bn_state(tcfg, device="cpu")))
    theirs_bn = bridge.flatten(_np_tree(j_init_bn_state(jc)))
    assert [p for p, _ in ours_bn] == [p for p, _ in theirs_bn]
    for (path, a), (_, b) in zip(ours_bn, theirs_bn):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_numpy_round_trip():
    jc = jcfg.tiny_model_config()
    params = _np_tree(j_init_params(jax.random.PRNGKey(3), jc))
    state = _np_tree(j_init_bn_state(jc))
    tp = bridge.params_from_numpy(params, device="cpu")
    ts = bridge.bn_state_from_numpy(state, device="cpu")
    assert isinstance(tp["blocks"], list) and tp["blocks"][0]["reduce"]["w"].dtype == torch.float32
    for tree, back in ((params, bridge.to_numpy(tp)), (state, bridge.to_numpy(ts))):
        a, b = bridge.flatten(tree), bridge.flatten(back)
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(x, y, err_msg=path)
    # the bridge copies: writing to the torch side leaves numpy untouched
    tp["fc"]["w"].add_(1.0)
    assert not np.allclose(bridge.to_numpy(tp)["fc"]["w"], params["fc"]["w"])


def test_bridge_defaults_to_the_card():
    """Like every entry point of the port, the bridge puts what it builds
    on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (bridge.params_from_numpy, bridge.bn_state_from_numpy,
               bridge.train_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_leaves_are_flattens_leaves_in_jax_order():
    """leaves walks the tree without building paths, in flatten's order,
    which is JAX's (tree_leaves of the same nesting)."""
    tree = {"b": [{"y": 1, "x": (2, 3)}, None], "a": {"k": [4, [5]], "c": 6}, "z": 7}
    assert bridge.leaves(tree) == [leaf for _, leaf in bridge.flatten(tree)]
    assert bridge.leaves(tree) == jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: x is None)
    assert bridge.leaves(5) == [5]
    other = bridge.tree_map(lambda x: x if x is None else -x, tree)
    assert bridge.leaves_of(tree, other, tree) == [
        bridge.leaves(tree), bridge.leaves(other), bridge.leaves(tree)]
    with pytest.raises(ValueError):  # a key missing
        bridge.leaves_of(tree, {"b": tree["b"], "a": tree["a"]})
    with pytest.raises(KeyError):  # another key
        bridge.leaves_of(tree, {"b": tree["b"], "a": tree["a"], "y": 7})
    with pytest.raises(ValueError):  # a list where the others hold a leaf
        bridge.leaves_of(dict(tree, z=[7]), tree)


def test_unflatten_rejects_gapped_lists():
    with pytest.raises(ValueError):
        bridge.unflatten([("blocks/0/w", 1), ("blocks/2/w", 2)])


def test_load_jax_npz_checkpoint(tmp_path):
    from resnet_tpu.data.shards import ShardCursor
    from resnet_tpu.train.checkpoint import save_npz
    from resnet_tpu.train.state import init_train_state

    cfg = jcfg.TrainConfig(model=jcfg.tiny_model_config())
    state = init_train_state(cfg, jax.random.PRNGKey(7))
    state = state._replace(bn_state=jax.tree.map(lambda a: a + 0.25, state.bn_state))
    path = str(tmp_path / "ckpt.npz")
    save_npz(path, state, ShardCursor(1, 2, 3))

    params, bn_state = bridge.load_jax_npz(path)
    for got, want in ((params, state.params), (bn_state, state.bn_state)):
        a, b = bridge.flatten(got), bridge.flatten(_np_tree(want))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (p, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=p)
    # and the tree serves directly through the port
    from resnet_tpu_torch.models import forward

    x = torch.zeros(1, 16, 16, 3)
    logits, _ = forward(bridge.params_from_numpy(params, device="cpu"), x, tiny_model_config(),
                        train=False, bn_state=bridge.bn_state_from_numpy(bn_state, device="cpu"))
    assert logits.shape == (1, 8)


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import resnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "resnet_tpu_torch.__path__, 'resnet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'resnet_tpu')"
        " or m.startswith(('jax.', 'jaxlib', 'resnet_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_train_state_round_trip(opt):
    """A JAX TrainState (params, optimizer state, BN state, step) goes to the
    port and back to numpy unchanged, leaf for leaf, with its types."""
    from resnet_tpu.train.state import init_train_state as j_init_train_state
    from resnet_tpu_torch.optim import GuardedAdamState, SGDState
    from resnet_tpu_torch.train import TrainState

    cfg = jcfg.TrainConfig(model=jcfg.tiny_model_config(),
                           optimizer=jcfg.OptimizerConfig(name=opt))
    state = j_init_train_state(cfg, jax.random.PRNGKey(5))
    state = state._replace(step=state.step + 3)
    theirs = _np_tree(state)
    ours = bridge.train_state_from_numpy(theirs, device="cpu")
    assert isinstance(ours, TrainState)
    assert isinstance(ours.opt_state, GuardedAdamState if opt == "adam" else SGDState)
    assert ours.step.dtype == torch.int32 and int(ours.step) == 3
    back = bridge.to_numpy(ours)
    assert isinstance(back, TrainState)
    a, b = bridge.flatten(back), bridge.flatten(theirs)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_train_configs_mirror_jax():
    """OptimizerConfig, DataConfig, ParallelConfig and TrainConfig field for
    field, the same defaults, RESUME_LATEST and VARIANT_PRESETS; the ported
    variants give the same configs, the others name their queue A item."""
    import dataclasses

    from resnet_tpu_torch import config as tcfg

    for name in ("OptimizerConfig", "DataConfig", "ParallelConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)()), name
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tcfg.TrainConfig) == names(jcfg.TrainConfig)
    ours, theirs = tcfg.TrainConfig(), jcfg.TrainConfig()
    for f in names(tcfg.TrainConfig):
        if f != "execution":  # the port drops the TPU-only execution fields
            assert dataclasses.asdict(ours)[f] == dataclasses.asdict(theirs)[f], f
    assert tcfg.RESUME_LATEST == jcfg.RESUME_LATEST
    assert tcfg.VARIANT_PRESETS == jcfg.VARIANT_PRESETS
    assert sorted(tcfg.VARIANT_PRESETS) == ["clean", "cudnn", "fast", "lowmem", "nchw",
                                            "resnet"]
    for variant in tcfg.VARIANT_PRESETS:
        a = dataclasses.asdict(tcfg.variant_config(variant, seed=7))
        b = dataclasses.asdict(jcfg.variant_config(variant, seed=7))
        for e in ("pallas_interpret", "scoped_vmem_limit_kib", "grad_accum_unroll"):
            b["execution"].pop(e)
        assert a == b, variant
    # ZeRO and spatial partitioning run (on a process group), spatial with a
    # fused engine too; only the whole-block engine is refused there, as JAX's
    tcfg.TrainConfig(parallel=tcfg.ParallelConfig(zero_sharding=True))
    tcfg.TrainConfig(parallel=tcfg.ParallelConfig(spatial_devices=2))
    tcfg.TrainConfig(execution=tcfg.ExecutionConfig(kernels="fused"),
                     parallel=tcfg.ParallelConfig(spatial_devices=2))
    with pytest.raises(ValueError, match="blockfused"):
        tcfg.TrainConfig(execution=tcfg.ExecutionConfig(kernels="blockfused"),
                         parallel=tcfg.ParallelConfig(spatial_devices=2))


def test_no_jax_import_in_the_port_or_chip_smoke():
    """No module of the port, and not chip_smoke.py, names jax or the JAX
    package in an import statement."""
    import ast

    files = [REPO / "chip_smoke.py", *sorted((REPO / "resnet_tpu_torch").rglob("*.py"))]
    assert len(files) > 25
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "resnet_tpu"), (f, m)
