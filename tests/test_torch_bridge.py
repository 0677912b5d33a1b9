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
    ours = bridge.flatten(bridge.to_numpy(init_params(gen, tcfg)))
    theirs = bridge.flatten(_np_tree(j_init_params(jax.random.PRNGKey(0), jc)))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size >= 4096 and path.endswith("w"):  # same per-tensor variance
            np.testing.assert_allclose(a.var(), b.var(), rtol=0.15, err_msg=path)
    ours_bn = bridge.flatten(bridge.to_numpy(init_bn_state(tcfg)))
    theirs_bn = bridge.flatten(_np_tree(j_init_bn_state(jc)))
    assert [p for p, _ in ours_bn] == [p for p, _ in theirs_bn]
    for (path, a), (_, b) in zip(ours_bn, theirs_bn):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_numpy_round_trip():
    jc = jcfg.tiny_model_config()
    params = _np_tree(j_init_params(jax.random.PRNGKey(3), jc))
    state = _np_tree(j_init_bn_state(jc))
    tp = bridge.params_from_numpy(params)
    ts = bridge.bn_state_from_numpy(state)
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
    logits, _ = forward(bridge.params_from_numpy(params), x, tiny_model_config(),
                        bn_state=bridge.bn_state_from_numpy(bn_state))
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
