"""The port's serving artifact (resnet_tpu_torch.export.save_inference, a
torch.export program over a symbolic batch, loaded by
resnet_tpu_torch.artifact.load_inference) held against JAX's exported
program (resnet_tpu.export) on the tiny model of tests/test_export.py, and
the custom ops it calls (resnet_tpu_torch.kernels.ops) checked with
torch.library.opcheck."""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import export as jexport
from resnet_tpu.config import tiny_model_config as j_tiny
from resnet_tpu.models import init_bn_state as j_init_bn_state
from resnet_tpu.models import init_params as j_init_params
from resnet_tpu_torch import artifact
from resnet_tpu_torch.bridge import params_from_numpy
from resnet_tpu_torch.config import (
    DataConfig,
    ExecutionConfig,
    OptimizerConfig,
    TrainConfig,
    tiny_model_config,
)
from resnet_tpu_torch.export import (
    export_inference,
    export_inference_from_state,
    export_program,
    export_quantized_inference,
    load_inference,
    save_inference,
)
from resnet_tpu_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32_TOL = 1e-4  # of max|logits|, fp32 at matmul precision 'highest'
INT8_TOL = 1e-2  # of max|logits|: tests/test_torch_quantize.py's LOGIT_TOL
BATCHES = (1, 3, 8)
KERNELS = ExecutionConfig(kernels="pallas", conv_kernels="pallas")


@pytest.fixture(scope="module")
def tiny():
    """tests/test_export.py's model: JAX's init at PRNGKey(1234), running
    statistics moved by 0.1; the port's copy through the bridge."""
    jm = j_tiny()
    jp = j_init_params(jax.random.PRNGKey(1234), jm)
    js = jax.tree.map(lambda a: a + 0.1, j_init_bn_state(jm))
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (jm, jp, js, tiny_model_config(), params_from_numpy(host(jp), "cpu"),
            params_from_numpy(host(js), "cpu"))


def _images(seed, n, d=16):
    return np.random.default_rng(seed).normal(0, 50, (n, d, d, 3)).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("ecfg", [ExecutionConfig(), KERNELS], ids=["xla", "kernels"])
def test_artifact_matches_jax_export_at_every_batch(tiny, tmp_path, ecfg):
    """One file each side, batches 1, 3 and 8 from it: the port's loaded
    program against JAX's loaded StableHLO within 1e-4 of max."""
    jm, jp, js, mcfg, params, bn_state = tiny
    jpath = jexport.save_inference(str(tmp_path / "m.stablehlo"),
                                   jexport.export_inference(jp, jm, bn_state=js))
    path = save_inference(str(tmp_path / "m.pt2"),
                          export_inference(params, mcfg, bn_state=bn_state, ecfg=ecfg))
    want, got = jexport.load_inference(jpath), load_inference(path, device="cpu")
    for n in BATCHES:
        x = _images(n, n)
        _close(got.call(x), want.call(jnp.asarray(x)), FP32_TOL)


def test_int8_artifact_matches_jax_quantized_export(tiny, tmp_path):
    """Both sides calibrate on the same images: the port's int8 artifact
    against JAX's export_quantized_inference within 1e-2 of max, and the
    top-1 equal wherever JAX's top-2 gap passes that tolerance."""
    jm, jp, js, mcfg, params, bn_state = tiny
    calib = _images(0, 8)
    jprog = jexport.export_quantized_inference(jp, jm, jnp.asarray(calib), bn_state=js)
    path = save_inference(str(tmp_path / "q.pt2"),
                          export_quantized_inference(params, mcfg, calib, bn_state=bn_state))
    got = load_inference(path, device="cpu")
    assert got.kind == "int8"
    for n in BATCHES:
        x = _images(10 + n, n)
        want = np.asarray(jprog.call(jnp.asarray(x)))
        out = got.call(x).numpy()
        _close(out, want, INT8_TOL)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > INT8_TOL * np.abs(want).max()
        assert (out.argmax(-1) == want.argmax(-1))[decided].all()


def _custom_calls(program):
    nodes = [n for n in program.graph.nodes if n.op == "call_function"]
    return [str(n.target).split(".")[1] for n in nodes
            if str(n.target).startswith(f"{ops.NAMESPACE}.")]


@pytest.mark.parametrize("over", [{}, dict(bottleneck=False, expansion=1),
                                  dict(groups=2, width_multiplier=2.0)],
                         ids=["bottleneck", "basic", "grouped"])
def test_kernel_exports_hold_one_op_a_conv(over):
    """Under kernels='pallas', conv_kernels='pallas' the program calls
    resnet_tpu_torch::conv2d_nhwc once a conv (a grouped 3x3 is the plain
    conv), add_relu once a block and matmul once; under 'xla' no custom op
    at all."""
    from resnet_tpu_torch.bridge import flatten
    from resnet_tpu_torch.models import init_bn_state, init_params

    mcfg = tiny_model_config(**over)
    params = init_params(torch.Generator().manual_seed(1), mcfg, device="cpu")
    bn_state = init_bn_state(mcfg, device="cpu")
    convs = sum(t.dim() == 4 and not (mcfg.groups > 1 and "/spatial/" in path)
                for path, t in flatten(params))
    calls = _custom_calls(export_program(export_inference(params, mcfg, bn_state=bn_state,
                                                          ecfg=KERNELS)))
    assert sorted(calls) == sorted(["conv2d_nhwc"] * convs + ["add_relu"] * mcfg.num_blocks
                                   + ["matmul"])
    plain = export_program(export_inference(params, mcfg, bn_state=bn_state))
    assert _custom_calls(plain) == []


@pytest.mark.parametrize("kind", ["fp", "bf16", "nchw", "int8", "pinned"])
def test_loaded_program_equals_eager_model_bit_for_bit(tiny, tmp_path, kind):
    """On the CPU the loaded program gives the eager model's logits bit for
    bit at batches 1, 3 and 8: fp32 kernels, bf16 weights, NCHW bf16
    compute, int8; a pinned batch serves that batch and refuses another."""
    _, _, _, mcfg, params, bn_state = tiny
    if kind == "int8":
        model = export_quantized_inference(params, mcfg, _images(0, 8), bn_state=bn_state)
    elif kind == "nchw":
        model = export_inference(params, mcfg, bn_state=bn_state, ecfg=ExecutionConfig(
            layout="NCHW", compute_dtype="bfloat16", kernels="pallas", conv_kernels="pallas"))
    else:
        model = export_inference(params, mcfg, bn_state=bn_state, ecfg=KERNELS,
                                 weights_dtype="bfloat16" if kind == "bf16" else None,
                                 batch=3 if kind == "pinned" else None)
    served = load_inference(save_inference(str(tmp_path / f"{kind}.pt2"), model), device="cpu")
    assert served.image_dims == model.image_dims and served.device == torch.device("cpu")
    assert served.meta["batch"] == model.batch and served.kind == model.meta()["kind"]
    for n in (3,) if kind == "pinned" else BATCHES:
        x = _images(20 + n, n)
        if kind == "nchw":
            x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
        want = model.call(x)
        assert torch.equal(served.call(x), want) and torch.isfinite(want).all()
    if kind == "pinned":
        with pytest.raises(ValueError, match=r"\(3, 16, 16, 3\)"):
            served.call(_images(1, 2))


def test_load_takes_bytes_and_refuses_another_device(tiny, tmp_path):
    """The loader takes a path or the file's bytes (as JAX's); an artifact
    exported on the CPU refuses to run on the card with a ValueError that
    says so, before anything touches a card; a shape it does not take is a
    ValueError."""
    _, _, _, mcfg, params, bn_state = tiny
    model = export_inference(params, mcfg, bn_state=bn_state)
    path = save_inference(str(tmp_path / "m.pt2"), model)
    x = _images(2, 2)
    with open(path, "rb") as f:
        again = load_inference(f.read(), device="cpu")
    assert torch.equal(again.call(x), model.call(x))
    with pytest.raises(ValueError, match="exported on cpu"):
        load_inference(path, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        again.call(np.zeros((1, 8, 8, 3), np.float32))
    assert not any(name.endswith(".tmp-" + str(os.getpid())) for name in os.listdir(tmp_path))


def test_artifact_runs_without_the_model_code(tiny, tmp_path):
    """A process in which resnet_tpu_torch.models, .quantize and .train
    cannot be imported loads the fp and the int8 artifacts and gives the
    eager models' logits bit for bit."""
    _, _, _, mcfg, params, bn_state = tiny
    x = _images(3, 3)
    runs = []
    for name, model in (
            ("fp", export_inference(params, mcfg, bn_state=bn_state, ecfg=KERNELS)),
            ("int8", export_quantized_inference(params, mcfg, _images(0, 8),
                                                bn_state=bn_state))):
        path = save_inference(str(tmp_path / f"{name}.pt2"), model)
        runs.append((path, model.call(x).numpy()))
    np.save(tmp_path / "x.npy", x)
    script = (
        "import json, sys\n"
        "import numpy as np\n"
        "for name in ('resnet_tpu_torch.models', 'resnet_tpu_torch.quantize',"
        " 'resnet_tpu_torch.train'):\n"
        "    sys.modules[name] = None\n"
        "from resnet_tpu_torch.artifact import load_inference\n"
        "x = np.load(sys.argv[1])\n"
        "for path in sys.argv[2:]:\n"
        "    np.save(path + '.npy', load_inference(path, device='cpu').call(x).numpy())\n"
        "print(json.dumps(sorted(n for n, m in sys.modules.items() if m is not None and"
        " n.startswith(('resnet_tpu_torch.models', 'resnet_tpu_torch.quantize',"
        " 'resnet_tpu_torch.train', 'jax')))))\n")
    done = subprocess.run([sys.executable, "-c", script, str(tmp_path / "x.npy"),
                           *(p for p, _ in runs)], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.splitlines()[-1]) == []
    for path, want in runs:
        assert np.load(path + ".npy").tobytes() == want.tobytes()


def _weight_bytes(path):
    """The bytes of the archive's weights (the program's graph, which the
    tiny model's weights do not outweigh, aside)."""
    with zipfile.ZipFile(path) as z:
        return sum(i.file_size for i in z.infolist() if "/data/weights/" in i.filename)


def test_bf16_weights_export_halves_artifact(tiny, tmp_path):
    """weights_dtype='bfloat16' roughly halves the weights the file holds
    (JAX's test_bf16_weights_export_halves_artifact, its baked-constant
    payload) while the logits stay close to the fp32 artifact's."""
    _, _, _, mcfg, params, bn_state = tiny
    paths = {dt: save_inference(str(tmp_path / f"{dt}.pt2"), export_inference(
        params, mcfg, bn_state=bn_state, weights_dtype=dt)) for dt in ("float32", "bfloat16")}
    sizes = {dt: _weight_bytes(p) for dt, p in paths.items()}
    assert 0 < sizes["bfloat16"] < 0.65 * sizes["float32"], sizes
    assert os.path.getsize(paths["bfloat16"]) < os.path.getsize(paths["float32"])
    x = _images(4, 2)
    a, b = (load_inference(paths[dt], device="cpu").call(x).numpy()
            for dt in ("float32", "bfloat16"))
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.3)


def test_export_from_train_state_uses_running_stats(tmp_path):
    """A train state's running statistics are baked in: moving them moves
    the artifact's logits (JAX's test_export_from_train_state_uses_running_stats);
    its configs are the train config's."""
    from resnet_tpu_torch.bridge import tree_map
    from resnet_tpu_torch.train import init_train_state

    cfg = TrainConfig(model=tiny_model_config(), execution=ExecutionConfig(),
                      optimizer=OptimizerConfig(), data=DataConfig(batch_size=4, synthetic=True))
    state = init_train_state(cfg, device="cpu")
    x = _images(5, 2)
    base = load_inference(save_inference(str(tmp_path / "a.pt2"), export_inference_from_state(
        state, cfg, batch=2)), device="cpu")
    assert base.meta["execution_config"] == json.loads(json.dumps(
        dataclasses.asdict(cfg.execution)))
    bumped = state._replace(bn_state=tree_map(lambda t: t + 0.25, state.bn_state))
    shifted = load_inference(save_inference(str(tmp_path / "b.pt2"), export_inference_from_state(
        bumped, cfg, batch=2)), device="cpu")
    assert not np.allclose(base.call(x).numpy(), shifted.call(x).numpy())


def _op_cases():
    """Sample inputs of each custom op at small shapes (CPU tensors)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    return [
        ("conv2d_nhwc", ops.conv2d_nhwc, (r(2, 8, 8, 4), r(3, 3, 4, 8), 2)),
        ("conv2d_nhwc bf16", ops.conv2d_nhwc,
         (r(2, 8, 8, 4).bfloat16(), r(1, 1, 4, 8).bfloat16(), 1)),
        ("add_relu", ops.add_relu, (r(2, 4, 4, 8), r(2, 4, 4, 8))),
        ("matmul", ops.matmul, (r(3, 16), r(16, 10))),
        ("quant_act", ops.quant_act, (r(2, 4, 4, 8) * 50, 0.25)),
        ("qconv", ops.qconv, (i8(2, 8, 8, 4), i8(3, 3, 4, 8), r(8).abs() * 1e-3, r(8), None,
                              1, 1, True, 6.0, torch.bfloat16)),
        ("qconv fc", ops.qconv, (i8(3, 1, 1, 16), i8(1, 1, 16, 10), r(10).abs() * 1e-3, None,
                                 None, 1, 1, False, None, torch.float32)),
        ("qconv grouped", ops.qconv, (i8(2, 8, 8, 8), i8(3, 3, 4, 8), r(8).abs() * 1e-3, r(8),
                                      None, 2, 2, True, None, torch.bfloat16)),
    ]


@pytest.mark.parametrize("name,op,args", _op_cases(), ids=[c[0] for c in _op_cases()])
def test_ops_pass_opcheck(name, op, args):
    """torch.library.opcheck on each op: its schema, its fake against its
    CPU implementation, and its registration under aot_autograd with
    dynamic shapes."""
    torch.library.opcheck(op, args)


def test_each_op_has_cpu_cuda_and_fake_implementations():
    for name in ops.SCHEMAS:
        qualified = f"{ops.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), (name, key)
    with pytest.raises(ValueError, match="meta"):  # the fake stands for Meta and refuses it
        ops.add_relu(torch.zeros(4, device="meta"), torch.zeros(4, device="meta"))


def test_ops_dispatch_the_plain_version_on_the_cpu():
    """On CPU tensors each op gives its kernel's plain version exactly."""
    from resnet_tpu_torch.kernels import conv, fused, matmul, quant

    for name, op, args in _op_cases():
        plain = {"conv2d_nhwc": conv.conv2d_reference, "add_relu": fused.add_relu_reference,
                 "matmul": matmul.matmul_reference, "quant_act": quant.quant_act_reference,
                 }.get(name.split()[0])
        if plain is None:
            xq, w, dq, bias, _, stride, groups, relu, cap, out_dtype = args
            want = quant.qconv_reference(xq, w, dq, bias, stride=stride, groups=groups,
                                         relu=relu, cap=cap, out_dtype=out_dtype)
        else:
            want = plain(*args)
        assert torch.equal(op(*args), want), name


def test_serve_loads_through_the_artifact():
    """The server imports its loader from artifact.py, not from export.py."""
    from resnet_tpu_torch import serve

    assert serve.load_inference is artifact.load_inference
