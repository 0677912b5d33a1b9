"""HTTP serving through resnet_tpu_torch.serve: /healthz and /predict over a
real socket, logits equal to a direct ``.call``, the bucketing cap, and
concurrent requests (the counterpart of tests/test_serve.py)."""

import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from resnet_tpu_torch import serve as serve_mod
from resnet_tpu_torch.config import ExecutionConfig, tiny_model_config
from resnet_tpu_torch.export import export_inference, load_inference, save_inference
from resnet_tpu_torch.models import forward, init_bn_state, init_params


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    mcfg = tiny_model_config()
    gen = torch.Generator().manual_seed(1234)
    params = init_params(gen, mcfg, device="cpu")
    bn_state = init_bn_state(mcfg, device="cpu")
    for blk in [bn_state["init_bn"], *[b for bb in bn_state["blocks"] for b in bb.values()]]:
        blk["mean"] += 0.1
        blk["var"] += 0.1
    ecfg = ExecutionConfig(kernels="pallas", conv_kernels="pallas")
    model = export_inference(params, mcfg, bn_state=bn_state, ecfg=ecfg)
    path = save_inference(str(tmp_path_factory.mktemp("srv") / "m.pt"), model)
    httpd = serve_mod.serve(path, port=0, device="cpu")  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address, model, (params, bn_state, mcfg, ecfg)
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def _post(addr, x, shape=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", "/predict", body=x.tobytes(),
                 headers={"X-Shape": ",".join(map(str, shape or x.shape))})
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_export_round_trip_and_forward(server, rng):
    _, model, (params, bn_state, mcfg, ecfg) = server
    x = rng.normal(0, 50, (3, 16, 16, 3)).astype(np.float32)
    want, _ = forward(params, torch.from_numpy(x), mcfg, ecfg, train=False, bn_state=bn_state)
    torch.testing.assert_close(model.call(x), want, rtol=0, atol=0)
    assert model.mcfg == mcfg and model.ecfg == ecfg
    with pytest.raises(ValueError, match="shape"):
        model.call(np.zeros((1, 8, 8, 3), np.float32))


def test_healthz_and_predict(server, rng):
    addr, model, (_, _, mcfg, _) = server
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", "/healthz")
    assert json.loads(conn.getresponse().read()) == {"ok": True}

    d = mcfg.input_dim
    x = rng.normal(0, 50, (3, d, d, 3)).astype(np.float32)
    status, out = _post(addr, x)
    assert status == 200
    assert out["logits_shape"] == [3, mcfg.num_classes]
    assert out["top1"] == model.call(x).argmax(-1).tolist()
    assert out["latency_ms"] >= 0


@pytest.mark.parametrize("body,shape", [(b"notatensor", "garbage"),
                                        (np.zeros((1, 8, 8, 3), np.float32).tobytes(),
                                         "1,8,8,3")])
def test_predict_rejects_malformed(server, body, shape):
    addr = server[0]
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("POST", "/predict", body=body, headers={"X-Shape": shape})
    assert conn.getresponse().status == 400


def test_bucketed_call_matches_direct(server, rng):
    """Power-of-two padding and oversize chunking are invisible in the
    logits for every batch-size class (sub-bucket, exact, oversize)."""
    _, model, (_, _, mcfg, _) = server
    d = mcfg.input_dim
    for n in (1, 3, 4, 7, 9):
        x = rng.normal(0, 50, (n, d, d, 3)).astype(np.float32)
        got = serve_mod.bucketed_call(model, x, max_bucket=4)
        want = model.call(x).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert got.shape == (n, mcfg.num_classes)


def test_bucketing_caps_the_batch_shapes(server, rng):
    """The model only ever sees power-of-two batches up to the cap, and a
    non-power-of-two cap is itself the largest bucket."""
    _, model, (_, _, mcfg, _) = server
    seen = []

    class Spy:
        def call(self, x):
            seen.append(x.shape[0])
            return model.call(x)

    d = mcfg.input_dim
    for n in (1, 3, 5, 13):
        serve_mod.bucketed_call(Spy(), rng.normal(0, 50, (n, d, d, 3)).astype(np.float32),
                                max_bucket=6)
    assert seen == [1, 4, 6, 6, 6, 1]


def test_concurrent_load(server, rng):
    """8 client threads x 3 requests with mixed batch sizes: every request
    gets a 200 with the right top1."""
    addr, model, (_, _, mcfg, _) = server
    d = mcfg.input_dim
    xs = {n: rng.normal(0, 50, (n, d, d, 3)).astype(np.float32) for n in (1, 2, 5)}
    wants = {n: model.call(x).argmax(-1).tolist() for n, x in xs.items()}
    errors = []

    def client(tid):
        try:
            for j in range(3):
                n = [1, 2, 5][(tid + j) % 3]
                status, out = _post(addr, xs[n])
                assert status == 200, out
                assert out["top1"] == wants[n], (n, out)
        except Exception as e:  # collected and asserted below
            errors.append(f"client {tid}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def _as_json(cfg):
    """A config as the artifact's record holds it: a plain dict."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_load_inference_restores_configs(server, tmp_path):
    """The loaded artifact is a program, not the model: its record holds
    the kind and the model and execution configs as plain dicts."""
    _, model, (_, _, mcfg, ecfg) = server
    path = save_inference(str(tmp_path / "again.pt"), model)
    again = load_inference(path, device="cpu")
    assert again.kind == "fp" and again.meta["model_config"] == _as_json(mcfg)
    assert again.meta["execution_config"] == _as_json(ecfg)
    x = np.ones((2, 16, 16, 3), np.float32)
    torch.testing.assert_close(again.call(x), model.call(x), rtol=0, atol=0)


def test_nchw_model_takes_nchw_bodies(tmp_path, rng):
    """A model saved with layout 'NCHW' (and bf16 compute) serves (N, 3, d, d)
    bodies: with X-Shape, and without it (whole images of the saved
    layout); an NHWC-shaped body is a 400."""
    mcfg = tiny_model_config()
    params = init_params(torch.Generator().manual_seed(3), mcfg, device="cpu")
    ecfg = ExecutionConfig(layout="NCHW", compute_dtype="bfloat16", kernels="pallas",
                           conv_kernels="pallas")
    model = export_inference(params, mcfg, bn_state=init_bn_state(mcfg, device="cpu"),
                             ecfg=ecfg)
    httpd = serve_mod.serve(save_inference(str(tmp_path / "nchw.pt"), model), port=0,
                            device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        assert httpd.served.image_dims == (3, 16, 16)
        x = rng.normal(0, 50, (3, 3, 16, 16)).astype(np.float32)
        want = model.call(x).argmax(-1).tolist()
        status, out = _post(httpd.server_address, x)
        assert status == 200 and out["top1"] == want and out["logits_shape"] == [3, 8]
        conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
        conn.request("POST", "/predict", body=x.tobytes())
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["top1"] == want
        status, _ = _post(httpd.server_address, np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
        assert status == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


# (label, model overrides, execution, export kind): ResNeXt (groups 2) in
# fp32, bf16 and int8, and the 7x7 stem with s2d in fp32 and bf16
SAVED = [
    ("resnext fp32", dict(groups=2, width_multiplier=2.0), dict(kernels="pallas",
                                                               conv_kernels="pallas"), "fp"),
    ("resnext bf16", dict(groups=2, width_multiplier=2.0),
     dict(compute_dtype="bfloat16", kernels="pallas", conv_kernels="pallas"), "bf16"),
    ("resnext int8", dict(groups=2, width_multiplier=2.0), {}, "int8"),
    ("s2d fp32", dict(init_kernel=7), dict(space_to_depth=True, conv_kernels="pallas"), "fp"),
    ("s2d bf16", dict(init_kernel=7), dict(space_to_depth=True, compute_dtype="bfloat16"),
     "bf16"),
]


@pytest.mark.parametrize("label,over,execution,kind", SAVED, ids=[c[0] for c in SAVED])
def test_resnext_and_s2d_models_save_load_and_serve(tmp_path, rng, label, over, execution,
                                                     kind):
    """A ResNeXt or s2d model exported (fp32, bf16 weights, or W8A8), saved
    and loaded keeps its configs, gives the exported model's logits bit for
    bit, and serves them over HTTP; with s2d the saved model's logits are
    the eval forward's with s2d (not the 7x7 stem's)."""
    from resnet_tpu_torch.export import export_quantized_inference

    mcfg = tiny_model_config(**over)
    params = init_params(torch.Generator().manual_seed(5), mcfg, device="cpu")
    bn_state = init_bn_state(mcfg, device="cpu")
    ecfg = ExecutionConfig(**execution)
    x = rng.normal(0, 50, (3, 16, 16, 3)).astype(np.float32)
    if kind == "int8":
        model = export_quantized_inference(params, mcfg, x, bn_state=bn_state)
    else:
        model = export_inference(params, mcfg, bn_state=bn_state, ecfg=ecfg,
                                 weights_dtype="bfloat16" if kind == "bf16" else None)
    path = save_inference(str(tmp_path / f"{label.replace(' ', '_')}.pt"), model)
    again = load_inference(path, device="cpu")
    assert again.meta["model_config"] == _as_json(mcfg)
    assert again.kind == ("int8" if kind == "int8" else "fp")
    want = model.call(x)
    assert torch.equal(again.call(x), want) and torch.isfinite(want).all()
    if kind == "fp":
        assert again.meta["execution_config"] == _as_json(ecfg)
        eval_logits, _ = forward(params, torch.from_numpy(x), mcfg, ecfg, train=False,
                                 bn_state=bn_state)
        assert torch.equal(want, eval_logits)
        if ecfg.space_to_depth:
            off, _ = forward(params, torch.from_numpy(x), mcfg, ExecutionConfig(
                conv_kernels=ecfg.conv_kernels), train=False, bn_state=bn_state)
            assert not torch.equal(want, off)
    httpd = serve_mod.serve(path, port=0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        status, out = _post(httpd.server_address, x)
        assert status == 200 and out["top1"] == want.argmax(-1).tolist()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
