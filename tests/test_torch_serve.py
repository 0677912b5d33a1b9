"""HTTP serving through resnet_tpu_torch.serve: /healthz and /predict over a
real socket, logits equal to a direct ``.call``, the bucketing cap, and
concurrent requests (the counterpart of tests/test_serve.py)."""

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


def test_load_inference_restores_configs(server, tmp_path):
    _, model, (_, _, mcfg, ecfg) = server
    path = save_inference(str(tmp_path / "again.pt"), model)
    again = load_inference(path, device="cpu")
    assert again.mcfg == mcfg and again.ecfg == ecfg
    x = np.ones((2, 16, 16, 3), np.float32)
    torch.testing.assert_close(again.call(x), model.call(x), rtol=0, atol=0)
