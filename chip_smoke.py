#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch, CUDA and nvcc versions, the card's name and power
     limit (as nvidia-smi prints them);
  2. build: nvcc compiles resnet_tpu_torch/kernels/csrc into a library;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     ResNet-50 serving shapes, TF32 off, within 1e-4 of max|plain|, with
     both times;
  4. serving: a seeded ResNet-50 (random weights, non-trivial BN running
     statistics) is exported, saved, loaded by resnet_tpu_torch.serve and
     asked for batches of 1, 3 and 8 over HTTP; the launch counters must
     show 53 conv, 16 add_relu and 1 matmul launches per forward, and the
     logits must match the plain path (cuDNN/cuBLAS, TF32 off) within 1e-3
     of max|logits|; then the batch-8 forward is timed on both paths.
Then a JSON line of the kernels, the nvidia-smi line, and the final line
{"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no final
line. It needs a CUDA device and the resnet_tpu_torch package beside it; it
never falls back to the CPU and imports nothing of JAX.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
KERNEL_SOURCES = {
    "conv2d": ("resnet_tpu_torch/kernels/csrc/conv.cu",
               "resnet_tpu/kernels/conv.py:42"),
    "add_relu": ("resnet_tpu_torch/kernels/csrc/add_relu.cu",
                 "resnet_tpu/kernels/fused.py:26"),
    "matmul": ("resnet_tpu_torch/kernels/csrc/matmul.cu",
               "resnet_tpu/kernels/matmul.py:26"),
}
# launches of each kernel in one ResNet-50 forward: 1 stem + 16*3 block
# convs + 4 projections; one join per block; the FC
PER_FORWARD = {"conv2d": 53, "add_relu": 16, "matmul": 1}
LOGIT_TOL = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_env(torch, build):
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True, timeout=60).stdout
    try:
        import triton  # noqa: F401  (recorded, never used by the port)
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc_version.strip().splitlines()[-1],
          "ninja": shutil.which("ninja") is not None,
          "triton": triton_version, "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})


def phase_build(build):
    t0 = time.perf_counter()
    lib = build.build()
    seconds = time.perf_counter() - t0
    build.load()
    log = lib.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.is_file() else []
    emit({"phase": "build", "seconds": seconds, "library": str(lib.relative_to(ROOT)),
          "ptxas": ptxas})


def phase_kernels(checks):
    results = {name: [] for name in checks.KERNELS}
    for name, (_, cases) in checks.KERNELS.items():
        for case in cases:
            r = checks.check_case(name, case, seed=SEED)
            emit({"phase": "kernel", **r})
            results[name].append(r)
    return results


def _post(addr, x):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request("POST", "/predict", body=x.tobytes(),
                     headers={"X-Shape": ",".join(map(str, x.shape))})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def phase_serve(torch, checks):
    from resnet_tpu_torch.config import ExecutionConfig, model_config
    from resnet_tpu_torch.export import export_inference, save_inference
    from resnet_tpu_torch.kernels import conv, fused, matmul
    from resnet_tpu_torch.models import init_bn_state, init_params
    from resnet_tpu_torch.serve import bucketed_call, serve

    counters = {"conv2d": conv, "add_relu": fused, "matmul": matmul}
    mcfg = model_config("resnet50")
    kernel_cfg = ExecutionConfig(kernels="pallas", conv_kernels="pallas")
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    for layer in [bn_state["init_bn"], *[b for blk in bn_state["blocks"]
                                          for b in blk.values()]]:
        c = layer["mean"].numel()
        layer["mean"] = (torch.randn(c, generator=gen) * 0.1).to("cuda")
        layer["var"] = (0.5 + 1.5 * torch.rand(c, generator=gen)).to("cuda")
    rng = np.random.default_rng(SEED)
    d = mcfg.input_dim
    # pixel-scale inputs, as mean-subtracted images are: at unit scale the
    # random network's logits barely depend on the image
    batches = [rng.normal(0, 50, (n, d, d, 3)).astype(np.float32) for n in (1, 3, 8)]

    with tempfile.TemporaryDirectory() as tmp:
        path = save_inference(os.path.join(tmp, "resnet50.pt"),
                              export_inference(params, mcfg, bn_state=bn_state,
                                               ecfg=kernel_cfg))
        httpd = serve(path, port=0, device="cuda")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            conn = http.client.HTTPConnection(*httpd.server_address, timeout=60)
            conn.request("GET", "/healthz")
            require(json.loads(conn.getresponse().read()) == {"ok": True},
                    "/healthz did not answer ok")
            conn.close()
            # the main path: counters from 0, three requests, counters read
            for mod in counters.values():
                mod.LAUNCHES = 0
            replies, deltas = [], []
            for x in batches:
                before = {k: m.LAUNCHES for k, m in counters.items()}
                status, out = _post(httpd.server_address, x)
                require(status == 200, f"/predict answered {status}: {out}")
                deltas.append({k: m.LAUNCHES - before[k] for k, m in counters.items()})
                replies.append(out)
            launches = {k: m.LAUNCHES for k, m in counters.items()}
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)
        require(not thread.is_alive(), "server thread did not stop")
    served = httpd.served

    for x, out, delta in zip(batches, replies, deltas):
        require(out["logits_shape"] == [x.shape[0], mcfg.num_classes],
                f"logits_shape {out['logits_shape']} for batch {x.shape[0]}")
        require(delta == PER_FORWARD,
                f"batch {x.shape[0]} moved the counters by {delta}, "
                f"expected {PER_FORWARD}")
    require(launches == {k: v * len(batches) for k, v in PER_FORWARD.items()},
            f"launch counts {launches}")

    plain = export_inference(params, mcfg, bn_state=bn_state,
                             ecfg=ExecutionConfig(), device="cuda")
    compare = []
    for x, out in zip(batches, replies):
        got = bucketed_call(served, x)
        want = plain.call(x).cpu().numpy()
        require(np.isfinite(got).all(), "non-finite kernel-path logits")
        require(out["top1"] == got.argmax(-1).tolist(),
                "HTTP top1 differs from the served model's logits")
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        require(scale > 0 and err <= LOGIT_TOL * scale,
                f"batch {x.shape[0]}: max|kernel - plain| logits = {err} "
                f"> {LOGIT_TOL} * {scale}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > LOGIT_TOL * scale
        agree = got.argmax(-1) == want.argmax(-1)
        require(bool(agree[decided].all()),
                f"batch {x.shape[0]}: top1 differs where the plain top-2 gap "
                f"exceeds {LOGIT_TOL} of max|logits|")
        compare.append({"batch": int(x.shape[0]), "max_abs_err": err,
                        "max_abs_logit": scale, "top1": out["top1"],
                        "top1_agree": int(agree.sum()),
                        "latency_ms": out["latency_ms"]})

    x8 = torch.from_numpy(batches[2]).cuda()
    kernel_ms = checks.median_ms(lambda: served.call(x8), reps=10)
    plain_ms = checks.median_ms(lambda: plain.call(x8), reps=10)
    emit({"phase": "serve", "model": mcfg.name, "requests": len(replies),
          "launches": launches, "per_request": deltas, "compare": compare,
          "batch8_ms": kernel_ms, "batch8_img_s": 8e3 / kernel_ms,
          "plain_batch8_ms": plain_ms, "plain_batch8_img_s": 8e3 / plain_ms})
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke runs on a CUDA card only")
    sys.path.insert(0, str(ROOT))
    import resnet_tpu_torch

    pkg = Path(resnet_tpu_torch.__file__).resolve().parent
    require(pkg == ROOT / "resnet_tpu_torch",
            f"resnet_tpu_torch imported from {pkg}, not from this checkout")
    from resnet_tpu_torch.kernels import build, checks

    checks.fp32_strict()
    phase_env(torch, build)
    phase_build(build)
    results = phase_kernels(checks)
    launches = phase_serve(torch, checks)
    require("jax" not in sys.modules, "jax was imported")

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": ref,
         "launches": launches[name],
         "max_abs_err": max(r["max_abs_err"] for r in results[name]),
         "ms": sum(r["ms"] for r in results[name]),
         "plain_ms": sum(r["plain_ms"] for r in results[name])}
        for name, (src, ref) in KERNEL_SOURCES.items()
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
