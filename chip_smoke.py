#!/usr/bin/env python3
"""Smoke test of the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels conv2d,matmul_bwd   (phases 1-3 only)

Phases, each printing one JSON line:
  1. environment: torch, CUDA and nvcc versions, the card's name and power
     limit (as nvidia-smi prints them);
  2. build: nvcc compiles resnet_tpu_torch/kernels/csrc into a library;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     ResNet-50 serving and training shapes, TF32 off, within 1e-4 of
     max|plain| (the fused conv's halo case bit for bit; the split-K GEMMs
     of the conv forward, dx and dW, the fused conv and the whole-block
     kernel, the FC backward and the BN statistics run twice and held to
     the same bits), with its time, the plain version's, a library call's
     where one computes the same function, the device time of the kernel
     and of the library call (torch.profiler, with its split by kernel
     name), the host time per call (host_us: 200 calls enqueued back to
     back, checks.host_us), the least time the card could take, and for the
     conv forward, the whole-block kernel and
     the FC backward the launch plan (tiles and K splits; da and db
     blocks); then the whole-block kernel's weight split (split_tf32) at
     the shapes of K10's twelve weights, bit for bit against its plain
     version;
  4. serving: a seeded ResNet-50 (random weights, non-trivial BN running
     statistics) is exported, saved, loaded by resnet_tpu_torch.serve and
     asked for batches of 1, 3 and 8 over HTTP; the launch counters must
     show 53 conv, 16 add_relu and 1 matmul launches per forward, and the
     logits must match the plain path (cuDNN/cuBLAS, TF32 off) within 1e-3
     of max|logits|; then the batch-8 forward is timed on both paths;
  5. train: the reference "resnet" variant (ResNet-50, 224^2, batch 32, Adam
     lr 1e-4) with every hand kernel on (conv, BN statistics, join, FC,
     fused Adam): 5 steps on one synthetic batch, the counters read after
     each step (53 conv, 52 dx, 53 dW, 53 moments, 16 add_relu, 16 masks,
     1 + 1 matmul, 1 adam), the loss after the last update below the first;
     then one step from the same state on the kernel path and on the plain
     path (cuDNN/cuBLAS and torch ops, per-tensor Adam) compared leaf by
     leaf, once with batch statistics and once with BN frozen at the initial
     running statistics (the well-conditioned check, Adam's updates also
     element by element); step times of both paths in turns (plain, kernel,
     kernel, plain) with host_step_ms (the host clock from a step's start
     to train_step's return, before the synchronize, the median per path
     over the timed steps; likewise in phases 6 and 7), peak memory, and a
     torch.profiler breakdown of one kernel-path step;
  6. fused train: the same variant under the fused engine
     (kernels='fused', fused Adam): 5 steps on the batch, the counters read
     after each (52 fused_conv, 16 fused_join, 1 bias_act, 1 moments,
     1 adam, and nothing else), the loss after the last update below the
     first; one step from one state against the plain standard path
     (kernels='xla', per-tensor Adam): summed loss, training-forward logits,
     every layer's batch mean and var, the running statistics and every
     gradient leaf (the rule of phase 5). The fused engine normalizes with
     the batch's statistics only (bn_mode='batch'), so phase 5's frozen-BN
     tight check has no counterpart here. Then one step each of 'hybrid'
     (16 fused_join, 1 bias_act, 1 moments, 1 adam: every conv site on the
     torch-ops chain) and 'fusedxla' (1 adam: no hand kernel but Adam), each
     loss within 1e-4 of the plain path's; step times in turns (plain,
     fusedxla, fused, fused, fusedxla, plain), peak memory of one step of
     each, and a torch.profiler breakdown of one fused step;
  7. blockfused train: the same variant under the whole-block engine
     (kernels='blockfused', fused Adam): 5 steps on the batch, the counters
     read after each (12 block_fused, one per stride-1 identity block, and
     1 adam, nothing else: the stem, the 4 projection blocks and the FC are
     plain), the loss after the last update below the first; one step
     against the plain standard path by the rules of phase 6; one step with
     conv_kernels='pallas' (12 block_fused, 17 conv2d, 16 conv2d_dx, 17
     conv2d_dw, 1 adam), its loss within 1e-4 of the plain path's; step
     times in turns (plain, blockfused, fused, fused, blockfused, plain),
     peak memory of one step of each, a torch.profiler breakdown of one
     blockfused step;
  8. batch_norm_act: the public BN(+ReLU) entry point of the kernels package
     (no model path calls it), forward and backward at the stem's shape with
     and without ReLU: 1 moments, 1 bias_act (the apply) and 1 bn_bwd launch
     per call, its outputs and gradients within 1e-4 of the plain torch ops;
  9. remat train: the reference "clean" variant (ResNet-50, 224^2, batch
     224, Adam lr 1e-4, kernels='pallas', remat='block') with
     conv_kernels='pallas' and fused Adam: 5 steps on one synthetic batch,
     the counters read after each (105 conv: 53 and the 52 the backward
     reruns, 52 dx, 53 dW, 105 moments, 32 add_relu, 16 masks, 1 + 1
     matmul, 1 adam), the loss after the last update below the first; then
     from one state one step each of remat 'block', 'stage' (the same
     counts) and 'elementwise' (the standard step's counts but 32 add_relu:
     the joins rerun, the convs and statistics are kept) against the
     'none' step: counters, summed loss and batch and running statistics
     within 1e-6 of max|.|, every gradient leaf within 1e-5 of its max
     (the count of leaves equal bit for bit printed), parameters within
     2 lr + 1e-6, the step's peak memory below the 'none' step's; the same
     for kernels='blockfused' under block remat (24 block_fused, 1 adam)
     and for the "lowmem" variant (plain path, block remat) at its batch of
     192, whose cuDNN backward adds in no fixed order: there a gradient
     leaf passes within 1e-5 of its max or within 4 times the no-remat
     path's own change between two runs; one ghost-BN step at batch 32 (bn_stats_batch=16: no K4 launch)
     and ghost BN's closed-form VJP against autograd of the sliced moments
     within 1e-5 of max at the stem's and stage 1's shapes; step times of
     'none' and 'block' in turns (none, block, block, none) with
     host_step_ms, peak memory and device busy time of one step each.
Phase 3 includes the clean variant's batch-224 shapes of K1 (the stem's
forward, dx and dW), K2, K2b and K4 (the stem and stage 1).
Then a JSON line of the kernels (launches: the counts of the main paths of
phases 4 to 9 together, every kernel launched on at least one of them; ms,
host_us, plain_ms, bound_ms, library_ms and the device times summed over
each kernel's phase-3 cases),
the nvidia-smi line, and the final line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no final
line. It needs a CUDA device and the resnet_tpu_torch package beside it; it
never falls back to the CPU and imports nothing of JAX.

With --kernels NAMES (comma-separated names of kernels.checks.KERNELS) it
runs phases 1-3 for those kernels only, without the launch plans and the
weight split, and prints no final line: copied with kernels/checks.py into another tree of
the package, it times that tree's kernels on this tree's cases.
"""

from __future__ import annotations

import argparse
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
CSRC = "resnet_tpu_torch/kernels/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "conv2d": (CSRC + "conv.cu", "resnet_tpu/kernels/conv.py:42"),
    # dx is the same Pallas conv kernel on the dilated gradient (conv.py:150)
    "conv2d_dx": (CSRC + "conv.cu", "resnet_tpu/kernels/conv.py:42"),
    # dW is the Pallas matmul per tap (conv.py:172-196)
    "conv2d_dw": (CSRC + "conv.cu", "resnet_tpu/kernels/matmul.py:26"),
    "add_relu": (CSRC + "add_relu.cu", "resnet_tpu/kernels/fused.py:26"),
    "add_relu_mask": (CSRC + "add_relu.cu", "resnet_tpu/kernels/fused.py:32"),
    "matmul": (CSRC + "matmul.cu", "resnet_tpu/kernels/matmul.py:26"),
    "matmul_bwd": (CSRC + "matmul.cu", "resnet_tpu/kernels/matmul.py:26"),
    "moments": (CSRC + "moments.cu", "resnet_tpu/kernels/bn.py:72"),
    "adam": (CSRC + "adam.cu", "resnet_tpu/kernels/adam.py:25"),
    "fused_conv": (CSRC + "fused_conv.cu", "resnet_tpu/kernels/fused_conv.py:45"),
    "fused_join": (CSRC + "fused_conv.cu", "resnet_tpu/kernels/fused_conv.py:505"),
    # K5, the BN apply, reached through bias_act (kernels/fused.py:90)
    "bias_act": (CSRC + "bn.cu", "resnet_tpu/kernels/bn.py:134"),
    # K6, the reduce kernel and the dx kernel (bn.py:188) of _bn_bwd_impl
    "bn_bwd": (CSRC + "bn.cu", "resnet_tpu/kernels/bn.py:166"),
    "block_fused": (CSRC + "block_fused.cu", "resnet_tpu/kernels/block_fused.py:60"),
}
# launches of each kernel in one ResNet-50 forward: 1 stem + 16*3 block
# convs + 4 projections; one join per block; the FC
PER_FORWARD = {"conv2d": 53, "add_relu": 16, "matmul": 1}
# ... and in one training step: no dx for the stem (the images need none);
# one BN per conv; the FC's da and db in one launch; one Adam launch over
# all tensors
PER_STEP = {"conv2d": 53, "conv2d_dx": 52, "conv2d_dw": 53, "moments": 53,
            "add_relu": 16, "add_relu_mask": 16, "matmul": 1, "matmul_bwd": 1,
            "adam": 1}
# ... and in one fused-engine step: every block conv (16 * 3 + 4
# projections) and every join; the stem's statistics and its BN apply; the
# stem conv, the FC and the gradient convs are plain
FUSED_PER_STEP = {"fused_conv": 52, "fused_join": 16, "bias_act": 1, "moments": 1,
                  "adam": 1}
# 'hybrid' with the empty site table: every conv site on the torch-ops chain
HYBRID_PER_STEP = {"fused_join": 16, "bias_act": 1, "moments": 1, "adam": 1}
FUSEDXLA_PER_STEP = {"adam": 1}
# ... and in one whole-block-engine step: the 12 stride-1 identity blocks;
# the stem, the 4 projection blocks and the FC are plain
BLOCKFUSED_PER_STEP = {"block_fused": 12, "adam": 1}
# ... and with conv_kernels='pallas': K1 for the stem and the projection
# blocks' 16 convs (the stem takes no dx)
BLOCKFUSED_PALLAS_PER_STEP = {"block_fused": 12, "conv2d": 17, "conv2d_dx": 16,
                              "conv2d_dw": 17, "adam": 1}
# one batch_norm_act forward and backward
BN_ENTRY_PER_CALL = {"moments": 1, "bias_act": 1, "bn_bwd": 1}
# ... and in one step of the clean variant (batch 224) with every hand
# kernel under remat='block' or 'stage': the backward reruns the 16 blocks'
# 52 convs, their 52 BN statistics and 16 joins; the stem and the FC run once
REMAT_PER_STEP = {"conv2d": 53 + 52, "conv2d_dx": 52, "conv2d_dw": 53, "moments": 53 + 52,
                  "add_relu": 16 + 16, "add_relu_mask": 16, "matmul": 1, "matmul_bwd": 1,
                  "adam": 1}
# ... under remat='elementwise': the conv outputs and the statistics are
# kept, the BN applies and the joins rerun (models/resnet.py), so only the
# 16 joins launch again
ELEMENTWISE_PER_STEP = dict(PER_STEP, add_relu=16 + 16)
# ... the whole-block engine under remat='block': its 12 blocks rerun
BLOCKFUSED_REMAT_PER_STEP = {"block_fused": 12 + 12, "adam": 1}
# ... ghost BN: its statistics are plain torch ops, K4 is never reached
GHOST_PER_STEP = {k: v for k, v in PER_STEP.items() if k != "moments"}
# a remat step against the no-remat step from one state: loss, batch and
# running statistics within REMAT_STAT_TOL of max|.|, each gradient leaf
# within REMAT_GRAD_TOL of its max, the parameters within 2 lr + 1e-6
REMAT_STAT_TOL = 1e-6
REMAT_GRAD_TOL = 1e-5
# ghost BN's closed-form VJP against autograd of the sliced moments
GHOST_TOL = 1e-5
GHOST_BATCH, GHOST_STATS = 32, 16
LOGIT_TOL = 1e-3
# kernel path against the plain path after one training step
LOSS_TOL = 1e-4  # relative
# A gradient leaf passes within GRAD_TOL of its max|g|, or within GRAD_SENS
# times the plain path's own change when the images are scaled by
# 1 +- 2^-20. The ResNet-50 gradient is that sensitive: with batch-statistics
# BN this ~8-ulp change alone moves most leaves by 4-15% of their max, at
# random init, after the main path's steps, and with BN frozen at the batch's
# own statistics alike (the phase prints each). With BN frozen at the
# initial running statistics (mean 0, var 1) it moves them by at most ~2e-3:
# that step is the tight check, the kernel path within GRAD_SENS times that.
GRAD_TOL = 1e-3
GRAD_SENS = 4.0
IMAGE_NUDGE = 2.0 ** -20
# Adam's updates p - p0 of the frozen step: at most UPDATE_SHARE of all
# elements may differ by more than lr / 100 + 4 ulp of p0 (a gradient within
# its error of 0 can flip the sign of its update, 2 lr; a kernel that never
# wrote p would miss nearly every element)
UPDATE_SHARE = 1e-2
STAT_TOL = 1e-4  # of max(1, |running statistic|)
# batch_norm_act against plain torch ops, per output, of its max|plain|
ENTRY_TOL = 1e-4
TRAIN_STEPS = 5


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
    return smi


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


class Counters:
    """The launch counters of the kernel modules, by kernel name."""

    def __init__(self, checks):
        self.where = {name: (mod, attr) for name, (mod, attr, *_) in checks.KERNELS.items()}

    def zero(self):
        for mod, attr in self.where.values():
            setattr(mod, attr, 0)

    def read(self):
        return {name: getattr(mod, attr) for name, (mod, attr) in self.where.items()}


def _moved(before, after):
    """The counters that moved between two readings, by how much."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _plan(build, name, case):
    """The launch plan of a conv forward or FC backward case (None for the
    other kernels): tile, tiles and K splits (build.tc_split); da and db
    blocks (build.matmul_bwd_plan)."""
    if name == "conv2d":
        _, n, h, cin, cout, k, s = case
        m, bn = n * (h // s) ** 2, build.tc_tile_n(cout)
        return {"tile": [build.TC_BM, bn], "tiles": -(-m // build.TC_BM) * -(-cout // bn),
                "splits": build.tc_split(m, cout, k * k * cin)}
    if name == "matmul_bwd":
        _, m, k, n, _, need_a, need_b = case
        return dict(zip(("da_blocks", "db_blocks"),
                        build.matmul_bwd_plan(m, k, n, need_a, need_b)))
    if name == "block_fused":
        _, (n, h, w, c4), c, _ = case
        m = n * h * w
        gemms = ((c, c4), (c, 9 * c), (c4, c))  # (Cout, K): reduce, 3x3, expand
        tiles = [build.wg_tile_n(cout) for cout, _ in gemms]
        return {"tile_n": tiles,
                "tiles": [-(-m // build.WG_BM) * -(-cout // bn)
                          for (cout, _), bn in zip(gemms, tiles)],
                "splits": [build.wg_split(m, cout, k) for cout, k in gemms]}
    return None


def phase_kernels(checks, names, build=None):
    """Each case of the named kernels against its plain version; with
    ``build``, each line also carries the case's launch plan."""
    results = {name: [] for name in names}
    for name in names:
        for case in checks.KERNELS[name][-1]:
            r = checks.check_case(name, case, seed=SEED)
            plan = _plan(build, name, case) if build is not None else None
            emit({"phase": "kernel", **r, **({"plan": plan} if plan else {})})
            results[name].append(r)
    if build is not None and "block_fused" in names:
        for case in checks.SPLIT_CASES:  # K10's weight split, bit for bit
            emit({"phase": "kernel", **checks.check_split(case, seed=SEED)})
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


def phase_serve(torch, checks, counters):
    from resnet_tpu_torch.config import ExecutionConfig, model_config
    from resnet_tpu_torch.export import export_inference, save_inference
    from resnet_tpu_torch.models import init_bn_state, init_params
    from resnet_tpu_torch.serve import bucketed_call, serve

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
            counters.zero()
            replies, deltas = [], []
            for x in batches:
                before = counters.read()
                status, out = _post(httpd.server_address, x)
                require(status == 200, f"/predict answered {status}: {out}")
                deltas.append(_moved(before, counters.read()))
                replies.append(out)
            launches = {k: v for k, v in counters.read().items() if v}
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


def _clone(tree):
    """A deep copy of a state tree (NamedTuples, dicts, lists, tensors)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaf_errors(got, want, what, rel, floor=0.0, sens=None):
    """max|got - want| over each leaf pair, against rel * max(floor, max|want|)
    or, where ``sens`` (path -> the plain path's own change) is given,
    GRAD_SENS times that change if larger; raises on a leaf beyond both.
    Returns the largest ratio to max|want|, the largest to the sensitivity,
    and the leaf nearest its limit with the limit applied there."""
    from resnet_tpu_torch.bridge import flatten

    worst, worst_sens, nearest, nearest_ratio = 0.0, 0.0, None, -1.0
    for (path, g), (_, w) in zip(flatten(got), flatten(want), strict=True):
        err = (g - w).abs().max().item()
        scale = max(floor, w.abs().max().item())
        limit = rel * scale
        if sens is not None:
            limit = max(limit, GRAD_SENS * sens[path])
            worst_sens = max(worst_sens, err / sens[path] if sens[path] else 0.0)
        require(err <= limit,
                f"{what} {path}: max|kernel - plain| = {err} > {limit}")
        worst = max(worst, err / scale if scale else err)
        ratio = err / limit if limit else 0.0
        if ratio > nearest_ratio:
            nearest_ratio = ratio
            nearest = {"leaf": path, "err": err, "limit": limit, "max_abs": scale}
    return worst, worst_sens, nearest


def _update_share(got, want, p0, lr):
    """The share of all elements whose update got - p0 differs from
    want - p0 by more than lr / 100 + 4 ulp of p0."""
    from resnet_tpu_torch.bridge import leaves

    bad = total = 0
    for a, b, z in zip(leaves(got), leaves(want), leaves(p0), strict=True):
        limit = lr / 100 + 4 * 2.0 ** -23 * z.abs()
        bad += int((((a - z) - (b - z)).abs() > limit).sum().item())
        total += z.numel()
    return bad / total


def _as_running(bn_stats):
    """aux["bn_stats"] ((mean, var) per layer) as a bn_state tree."""
    def leaf(mv):
        return {"mean": mv[0].clone(), "var": mv[1].clone()}

    return {"init_bn": leaf(bn_stats["init_bn"]),
            "blocks": [{k: leaf(v) for k, v in b.items()} for b in bn_stats["blocks"]]}


def _nudge_sensitivity(batch, params, bn_state, pc, pg):
    """Per gradient leaf, the plain path's own largest change when the
    images are scaled by 1 +- 2^-20 (pg: its gradient at the images)."""
    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.train import loss_and_grads

    sens = {}
    for factor in (1 + IMAGE_NUDGE, 1 - IMAGE_NUDGE):
        nudged = dict(batch, images=batch["images"] * factor)
        qg = loss_and_grads(params, nudged, bn_state, pc)[3]
        for (path, a), b in zip(flatten(qg), leaves(pg), strict=True):
            sens[path] = max(sens.get(path, 0.0), (a - b).abs().max().item())
        del qg
    return sens


def _train_main_path(torch, counters, step, cfg, state0, batch, expect, what):
    """A training path's main run: the counters from 0, TRAIN_STEPS steps on
    one batch, each required to move the counters by exactly ``expect``, and
    the loss after the last update required below the first. Returns (state,
    losses, per-step counts, the counters after the steps, that loss)."""
    from resnet_tpu_torch.models import forward
    from resnet_tpu_torch.ops import cross_entropy

    counters.zero()
    state, losses, per_step = _clone(state0), [], []
    for _ in range(TRAIN_STEPS):
        before = counters.read()
        state, metrics = step(state, batch)
        per_step.append(_moved(before, counters.read()))
        losses.append(metrics["loss"].item())
    launches = counters.read()
    for i, delta in enumerate(per_step):
        require(delta == expect, f"{what} step {i} moved the counters by {delta}, "
                f"expected {expect}")
    with torch.no_grad():
        logits, _ = forward(state.params, batch["images"], cfg.model, cfg.execution,
                            train=True, bn_state=state.bn_state)
        final_loss = cross_entropy(logits, batch["labels"], reduction="mean").item()
    require(all(np.isfinite(losses)) and np.isfinite(final_loss), f"losses {losses}")
    require(final_loss < losses[0], f"{what}: loss after {TRAIN_STEPS} steps "
            f"{final_loss} is not below the first {losses[0]}")
    return state, losses, per_step, launches, final_loss


def _timed_steps(torch, step, state, batch, n=5):
    """(state, median ms, host ms of each step) of n steps, each timed on the
    host clock around work that ends in a synchronize; the host ms run from
    the step's start to its return, before that synchronize."""
    times, host = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, float(np.median(times)), host


def _profile(torch, step):
    """Device time of one call of step() by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0 and getattr(e, "self_cpu_time_total", 0) == 0:
            rows.append({"kernel": e.key[:90], "calls": e.count, "ms": ms})
    rows.sort(key=lambda r: -r["ms"])
    return rows


def phase_train(torch, checks, counters, smi):
    import dataclasses

    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.config import ExecutionConfig, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state, loss_and_grads, make_train_step

    base = variant_config("resnet")  # ResNet-50, kernels='pallas', lr 1e-4, batch 32
    kcfg = dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, conv_kernels="pallas"),
        optimizer=dataclasses.replace(base.optimizer, fused=True))
    pcfg = dataclasses.replace(
        base, execution=ExecutionConfig(),
        optimizer=dataclasses.replace(base.optimizer, fused=False))
    batch_n = base.data.batch_size
    lr = base.optimizer.learning_rate
    state0 = init_train_state(kcfg, torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(batch_n, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    kstep, pstep = make_train_step(kcfg), make_train_step(pcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, kstep, kcfg, state0, batch, PER_STEP, "train")

    def grads_pair(params, bn_state, kc, pc):
        """Kernel-path and plain-path gradients from one state, and the plain
        path's own change per leaf when the images are scaled by 1 +- 2^-20."""
        kl, _, _, kg = loss_and_grads(params, batch, bn_state, kc)
        pl, _, paux, pg = loss_and_grads(params, batch, bn_state, pc)
        sens = _nudge_sensitivity(batch, params, bn_state, pc, pg)
        require(abs(kl.item() - pl.item()) <= LOSS_TOL * abs(pl.item()),
                f"summed loss {kl.item()} vs plain {pl.item()}")
        return kg, pg, sens, paux

    def max_rel(errs, want):
        return max(errs[p] / max(w.abs().max().item(), 1e-30) for p, w in flatten(want))

    def survey(params, bn_state, kc, pc):
        """How far kernel and plain gradients differ, and how far the plain
        path moves under the nudge, as shares of each leaf's max; no limit."""
        kg, pg, sens, _ = grads_pair(params, bn_state, kc, pc)
        errs = {p: (a - b).abs().max().item()
                for (p, a), b in zip(flatten(kg), leaves(pg), strict=True)}
        return {"kernel_vs_plain_max_rel": max_rel(errs, pg),
                "plain_nudge_max_rel": max_rel(sens, pg)}

    def frozen(cfg):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, bn_mode="frozen"))

    # one step from the same state on both paths, compared leaf by leaf
    kg, pg, sens, paux = grads_pair(state0.params, state0.bn_state, kcfg, pcfg)
    sens_rel = max_rel(sens, pg)
    grad_err, grad_sens, grad_nearest = _leaf_errors(kg, pg, "gradient", GRAD_TOL,
                                                     sens=sens)
    ks, km = kstep(_clone(state0), batch)
    ps, pm = pstep(_clone(state0), batch)
    loss_err = abs(km["loss"].item() - pm["loss"].item()) / abs(pm["loss"].item())
    require(loss_err <= LOSS_TOL, f"loss {km['loss'].item()} vs plain {pm['loss'].item()}")
    # after one step from zero moments, m = (1 - b1) g on both paths
    b1 = base.optimizer.beta1
    m_err, m_sens, _ = _leaf_errors(ks.opt_state.means, ps.opt_state.means, "adam m",
                                    GRAD_TOL,
                                    sens={k: (1 - b1) * v for k, v in sens.items()})
    p_abs = max((a - b).abs().max().item()
                for a, b in zip(leaves(ks.params), leaves(ps.params), strict=True))
    require(p_abs <= 2 * lr + 1e-6, f"params differ by {p_abs} > 2 * lr + 1e-6")
    batch_share = _update_share(ks.params, ps.params, state0.params, lr)
    stat_err, _, _ = _leaf_errors(ks.bn_state, ps.bn_state, "running statistic",
                                  STAT_TOL, floor=1.0)
    del ks, ps, kg, pg

    # where else the gradient is as sensitive: after the main path's steps,
    # and with BN frozen at this batch's own statistics
    conditioning = {
        "batch_bn_after_steps": survey(state.params, state.bn_state, kcfg, pcfg),
        "frozen_at_batch_stats": survey(state0.params, _as_running(paux["bn_stats"]),
                                        frozen(kcfg), frozen(pcfg))}

    # the well-conditioned check: one step with BN frozen at the initial
    # running statistics (mean 0, var 1); conv dx and dW, the join masks, the
    # FC backward and Adam are all on this path
    kfcfg, pfcfg = frozen(kcfg), frozen(pcfg)
    fkg, fpg, fsens, _ = grads_pair(state0.params, state0.bn_state, kfcfg, pfcfg)
    frozen_sens = max_rel(fsens, fpg)
    frozen_err, frozen_ratio, frozen_nearest = _leaf_errors(
        fkg, fpg, "frozen-BN gradient", GRAD_TOL, sens=fsens)
    del fkg, fpg
    ks, _ = make_train_step(kfcfg)(_clone(state0), batch)
    ps, _ = make_train_step(pfcfg)(_clone(state0), batch)
    frozen_share = _update_share(ks.params, ps.params, state0.params, lr)
    require(frozen_share <= UPDATE_SHARE,
            f"frozen-BN step: {frozen_share} of the Adam updates differ from the "
            f"plain path's by more than lr / 100")
    frozen_m_err, _, _ = _leaf_errors(ks.opt_state.means, ps.opt_state.means,
                                      "frozen-BN adam m", GRAD_TOL,
                                      sens={k: (1 - b1) * v for k, v in fsens.items()})
    del ks, ps

    # step times in turns: plain, kernel, kernel, plain
    pstate = _clone(state0)
    step_ms = {"plain": [], "kernel": []}
    host = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            pstate, ms, h = _timed_steps(torch, pstep, pstate, batch)
        else:
            state, ms, h = _timed_steps(torch, kstep, state, batch)
        step_ms[which].append(ms)
        host[which] += h
    # peak memory of one step of each path; both paths' states are resident
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    state, _ = kstep(state, batch)
    torch.cuda.synchronize()
    peak["kernel"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    pstate, _ = pstep(pstate, batch)
    torch.cuda.synchronize()
    peak["plain"] = torch.cuda.max_memory_allocated() / 2**30

    holder = {"state": state}

    def one_step():
        holder["state"], _ = kstep(holder["state"], batch)

    profile_rows = _profile(torch, one_step)
    busy = sum(r["ms"] for r in profile_rows)
    kernel_ms = float(np.median(step_ms["kernel"]))
    plain_ms = float(np.median(step_ms["plain"]))
    emit({"phase": "train", "model": kcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss,
          "compare": {"loss_rel_err": loss_err, "grad_max_rel_err": grad_err,
                      "grad_max_err_over_sensitivity": grad_sens,
                      "plain_grad_max_rel_sensitivity": sens_rel,
                      "adam_m_max_rel_err": m_err,
                      "adam_m_max_err_over_sensitivity": m_sens,
                      "grad_nearest_limit": grad_nearest,
                      "param_max_abs_err": p_abs,
                      "update_share_beyond_lr_100": batch_share,
                      "running_stats_max_err": stat_err,
                      "frozen_bn": {"grad_max_rel_err": frozen_err,
                                    "grad_max_err_over_sensitivity": frozen_ratio,
                                    "grad_nearest_limit": frozen_nearest,
                                    "plain_grad_max_rel_sensitivity": frozen_sens,
                                    "adam_m_max_rel_err": frozen_m_err,
                                    "update_share_beyond_lr_100": frozen_share},
                      "conditioning": conditioning},
          "step_ms": step_ms, "host_step_ms": _host_medians(host),
          "kernel_step_ms": kernel_ms,
          "kernel_img_s": batch_n * 1e3 / kernel_ms, "plain_step_ms": plain_ms,
          "plain_img_s": batch_n * 1e3 / plain_ms, "peak_gib": peak,
          "resident_before_gib": resident,
          "profile_device_busy_ms": busy if profile_rows else "not measured",
          "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def _engine_vs_plain(torch, cfg, pcfg, state0, batch):
    """One step of an engine from state0 against the plain standard path:
    summed loss, training logits, every layer's batch statistics, every
    gradient leaf (the rule of phase 5's batch-statistics step), then the
    step's loss and running statistics. Returns (compare, the plain loss)."""
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    fl, flogits, faux, fg = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
    pl, plogits, paux, pg = loss_and_grads(state0.params, batch, state0.bn_state, pcfg)
    sum_loss_err = abs(fl.item() - pl.item()) / abs(pl.item())
    require(sum_loss_err <= LOSS_TOL, f"summed loss {fl.item()} vs plain {pl.item()}")
    logit_scale = plogits.abs().max().item()
    logit_err = (flogits - plogits).abs().max().item()
    require(logit_err <= LOGIT_TOL * logit_scale,
            f"training logits differ by {logit_err} > {LOGIT_TOL} * {logit_scale}")
    stat_batch_err, _, _ = _leaf_errors(faux["bn_stats"], paux["bn_stats"],
                                        "batch statistic", STAT_TOL, floor=1.0)
    sens = _nudge_sensitivity(batch, state0.params, state0.bn_state, pcfg, pg)
    grad_err, grad_sens, grad_nearest = _leaf_errors(fg, pg, f"{cfg.execution.kernels} "
                                                     "gradient", GRAD_TOL, sens=sens)
    del fg, pg, faux, paux
    fs, fm = make_train_step(cfg)(_clone(state0), batch)
    ps, pm = make_train_step(pcfg)(_clone(state0), batch)
    plain_loss = pm["loss"].item()
    loss_err = abs(fm["loss"].item() - plain_loss) / abs(plain_loss)
    require(loss_err <= LOSS_TOL, f"loss {fm['loss'].item()} vs plain {plain_loss}")
    stat_err, _, _ = _leaf_errors(fs.bn_state, ps.bn_state, "running statistic",
                                  STAT_TOL, floor=1.0)
    return {"summed_loss_rel_err": sum_loss_err, "loss_rel_err": loss_err,
            "logits_max_err": logit_err, "logits_max_abs": logit_scale,
            "batch_stats_max_rel_err": stat_batch_err, "running_stats_max_err": stat_err,
            "grad_max_rel_err": grad_err, "grad_max_err_over_sensitivity": grad_sens,
            "grad_nearest_limit": grad_nearest}, plain_loss


def _other_step(counters, cfg, state0, batch, expect, plain_loss, name):
    """One step of another configuration: its counts, its loss against the
    plain path's."""
    from resnet_tpu_torch.train import make_train_step

    before = counters.read()
    _, m = make_train_step(cfg)(_clone(state0), batch)
    delta = _moved(before, counters.read())
    require(delta == expect, f"{name} step moved the counters by {delta}, expected {expect}")
    err = abs(m["loss"].item() - plain_loss) / abs(plain_loss)
    require(err <= LOSS_TOL, f"{name} loss {m['loss'].item()} vs plain {plain_loss}")
    return {"per_step": delta, "loss": m["loss"].item(), "loss_rel_err": err}


def _host_medians(host):
    """The median host ms per path over all its timed steps."""
    return {k: float(np.median(v)) for k, v in host.items()}


def _times_and_peaks(torch, steps, states, batch, order):
    """Step times in turns (median of 5 steps per turn, in ``order``) and the
    host ms per path (``_host_medians``), then the peak memory of one step
    of each path with all their states resident. Updates ``states``."""
    step_ms = {k: [] for k in steps}
    host = {k: [] for k in steps}
    for which in order:
        states[which], ms, h = _timed_steps(torch, steps[which], states[which], batch)
        step_ms[which].append(ms)
        host[which] += h
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    peak = {}
    for which in steps:
        torch.cuda.reset_peak_memory_stats()
        states[which], _ = steps[which](states[which], batch)
        torch.cuda.synchronize()
        peak[which] = torch.cuda.max_memory_allocated() / 2**30
    return step_ms, _host_medians(host), peak, resident


def _engine_setup(torch, *kernels):
    """The "resnet" variant (ResNet-50, lr 1e-4, batch 32) under each engine
    with fused Adam, the plain standard path (per-tensor Adam), one state
    and one synthetic batch."""
    import dataclasses

    from resnet_tpu_torch.config import ExecutionConfig, variant_config
    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.train import init_train_state

    base = variant_config("resnet")
    cfgs = [dataclasses.replace(
        base, execution=dataclasses.replace(base.execution, kernels=k),
        optimizer=dataclasses.replace(base.optimizer, fused=True)) for k in kernels]
    pcfg = dataclasses.replace(base, execution=ExecutionConfig(),
                               optimizer=dataclasses.replace(base.optimizer, fused=False))
    state0 = init_train_state(cfgs[0], torch.Generator().manual_seed(SEED), device="cuda")
    data = next(SyntheticDataset(base.data.batch_size, image_dim=base.model.input_dim,
                                 num_classes=base.model.num_classes, seed=SEED))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    return cfgs, pcfg, state0, batch


def _busy(profile_rows):
    return sum(r["ms"] for r in profile_rows) if profile_rows else "not measured"


def phase_fused(torch, checks, counters, smi):
    """The fused engine's training step: main path, one step against the
    plain standard path, the other two engines, times, memory, profile.

    The fused engine runs only with batch-statistics BN (bn_mode='batch'),
    so the frozen-BN tight check of phase 5 has no counterpart here: the
    gradients are held to the rule of phase 5's batch-statistics step."""
    from resnet_tpu_torch.train import make_train_step

    (fcfg, hcfg, xcfg), pcfg, state0, batch = _engine_setup(
        torch, "fused", "hybrid", "fusedxla")
    batch_n = fcfg.data.batch_size
    fstep = make_train_step(fcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, fstep, fcfg, state0, batch, FUSED_PER_STEP, "fused train")
    compare, plain_loss = _engine_vs_plain(torch, fcfg, pcfg, state0, batch)
    others = {name: _other_step(counters, cfg, state0, batch, expect, plain_loss, name)
              for name, cfg, expect in (("hybrid", hcfg, HYBRID_PER_STEP),
                                        ("fusedxla", xcfg, FUSEDXLA_PER_STEP))}

    steps = {"plain": make_train_step(pcfg), "fusedxla": make_train_step(xcfg),
             "fused": fstep}
    states = {"plain": _clone(state0), "fusedxla": _clone(state0), "fused": state}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch, ("plain", "fusedxla", "fused", "fused", "fusedxla", "plain"))

    def one_step():
        states["fused"], _ = fstep(states["fused"], batch)

    profile_rows = _profile(torch, one_step)
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "fused_train", "model": fcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss, "compare": compare,
          "engines": others, "step_ms": step_ms, "host_step_ms": host_ms,
          "fused_step_ms": median["fused"], "fused_img_s": batch_n * 1e3 / median["fused"],
          "fusedxla_step_ms": median["fusedxla"],
          "fusedxla_img_s": batch_n * 1e3 / median["fusedxla"],
          "plain_step_ms": median["plain"], "plain_img_s": batch_n * 1e3 / median["plain"],
          "peak_gib": peak, "resident_before_gib": resident,
          "profile_device_busy_ms": _busy(profile_rows), "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def phase_blockfused(torch, checks, counters, smi):
    """The whole-block engine's training step (kernels='blockfused', fused
    Adam): main path, one step against the plain standard path by the rules
    of phase 6, one step with conv_kernels='pallas', times in turns beside
    the fused engine's and the plain path's, memory, profile."""
    import dataclasses

    from resnet_tpu_torch.train import make_train_step

    (bcfg, fcfg), pcfg, state0, batch = _engine_setup(torch, "blockfused", "fused")
    batch_n = bcfg.data.batch_size
    bstep = make_train_step(bcfg)

    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, bstep, bcfg, state0, batch, BLOCKFUSED_PER_STEP, "blockfused train")
    compare, plain_loss = _engine_vs_plain(torch, bcfg, pcfg, state0, batch)
    pallas_cfg = dataclasses.replace(
        bcfg, execution=dataclasses.replace(bcfg.execution, conv_kernels="pallas"))
    with_pallas = _other_step(counters, pallas_cfg, state0, batch, BLOCKFUSED_PALLAS_PER_STEP,
                              plain_loss, "blockfused with conv_kernels='pallas'")

    steps = {"plain": make_train_step(pcfg), "blockfused": bstep,
             "fused": make_train_step(fcfg)}
    states = {"plain": _clone(state0), "blockfused": state, "fused": _clone(state0)}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch,
        ("plain", "blockfused", "fused", "fused", "blockfused", "plain"))

    def one_step():
        states["blockfused"], _ = bstep(states["blockfused"], batch)

    profile_rows = _profile(torch, one_step)
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "blockfused_train", "model": bcfg.model.name, "batch": batch_n,
          "device": smi, "launches": launches, "per_step": per_step[0],
          "losses": losses, "loss_after_last_step": final_loss, "compare": compare,
          "conv_kernels_pallas": with_pallas, "step_ms": step_ms, "host_step_ms": host_ms,
          **{f"{k}_step_ms": v for k, v in median.items()},
          **{f"{k}_img_s": batch_n * 1e3 / v for k, v in median.items()},
          "peak_gib": peak, "resident_before_gib": resident,
          "profile_device_busy_ms": _busy(profile_rows), "profile": profile_rows[:30]})
    return {k: v for k, v in launches.items() if v}


def phase_bn_entry(torch, counters):
    """batch_norm_act, the public BN(+ReLU) entry point, forward and backward
    at the stem's shape with and without ReLU: (y, mean, var) against
    bn_act_reference (plain torch ops), the gradients against the plain
    backward (bn_bwd_reference) at the statistics the entry point returned.
    Autograd through bn_act_reference would normalize with its own
    statistics, and an element whose x_hat * gamma + beta lies within
    rounding of 0 would pass its gradient through one ReLU gate and not the
    other."""
    from resnet_tpu_torch.kernels import bn

    m, c, eps = 32 * 112 * 112, 64, 1e-7
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5
    gamma = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.5 * torch.randn(c, generator=gen, device="cuda")
    dy = torch.randn(m, c, generator=gen, device="cuda")

    launches, errs = {}, {}
    names = ("y", "mean", "var", "dx", "dgamma", "dbeta")
    for relu in (True, False):
        counters.zero()  # the main path: counters from 0, one call, counters read
        xs, g, b = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
        y, mean, var = bn.batch_norm_act(xs, g, b, eps, relu)
        got = (y.detach(), mean, var, *torch.autograd.grad(y, (xs, g, b), dy))
        torch.cuda.synchronize()
        moved = {k: v for k, v in counters.read().items() if v}
        require(moved == BN_ENTRY_PER_CALL, f"batch_norm_act (relu={relu}) moved the "
                f"counters by {moved}, expected {BN_ENTRY_PER_CALL}")
        for k, v in moved.items():
            launches[k] = launches.get(k, 0) + v
        want = (*bn.bn_act_reference(x, gamma, beta, eps, relu),
                *bn.bn_bwd_reference(x, dy, mean, torch.rsqrt(var + eps), gamma, beta,
                                     relu=relu))
        for name, a, b in zip(names, got, want, strict=True):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            require(err <= ENTRY_TOL * scale, f"batch_norm_act (relu={relu}) {name}: "
                    f"max|kernel - plain| = {err} > {ENTRY_TOL} * {scale}")
            errs[f"{name}{' relu' if relu else ''}"] = err / scale if scale else err
    emit({"phase": "batch_norm_act", "rows": m, "channels": c, "launches": launches,
          "max_rel_err": errs})
    return launches


def _step_record(torch, cfg, state0, batch):
    """One step of cfg from state0: its summed loss, batch statistics and
    gradients (loss_and_grads), then train_step's state and metrics with the
    peak memory of that step (GiB, all earlier allocations included) and
    the memory allocated before it."""
    from resnet_tpu_torch.train import loss_and_grads, make_train_step

    loss_sum, _, aux, grads = loss_and_grads(state0.params, batch, state0.bn_state, cfg)
    state = _clone(state0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    state, metrics = make_train_step(cfg)(state, batch)
    torch.cuda.synchronize()
    return {"loss_sum": loss_sum, "bn_stats": aux["bn_stats"], "grads": grads,
            "state": state, "metrics": metrics,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "before_gib": before}


def _hold_to(torch, got, want, lr, what, spread=None):
    """A step record against another from the same state (``_step_record``):
    summed loss, batch and running statistics within REMAT_STAT_TOL of
    max|.|, every gradient leaf within REMAT_GRAD_TOL of its max or, where
    ``spread`` (path -> the no-remat path's own change between two runs) is
    given, GRAD_SENS times that change if larger; the parameters within
    2 lr + 1e-6. Returns the errors and how many gradient leaves are equal
    bit for bit."""
    from resnet_tpu_torch.bridge import flatten, leaves

    la, lb = got["loss_sum"].item(), want["loss_sum"].item()
    require(abs(la - lb) <= REMAT_STAT_TOL * abs(lb), f"{what}: summed loss {la} vs {lb}")
    stat_err, _, _ = _leaf_errors(got["bn_stats"], want["bn_stats"],
                                  f"{what} batch statistic", REMAT_STAT_TOL)
    run_err, _, _ = _leaf_errors(got["state"].bn_state, want["state"].bn_state,
                                 f"{what} running statistic", REMAT_STAT_TOL)
    grad_err, grad_spread, nearest = _leaf_errors(got["grads"], want["grads"],
                                                  f"{what} gradient", REMAT_GRAD_TOL,
                                                  sens=spread)
    pairs = list(zip(leaves(got["grads"]), leaves(want["grads"]), strict=True))
    equal = sum(bool(torch.equal(a, b)) for a, b in pairs)
    p_err = max((a - b).abs().max().item() for a, b in zip(
        leaves(got["state"].params), leaves(want["state"].params), strict=True))
    require(p_err <= 2 * lr + 1e-6, f"{what}: parameters differ by {p_err} > 2 lr + 1e-6")
    return {"loss_rel_err": abs(la - lb) / abs(lb), "batch_stats_max_rel_err": stat_err,
            "running_stats_max_rel_err": run_err, "grad_max_rel_err": grad_err,
            "grad_nearest_limit": nearest, "grad_leaves_bit_equal": equal,
            **({"grad_max_err_over_spread": grad_spread} if spread else {}),
            "grad_leaves": len(pairs), "param_max_abs_err": p_err,
            "loss": got["metrics"]["loss"].item(), "peak_gib": got["peak_gib"]}


def _run_spread(torch, cfg, state0, batch, grads):
    """Per gradient leaf, how far a second run of cfg's forward and backward
    from state0 moves it from ``grads``, and how many leaves it leaves
    equal bit for bit: the run-to-run change of a path whose cuDNN
    backward adds in no fixed order."""
    from resnet_tpu_torch.bridge import flatten, leaves
    from resnet_tpu_torch.train import loss_and_grads

    again = loss_and_grads(state0.params, batch, state0.bn_state, cfg)[3]
    spread = {path: (a - b).abs().max().item()
              for (path, a), b in zip(flatten(again), leaves(grads), strict=True)}
    return spread, sum(v == 0.0 for v in spread.values())


def _counted_record(torch, counters, cfg, state0, batch, expect, what):
    """``_step_record`` of cfg, its counter moves required to be ``expect``
    per step (twice over loss_and_grads and train_step, Adam once)."""
    before = counters.read()
    rec = _step_record(torch, cfg, state0, batch)
    delta = _moved(before, counters.read())
    want = {k: 2 * v if k != "adam" else v for k, v in expect.items()}
    require(delta == want, f"{what} moved the counters by {delta} over loss_and_grads "
            f"and train_step, expected {want}")
    return rec


def _remat_case(torch, counters, cfg, remat, expect, none_rec, state0, batch, what,
                spread=None):
    """One step of cfg under ``remat`` (counted, ``_counted_record``) held to
    the no-remat step ``none_rec`` (with ``spread``, the run-to-run change
    of a path on cuDNN and its count of equal leaves, ``_hold_to``), its
    peak memory required below that step's. Emits the result as a line too."""
    import dataclasses

    rcfg = dataclasses.replace(cfg, execution=dataclasses.replace(cfg.execution,
                                                                  remat=remat))
    rec = _counted_record(torch, counters, rcfg, state0, batch, expect, what)
    out = _hold_to(torch, rec, none_rec, cfg.optimizer.learning_rate, what,
                   spread and spread[0])
    out.update(none_peak_gib=none_rec["peak_gib"],
               step_gib=rec["peak_gib"] - rec["before_gib"],
               none_step_gib=none_rec["peak_gib"] - none_rec["before_gib"])
    if spread:
        out["none_twice_grad_leaves_bit_equal"] = spread[1]
    emit({"phase": "remat_case", "case": what, **out})
    require(rec["peak_gib"] < none_rec["peak_gib"], f"{what}: peak {rec['peak_gib']} GiB "
            f"is not below the no-remat step's {none_rec['peak_gib']}")
    return out


def _cudnn_remat_case(torch, counters, cfg, expect, state0, batch, what):
    """``_remat_case`` of block remat for a path on cuDNN convs, whose
    backward adds in no fixed order: the no-remat step, its run-to-run
    change (``_run_spread``), then the remat step held to both."""
    none_rec = _step_record(torch, cfg, state0, batch)
    spread = _run_spread(torch, cfg, state0, batch, none_rec["grads"])
    return _remat_case(torch, counters, cfg, "block", expect, none_rec, state0, batch, what,
                       spread=spread)


def _ghost_vjp(torch):
    """batch_norm_ghost's closed-form VJP against autograd of the sliced
    moments (batch_norm_ghost_reference) at the stem's and stage 1's shapes
    at batch GHOST_BATCH, k = GHOST_STATS: y, the statistics, dx, dgamma
    and dbeta, each within GHOST_TOL of its max."""
    from resnet_tpu_torch.ops.batchnorm import batch_norm_ghost, batch_norm_ghost_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    for h, c in ((112, 64), (56, 256)):
        x = torch.randn(GHOST_BATCH, h, h, c, generator=gen, device="cuda") * 2 + 0.5
        gamma = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.3 * torch.randn(c, generator=gen, device="cuda")
        dy = torch.randn(x.shape, generator=gen, device="cuda")
        outs = []
        for fn in (batch_norm_ghost, batch_norm_ghost_reference):
            xs, g, b = (t.detach().requires_grad_(True) for t in (x, gamma, beta))
            y, (mean, var) = fn(xs, g, b, GHOST_STATS)
            outs.append((y.detach(), mean.detach(), var.detach(),
                         *torch.autograd.grad(y, (xs, g, b), dy)))
        for name, a, b in zip(("y", "mean", "var", "dx", "dgamma", "dbeta"), *outs):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            require(err <= GHOST_TOL * scale, f"ghost BN ({h}^2, {c}) {name}: closed form "
                    f"vs plain {err} > {GHOST_TOL} * {scale}")
            errs[f"{name} ({h}^2, {c})"] = err / scale if scale else err
    return errs


def phase_remat(torch, counters, smi):
    """The clean variant (ResNet-50, batch 224, Adam lr 1e-4, kernels='pallas',
    remat='block') with conv_kernels='pallas' and fused Adam: main path (5
    steps, counters per step, loss falls); one step each of remat 'block',
    'stage' and 'elementwise' against the 'none' step from one state (counts,
    statistics, gradients, parameters, peak memory); the whole-block engine
    under block remat against its no-remat step; lowmem at batch 192; a
    ghost-BN step at batch 32 and the ghost VJP against its plain version;
    step times of 'none' and 'block' in turns, with host time and device
    busy time."""
    import dataclasses

    from resnet_tpu_torch.data import SyntheticDataset
    from resnet_tpu_torch.config import variant_config
    from resnet_tpu_torch.train import init_train_state, make_train_step

    torch.cuda.empty_cache()
    base = variant_config("clean")  # ResNet-50, kernels='pallas', remat='block', batch 224

    def with_(cfg, **execution):
        return dataclasses.replace(
            cfg, execution=dataclasses.replace(cfg.execution, **execution),
            optimizer=dataclasses.replace(cfg.optimizer, fused=True))

    def batch_of(n):
        data = next(SyntheticDataset(n, image_dim=base.model.input_dim,
                                     num_classes=base.model.num_classes, seed=SEED,
                                     distinct_batches=1))
        return {k: torch.from_numpy(v).cuda() for k, v in data.items()}

    cfg = with_(base, conv_kernels="pallas")
    batch_n = cfg.data.batch_size
    state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    batch = batch_of(batch_n)
    rstep = make_train_step(cfg)
    state, losses, per_step, launches, final_loss = _train_main_path(
        torch, counters, rstep, cfg, state0, batch, REMAT_PER_STEP, "remat train")
    del state

    none_cfg = with_(cfg, remat="none")
    none_rec = _step_record(torch, none_cfg, state0, batch)
    cases = {remat: _remat_case(torch, counters, none_cfg, remat, expect, none_rec, state0,
                                batch, f"remat={remat!r}")
             for remat, expect in (("block", REMAT_PER_STEP), ("stage", REMAT_PER_STEP),
                                   ("elementwise", ELEMENTWISE_PER_STEP))}
    del none_rec

    # the whole-block engine, with the preset's cuDNN convs elsewhere
    cases["blockfused block"] = _cudnn_remat_case(
        torch, counters, with_(base, kernels="blockfused", remat="none"),
        BLOCKFUSED_REMAT_PER_STEP, state0, batch, "blockfused, remat='block'")
    del state0, batch

    # lowmem: the plain path with block remat at its batch (no hand kernel)
    low = variant_config("lowmem")
    low_state0 = init_train_state(low, torch.Generator().manual_seed(SEED), device="cuda")
    cases["lowmem"] = _cudnn_remat_case(
        torch, counters, dataclasses.replace(low, execution=dataclasses.replace(
            low.execution, remat="none")), {}, low_state0, batch_of(low.data.batch_size),
        "lowmem")
    cases["lowmem"]["batch"] = low.data.batch_size
    del low_state0

    # ghost BN at batch 32: one step, then the VJP against its plain version
    gcfg = with_(dataclasses.replace(base, data=dataclasses.replace(
        base.data, batch_size=GHOST_BATCH)), conv_kernels="pallas", remat="none",
        bn_stats_batch=GHOST_STATS)
    gstate0 = init_train_state(gcfg, torch.Generator().manual_seed(SEED), device="cuda")
    gbatch = batch_of(GHOST_BATCH)
    grec = _counted_record(torch, counters, gcfg, gstate0, gbatch, GHOST_PER_STEP,
                           "ghost BN")
    require(np.isfinite(grec["metrics"]["loss"].item()), "ghost BN: non-finite loss")
    ghost = {"batch": GHOST_BATCH, "bn_stats_batch": GHOST_STATS, "per_step": GHOST_PER_STEP,
             "loss": grec["metrics"]["loss"].item(), "vjp_max_rel_err": _ghost_vjp(torch)}
    del grec, gstate0, gbatch

    # step times in turns: none, block, block, none
    state0 = init_train_state(cfg, torch.Generator().manual_seed(SEED), device="cuda")
    batch = batch_of(batch_n)
    steps = {"none": make_train_step(none_cfg), "block": rstep}
    states = {"none": _clone(state0), "block": state0}
    step_ms, host_ms, peak, resident = _times_and_peaks(
        torch, steps, states, batch, ("none", "block", "block", "none"))
    busy = {}
    for which in steps:
        def one_step(which=which):
            states[which], _ = steps[which](states[which], batch)

        busy[which] = _busy(_profile(torch, one_step))
    median = {k: float(np.median(v)) for k, v in step_ms.items()}
    emit({"phase": "remat_train", "model": cfg.model.name, "batch": batch_n, "device": smi,
          "launches": launches, "per_step": per_step[0], "losses": losses,
          "loss_after_last_step": final_loss, "compare": cases, "ghost_bn": ghost,
          "step_ms": step_ms, "host_step_ms": host_ms,
          **{f"{k}_step_ms": v for k, v in median.items()},
          **{f"{k}_img_s": batch_n * 1e3 / v for k, v in median.items()},
          "profile_device_busy_ms": busy, "timed_peak_gib": peak,
          "resident_before_gib": resident})
    return {k: v for k, v in launches.items() if v}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", help="comma-separated kernel names: phases 1-3 "
                        "for those only, no plans, no final line")
    args = parser.parse_args()
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
    smi = phase_env(torch, build)
    phase_build(build)
    if args.kernels:
        names = args.kernels.split(",")
        require(set(names) <= set(checks.KERNELS), f"unknown kernels in {names}")
        phase_kernels(checks, names)
        require("jax" not in sys.modules, "jax was imported")
        print(nvidia_smi(), flush=True)
        return
    results = phase_kernels(checks, list(checks.KERNELS), build)
    counters = Counters(checks)
    paths = {"serve": phase_serve(torch, checks, counters),
             "train": phase_train(torch, checks, counters, smi),
             "fused_train": phase_fused(torch, checks, counters, smi),
             "blockfused_train": phase_blockfused(torch, checks, counters, smi),
             "batch_norm_act": phase_bn_entry(torch, counters),
             "remat_train": phase_remat(torch, counters, smi)}
    require("jax" not in sys.modules, "jax was imported")
    launched = {name: sum(p.get(name, 0) for p in paths.values()) for name in KERNEL_SOURCES}
    require(all(launched.values()), f"kernels no main path launched: "
            f"{[k for k, v in launched.items() if not v]}")

    rows = []
    for name, (src, ref) in KERNEL_SOURCES.items():
        rs = results[name]
        by = {}
        for r in rs:  # the bound that sets most of the summed least time
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": ref,
            "launches": launched[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "host_us": sum(r["host_us"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": max(by, key=by.get),
            "library_ms": checks.total(rs),
            "device_ms": checks.total(rs, "device_ms"),
            "library_device_ms": checks.total(rs, "library_device_ms")})
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
