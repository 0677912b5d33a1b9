"""Profiling: a trace context and a per-op slope timer, the port of
resnet_tpu.utils.profiling.

``trace_context`` records the enclosed steps with ``torch.profiler`` (host
and, on the card, CUDA activity) and writes a Chrome trace. The JAX
package's ``hlo_dump`` sets an XLA flag and has no counterpart here.
``time_fn`` runs a callable n times for two values of n and returns the
slope, so the constant cost of a call's start and its final wait cancels.
On the card a run is timed by CUDA events and ends in
``torch.cuda.synchronize``; on the CPU (tests) by the host clock, which
times the CPU's kernels, not the card's.

CLI: ``python -m resnet_tpu_torch.utils.profiling --out optable.json``
prints a JSON timing table of ResNet-50's op classes (forward, and forward
and backward) on the card, with TFLOP/s and GB/s where they mean something.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None):
    """Profile the enclosed steps into ``trace_dir``/trace.json (a Chrome
    trace); a no-op without ``trace_dir``."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _on_card(args) -> bool:
    t = _first_tensor(args)
    return t is not None and t.is_cuda


def time_fn(
    fn: Callable,
    args: Tuple,
    *,
    iters: int = 24,
    warmup: int = 2,
    feedback: Optional[Callable] = None,
    repeats: int = 3,
) -> float:
    """Seconds per call of ``fn(*args)`` on the arguments' device.

    Runs fn n times for two values of n and returns the slope. The counts
    grow so that the window between them is at least ~80 ms; the median of
    ``repeats`` slopes is returned. ``feedback(out, args) -> args`` chains
    the calls through a data dependency where independent calls would
    overlap."""
    card = _on_card(args)

    def run(n):
        a = args
        if card:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*a)
            if feedback is not None:
                a = feedback(out, a)
        if card:
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - t0

    run(warmup)
    rough = run(6) / 6
    iters = max(iters, min(512, int(0.08 / max(rough, 1e-5))))
    n_small = max(2, iters // 4)
    slopes = sorted((run(iters) - run(n_small)) / (iters - n_small)
                    for _ in range(max(1, repeats)))
    return slopes[len(slopes) // 2]


def time_grad_fn(fn: Callable, args: Tuple, **kw) -> float:
    """Seconds per forward and backward of fn with respect to args[0].

    The loss is sum(y * r) with a fixed random cotangent r: an all-ones
    cotangent would let a backward take shortcuts the training step cannot."""
    x0 = args[0]
    out = fn(*args)
    r = torch.from_numpy(np.random.default_rng(7).normal(0, 1, tuple(out.shape))
                         .astype(np.float32)).to(out.device)

    def fwd_bwd(x, *rest):
        x = x.detach().requires_grad_(True)
        loss = torch.sum(fn(x, *rest).to(torch.float32) * r)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    return time_fn(fwd_bwd, (x0, *args[1:]), **kw)


# --------------------------------------------------------------------------
# Per-op timing table for ResNet-50 (the six op classes of SURVEY.md 2.1)
# --------------------------------------------------------------------------


def _resnet50_op_specs(batch: int, device) -> Dict[str, Dict[str, Any]]:
    """ResNet-50's shapes per op class (NHWC, fp32). flops counts the
    forward only (the backward is ~2x a conv's or matmul's); bytes the
    forward's reads and writes."""
    r = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(r.normal(0, 1, shape).astype(np.float32)).to(device)

    b, el = batch, 4

    def conv_spec(xs, ws, stride):
        h = xs[1] // stride
        return {"kind": "conv", "x": t(*xs), "w": t(*ws), "stride": stride,
                "flops": 2 * b * h * h * ws[0] * ws[1] * ws[2] * ws[3]}

    def bn_spec(xs):
        return {"kind": "bn", "x": t(*xs), "gamma": t(xs[3]), "beta": t(xs[3]),
                "bytes": 2 * b * xs[1] * xs[2] * xs[3] * el}

    return {
        "conv_stem_7x7s2": conv_spec((b, 224, 224, 3), (7, 7, 3, 64), 2),
        "conv_s1_1x1_reduce": conv_spec((b, 56, 56, 256), (1, 1, 256, 64), 1),
        "conv_s1_3x3": conv_spec((b, 56, 56, 64), (3, 3, 64, 64), 1),
        "conv_s1_1x1_expand": conv_spec((b, 56, 56, 64), (1, 1, 64, 256), 1),
        "conv_s2_3x3s2": conv_spec((b, 56, 56, 128), (3, 3, 128, 128), 2),
        "conv_s3_3x3": conv_spec((b, 14, 14, 256), (3, 3, 256, 256), 1),
        "conv_s4_3x3": conv_spec((b, 7, 7, 512), (3, 3, 512, 512), 1),
        # both projection forms: the reference's 3x3/s2 (resnet.cu:770-797)
        # and the standard 1x1/s2
        "conv_proj_3x3s2": conv_spec((b, 56, 56, 256), (3, 3, 256, 512), 2),
        "conv_proj_1x1s2": conv_spec((b, 56, 56, 256), (1, 1, 256, 512), 2),
        "bn_relu_56x256": bn_spec((b, 56, 56, 256)),
        "bn_relu_14x1024": bn_spec((b, 14, 14, 1024)),
        "bn_relu_7x2048": bn_spec((b, 7, 7, 2048)),
        "join_56x256": {"kind": "join", "a": t(b, 56, 56, 256), "b": t(b, 56, 56, 256),
                        "bytes": 3 * b * 56 * 56 * 256 * el},
        "maxpool_112x64": {"kind": "maxpool", "x": t(b, 112, 112, 64),
                           "bytes": int(1.25 * b * 112 * 112 * 64 * el)},
        "avgpool_7x2048": {"kind": "avgpool", "x": t(b, 7, 7, 2048),
                           "bytes": b * 7 * 7 * 2048 * el},
        "fc_2048x1000": {"kind": "fc", "x": t(b, 2048), "w": t(2048, 1000),
                         "flops": 2 * b * 2048 * 1000},
        "softmax_ce": {"kind": "softmax_ce", "logits": t(b, 1000)},
        "adam_resnet50": {"kind": "adam"},
    }


def build_op_table(
    *,
    batch: int = 256,
    engine: str = "xla",
    ops_filter: str = "",
    iters: int = 24,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Time every op class forward and (where differentiable) forward and
    backward on ``device``: {op: {ms_fwd, ms_fwd_bwd, tflops_fwd?,
    gbps_fwd?}}. The plain convs and the FC run in true fp32 (TF32 off)."""
    import re

    from ..config import ExecutionConfig
    from ..ops import cross_entropy, dispatch, global_avg_pool, max_pool
    from ..ops.precision import precision_scope

    specs = _resnet50_op_specs(batch, device)
    table: Dict[str, Dict[str, float]] = {}
    with precision_scope(ExecutionConfig()):
        for name, spec in specs.items():
            if ops_filter and not re.search(ops_filter, name):
                continue
            kind = spec["kind"]
            if kind == "adam":
                table[name] = {"ms_fwd_bwd": 1e3 * _time_adam(iters, device)}
                continue
            if kind == "conv":
                fn = (lambda x, w, s=spec["stride"]:
                      dispatch.conv(x, w, stride=s, engine=engine))
                args: Tuple = (spec["x"], spec["w"])
            elif kind == "bn":
                fn = (lambda x, g, bb:
                      dispatch.bn_act(x, g, bb, eps=1e-5, relu=True, engine=engine)[0])
                args = (spec["x"], spec["gamma"], spec["beta"])
            elif kind == "join":
                fn = lambda a, c: dispatch.residual_join(a, c, engine=engine)  # noqa: E731
                args = (spec["a"], spec["b"])
            elif kind == "maxpool":
                fn = lambda x: max_pool(x, kernel=3, stride=2)  # noqa: E731
                args = (spec["x"],)
            elif kind == "avgpool":
                fn, args = global_avg_pool, (spec["x"],)
            elif kind == "fc":
                fn = lambda x, w: dispatch.fc(x, w, engine=engine)  # noqa: E731
                args = (spec["x"], spec["w"])
            else:  # softmax_ce
                labels = torch.zeros((batch,), dtype=torch.int64, device=device)
                fn = (lambda lg, labels=labels:
                      cross_entropy(lg, labels, reduction="sum"))
                args = (spec["logits"],)
            with torch.no_grad():
                row: Dict[str, float] = {"ms_fwd": 1e3 * time_fn(fn, args, iters=iters)}
            row["ms_fwd_bwd"] = 1e3 * time_grad_fn(fn, args, iters=iters)
            if "flops" in spec:
                row["tflops_fwd"] = spec["flops"] / (row["ms_fwd"] * 1e9)
                row["tflops_fwd_bwd"] = 3 * spec["flops"] / (row["ms_fwd_bwd"] * 1e9)
            if "bytes" in spec:
                row["gbps_fwd"] = spec["bytes"] / (row["ms_fwd"] * 1e6)
            table[name] = row
    return table


def _time_adam(iters: int, device) -> float:
    from ..bridge import tree_map
    from ..config import model_config
    from ..models import init_params
    from ..optim import adam_init, adam_update

    params = init_params(torch.Generator().manual_seed(0), model_config("resnet50"),
                         device=device)
    opt = adam_init(params)
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), params)

    def step(g, p, o):
        return adam_update(g, o, p, learning_rate=1e-4)

    return time_fn(step, (grads, params, opt), iters=iters)


def main(argv=None):
    import argparse
    import json
    import subprocess

    ap = argparse.ArgumentParser(description="per-op slope-timing table")
    ap.add_argument("--batch", type=int, default=0, help="0 = 256 on the card, 16 on the CPU")
    ap.add_argument("--engine", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--ops", default="", help="regex filter over op names")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default="", help="also write JSON here")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device; pass --device cpu for a CPU table")
    batch = args.batch or (256 if device.type == "cuda" else 16)
    table = build_op_table(batch=batch, engine=args.engine, ops_filter=args.ops,
                           iters=args.iters, device=device)
    meta = {"batch": batch, "dtype": "float32", "engine": args.engine,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu")}
    if device.type == "cuda":
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    out = {"meta": meta, "ops": table}
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
