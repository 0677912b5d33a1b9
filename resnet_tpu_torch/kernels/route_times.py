"""Device time of each loader that a bf16 entry point on the persistent
``wgmma`` loop can take, on the same inputs, and of the served bf16
forward, in turns.

    python -m resnet_tpu_torch.kernels.route_times [loaders] [fc] [served]

on a CUDA card prints one JSON line per case (all three parts when none is
named):

* ``loaders``: K1's bf16 dx at each distinct ResNet-50 dx shape at batch 32
  under every loader its shapes allow ('copy' always; 'gather' where each
  slice lies in one tap of w; 'matrix' at 1x1/s1 with whole slices), the
  route index handed straight to ``rt_conv2d_dx_nhwc_bf16``
  (``conv.DX_ROUTES``); then K3's bf16 forward at M <= 32 under
  'swap_scalar', under 'swap' where its operands allow it, and as the
  (M, 1, 1, K) conv's 'scalar' (``matmul.FWD_BF16_ROUTES``). Four turns,
  the loaders' order rotated each turn, each time ``checks.device_ms``
  over 20 calls; whether every loader gives the same bits; the number of
  such dx calls in one ResNet-50 training step, and a summary line of
  each loader's step-weighted time over the shapes it shares with another.
* ``fc``: K3's bf16 forward through ``matmul.matmul`` on phase 3's five
  cases (``checks.BF16_MATMUL_CASES``' shapes): device ms and host µs,
  three turns.
* ``served``: the served bf16 forward at batch 8, NHWC and NCHW, built as
  chip_smoke.py's phase 11 builds it (seed 1234, bf16 weights, every hand
  kernel): six medians of 10 calls by CUDA events, the host clock of one
  call, and its device time.

``fc`` and ``served`` go through the wrappers only, so this file copied
into a ``git archive`` of an older tree times that tree's kernels there;
``loaders`` needs the entry points' route argument.
"""

from __future__ import annotations

import json
import re
import sys
import time

import numpy as np
import torch

from . import build, checks, conv, matmul

BF16 = torch.bfloat16
SEED = 1234
TURNS = 4


def _emit(row) -> None:
    print(json.dumps(row), flush=True)


def _turns(runs, reps=20):
    """{name: [device ms per turn]} of the callables in ``runs``, the
    order rotated each turn."""
    names = list(runs)
    times = {name: [] for name in names}
    for turn in range(TURNS):
        for name in names[turn % len(names):] + names[:turn % len(names)]:
            times[name].append(checks.device_ms(runs[name], reps=reps))
    return times


def _dx_shapes():
    """{(H, Cin, Cout, k, stride): dx calls a ResNet-50 step makes} at the
    fused-conv sites (``checks.fused_sites``' labels count the sites)."""
    shapes = {}
    for label, _, h, cin, cout, k, s, *_ in checks.fused_sites(32):
        key = (h, cin, cout, k, s)
        shapes[key] = shapes.get(key, 0) + int(re.search(r"\(x(\d+)\)", label).group(1))
    return shapes


def _dx_run(n, h, cin, cout, k, s, route, gen):
    g = torch.randn(n, h // s, h // s, cout, generator=gen, device="cuda").to(BF16)
    w = (torch.randn(k, k, cin, cout, generator=gen, device="cuda") * 0.05).to(BF16)
    dx = torch.empty((n, h, h, cin), dtype=BF16, device="cuda")
    m = n * h * h
    splits = conv.dx_splits(m, cin, cout, k, s)
    ws_ptr, ws = build.gemm_workspace(splits, m, cin, g)
    args = (g.data_ptr(), w.data_ptr(), dx.data_ptr(), n, h, h, cin, cout, k, s,
            *conv.geometry(h, h, k, s, None), ws_ptr, splits, conv.DX_ROUTES.index(route))

    def run(keep=(g, w, ws)):
        build.launch("rt_conv2d_dx_nhwc_bf16", *args, device=dx.device)
        return dx
    return run


def loaders() -> None:
    weighted = {}
    for (h, cin, cout, k, s), calls in _dx_shapes().items():
        m = 32 * h * h
        splits = conv.dx_splits(m, cin, cout, k, s)
        whole = splits == 1 or build.k_chunk(k * k * cout, splits, 16) % build.WGB_BK == 0
        routes = ["copy"] + (["gather"] if (k == 1 or cout % build.WGB_BK == 0) and whole
                             else []) + (["matrix"] if (k, s) == (1, 1) and whole else [])
        runs = {r: _dx_run(32, h, cin, cout, k, s, r, torch.Generator(device="cuda")
                           .manual_seed(SEED)) for r in routes}
        outs = [runs[r]().clone() for r in routes]
        times = _turns(runs)
        _emit({"part": "loaders", "kernel": "conv2d_dx_bf16", "shape": [32, h, cin, cout, k, s],
               "calls_per_step": calls, "splits": splits,
               "route": conv.dx_bf16_route(m, cin, cout, k, s),
               "same_bits": all(torch.equal(outs[0], o) for o in outs), "device_ms": times})
        if len(routes) > 1:
            group = "1x1/s1" if "matrix" in routes else "gather"
            for r in routes:
                weighted.setdefault(group, {}).setdefault(r, 0.0)
                weighted[group][r] += calls * min(times[r])
    _emit({"part": "loaders", "kernel": "conv2d_dx_bf16",
           "step_ms_by_loader": weighted})
    for label, m, k, n, offset in [("ragged (5,300)@(300,33)", 5, 300, 33, 0),
                                   ("misaligned b (8,2048)@(2048,1000)", 8, 2048, 1000, 1),
                                   ("misaligned b (3,2048)@(2048,1000)", 3, 2048, 1000, 1),
                                   ("fc (8,2048)@(2048,1000)", 8, 2048, 1000, 0),
                                   ("fc (32,2048)@(2048,1000)", 32, 2048, 1000, 0)]:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        a = torch.randn(m, k, generator=gen, device="cuda").to(BF16)
        b = (torch.randn(k * n + offset, generator=gen, device="cuda") * 0.02).to(BF16)[
            offset:].view(k, n)
        splits = matmul.fwd_splits(m, n, k)
        routes = ["swap_scalar", "scalar"] + (["swap"] if build.aligned16(a, b) and k % 8 == 0
                                              and n % 8 == 0 else [])
        runs = {}
        for r in routes:
            c = torch.empty((m, n), dtype=BF16, device="cuda")
            ws_ptr, ws = build.gemm_workspace(splits, m, n, a)
            args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, ws_ptr, splits,
                    matmul.FWD_BF16_ROUTES.index(r))

            def run(args=args, c=c, keep=ws):
                build.launch("rt_matmul_bf16", *args, device=c.device)
                return c
            runs[r] = run
        outs = [runs[r]().clone() for r in routes]
        _emit({"part": "loaders", "kernel": "matmul_bf16", "case": label, "splits": splits,
               "route": matmul.fwd_bf16_route(m, n, k, build.aligned16(a, b)),
               "same_bits": all(torch.equal(outs[0], o) for o in outs),
               "device_ms": _turns(runs, reps=30)})


def fc() -> None:
    for label, m, k, n, offset in [("fc (8,2048)@(2048,1000)", 8, 2048, 1000, 0),
                                   ("fc (32,2048)@(2048,1000)", 32, 2048, 1000, 0),
                                   ("fc (64,2048)@(2048,1000)", 64, 2048, 1000, 0),
                                   ("ragged (5,300)@(300,33)", 5, 300, 33, 0),
                                   ("misaligned b (8,2048)@(2048,1000)", 8, 2048, 1000, 1)]:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        a = torch.randn(m, k, generator=gen, device="cuda").to(BF16)
        b = (torch.randn(k * n + offset, generator=gen, device="cuda") * 0.02).to(BF16)[
            offset:].view(k, n)
        fn = lambda a=a, b=b: matmul.matmul(a, b)  # noqa: E731
        device, host = [], []
        for _ in range(3):
            device.append(checks.device_ms(fn, reps=30))
            host.append(checks.host_us(fn))
        _emit({"part": "fc", "case": label, "device_ms": device, "host_us": host})


def served() -> None:
    from ..config import ExecutionConfig, variant_config
    from ..export import export_inference
    from ..models import init_bn_state, init_params

    mcfg = variant_config("resnet").model
    params = init_params(torch.Generator().manual_seed(SEED), mcfg, device="cuda")
    bn_state = init_bn_state(mcfg, device="cuda")
    x = np.random.default_rng(SEED).normal(0, 50, (8, mcfg.input_dim, mcfg.input_dim, 3)
                                           ).astype(np.float32)
    for layout, images in (("NHWC", x), ("NCHW", np.ascontiguousarray(x.transpose(0, 3, 1, 2)))):
        model = export_inference(params, mcfg, bn_state=bn_state, weights_dtype="bfloat16",
                                 ecfg=ExecutionConfig(compute_dtype="bfloat16", layout=layout,
                                                      kernels="pallas", conv_kernels="pallas"))
        on_card = torch.from_numpy(images).cuda()
        call = lambda: model.call(on_card)  # noqa: E731
        call()
        events = [checks.median_ms(call, reps=10) for _ in range(6)]
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        _emit({"part": "served", "layout": layout, "batch8_ms": events,
               "host_call_ms": float(np.median(host)), "device_ms": checks.device_ms(call)})


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("route_times needs a CUDA device")
    parts = sys.argv[1:] or ["loaders", "fc", "served"]
    for part in parts:
        {"loaders": loaders, "fc": fc, "served": served}[part]()


if __name__ == "__main__":
    main()
