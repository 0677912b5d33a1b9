"""Where one call of K4 (``bn.moments``), of K7 (``adam.fused_adam``,
with its caller ``optim.adam_update_fused``) and of K6 (``bn.bn_bwd``)
spends its host time, and what one call of each served forward entry (K1,
K2, K3, Q1, Q2) costs the host.

    python -m resnet_tpu_torch.kernels.host_parts [moments] [adam] [bn_bwd] [served]

on a CUDA card prints one JSON line per part: ``checks.host_us`` of that
part alone (200 calls enqueued back to back, divided by 200), at the
statistics cases of ``checks.MOMENTS_CASES`` and over ResNet-50's 160
parameter tensors. Each part is one piece of the wrapper's work, done
alone with what it needs made beforehand, so the parts need not add up
to the whole call exactly.

The parts are those of the wrapper the package holds: the two-launch K4
and the device-table K7 (``rt_moments_f32`` with 9 arguments,
``rt_adam_f32`` with a table pointer), or the one-launch K4 and the
parameter-bank K7 that replaced them. K6's parts are those of the
one-launch wrapper (``bn.bn_bwd_plan``), at the batch-32 stem's and the
ragged case's shapes of ``checks.BN_BWD_CASES`` in fp32 and bf16; in an
older tree only its whole call is timed. ``served`` times, at a batch-8
serving shape each and under ``torch.inference_mode()``, in SERVED_TURNS
turns (the median printed beside every turn), the wrapper's
whole call (``conv.conv2d``, ``fused.add_relu``, ``matmul.matmul``,
``quant.qconv`` with its packed weight, ``quant.quant_act``) and, where the
tree has the custom ops (``kernels.ops``), the op called directly and its
CUDA implementation called directly: the dispatcher's cost is the op's
time less the implementation's. Run inside a ``git archive`` of an older
tree, the script times that tree's parts.
"""

from __future__ import annotations

import json
import statistics
import sys

import torch

from . import adam, bn, build, checks

DEVICE = "cuda"
SERVED_TURNS = 5  # the served entries' parts: the median of this many timings


def _emit(kernel, case, part, fn):
    print(json.dumps({"kernel": kernel, "case": case, "part": part,
                      "host_us": checks.host_us(fn)}), flush=True)


def _two_launch_k4(x, label):
    """The parts of the two-launch K4 wrapper (a table of chunk partials
    in a fresh workspace, then a second kernel that sums them)."""
    m, c = x.shape
    index = x.device.index
    chunk = bn.chunk_rows(m, c)
    n_chunks = -(-m // chunk)
    part = torch.empty((n_chunks, 2, c), dtype=torch.float32, device=x.device)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    fn = build.load().rt_moments_f32
    args = (x.data_ptr(), part.data_ptr(), mean.data_ptr(), var.data_ptr(), m, c, chunk,
            n_chunks)
    stream = torch._C._cuda_getCurrentRawStream(index)
    _emit("moments", label, "build.on_card", lambda: build.on_card("moments", x))
    _emit("moments", label, "chunk_rows", lambda: bn.chunk_rows(m, c))
    _emit("moments", label, "3 torch.empty", lambda: (
        torch.empty((n_chunks, 2, c), dtype=torch.float32, device=x.device),
        torch.empty((c,), dtype=torch.float32, device=x.device),
        torch.empty_like(mean)))
    _emit("moments", label, "stream and device lookup", lambda: (
        torch._C._cuda_getCurrentRawStream(index), torch.cuda.current_device()))
    _emit("moments", label, "ctypes call, 2 launches", lambda: fn(*args, stream))
    _emit("moments", label, "build.launch, 2 launches", lambda: build.launch(
        "rt_moments_f32", *args, device=x.device))
    _emit("moments", label, "_forward", lambda: bn._forward(x))


def _one_launch_k4(x, label):
    """The parts of the one-launch K4 wrapper."""
    m, c = x.shape
    vec = bn.vector_width(x)
    plan = bn.moments_plan(m, c, vec)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    _emit("moments", label, "moments_plan (cached)", lambda: bn.moments_plan(m, c, vec))
    _emit("moments", label, "1 torch.empty", lambda: torch.empty(
        (2, c), dtype=torch.float32, device=x.device))
    _emit("moments", label, "workspace lookup", lambda: bn._workspace(x.device.index, plan.part,
                                                                        plan.tiles))
    _emit("moments", label, "launch (ctypes, 1 launch)", lambda: bn._launch(x, out, plan, vec))
    _emit("moments", label, "_forward", lambda: bn._forward(x))


def moments_parts():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for label, m, c, *_ in checks.MOMENTS_CASES:
        x = torch.randn(m, c, generator=gen, device=DEVICE)
        xg = x.detach().requires_grad_(True)
        stub = (torch.zeros(c, device=DEVICE), torch.zeros(c, device=DEVICE))
        _emit("moments", label, "whole call, x requires grad", lambda: bn.moments(xg))
        _emit("moments", label, "whole call, no grad", lambda: bn.moments(x))
        _emit("moments", label, "Function.apply of a stub, x requires grad",
              lambda: bn._Moments.apply(xg, lambda t: stub))
        if hasattr(bn, "moments_plan"):
            _one_launch_k4(x, label)
        else:
            _two_launch_k4(x, label)


def _device_table_k7(p, g, m, v, h):
    """The parts of the device-table K7 wrapper (a pinned int64 table of
    (p, g, m, v, numel, first block) rows copied to the card each call)."""
    tensors = [*p, *g, *m, *v, h]

    def shape_loop():
        for a, b, c, d in zip(p, g, m, v):
            if not (a.shape == b.shape == c.shape == d.shape):
                raise ValueError

    def rows():
        out, first = [], 0
        for a, b, c, d in zip(p, g, m, v):
            if a.numel():
                out.append([a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                            a.numel(), first])
                first += -(-a.numel() // adam._CHUNK)
        return out, first

    table_rows, n_blocks = rows()
    host = torch.tensor(table_rows, dtype=torch.int64)
    pinned = host.pin_memory()
    table = pinned.to(h.device, non_blocking=True)
    fn = build.load().rt_adam_f32
    stream = torch._C._cuda_getCurrentRawStream(h.device.index)
    _emit("adam", "resnet50", "length and shape loop", shape_loop)
    _emit("adam", "resnet50", "build.on_card over 641 tensors",
          lambda: build.on_card("adam", *tensors))
    _emit("adam", "resnet50", "rows list (640 data_ptr)", rows)
    _emit("adam", "resnet50", "torch.tensor(rows)",
          lambda: torch.tensor(table_rows, dtype=torch.int64))
    _emit("adam", "resnet50", ".pin_memory()", lambda: host.pin_memory())
    _emit("adam", "resnet50", ".to(device, non_blocking=True)",
          lambda: pinned.to(h.device, non_blocking=True))
    _emit("adam", "resnet50", "ctypes call, 1 launch",
          lambda: fn(table.data_ptr(), len(table_rows), n_blocks, h.data_ptr(), stream))


def _bank_k7(p, g, m, v, h):
    """The parts of the parameter-bank K7 wrapper."""
    plan = adam._state_plan(p, m, v, h.device.index)
    _emit("adam", "resnet50", "state plan (cached)",
          lambda: adam._state_plan(p, m, v, h.device.index))
    _emit("adam", "resnet50", "gradient checks and pointers",
          lambda: adam._grad_pointers(g, plan))
    ptrs = adam._grad_pointers(g, plan)
    _emit("adam", "resnet50", "launch (ctypes, 1 launch)", lambda: adam._launch(plan, ptrs, h))


def adam_parts():
    from .. import bridge
    from ..bridge import leaves, tree_map
    from ..config import model_config
    from ..models.init import init_params
    from ..optim import adam_init, adam_update_fused

    params = init_params(torch.Generator().manual_seed(0), model_config("resnet50"),
                         device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen, device=DEVICE) * 1e-3,
                     params)
    state = adam_init(params)
    p, g, m, v = (leaves(t) for t in (params, grads, state.means, state.vars))
    lr = torch.full((), 1e-4, dtype=torch.float32, device=DEVICE)
    cmd = state.mean_decay_prod * 0.9
    cvd = state.var_decay_prod * 0.999

    def hyper():
        return adam.hyper_row(lr, 0.0, 0.9, 0.999, 1e-7, cmd, cvd, True, p[0].device)

    h = hyper()
    _emit("adam", "resnet50", "optim.adam_update_fused, whole", lambda: adam_update_fused(
        grads, state, params, learning_rate=lr))
    trees = (params, grads, state.means, state.vars)
    _emit("adam", "resnet50", "leaves of the four trees", lambda: [leaves(t) for t in trees])
    if hasattr(bridge, "leaves_of"):
        _emit("adam", "resnet50", "leaves_of the four trees, one walk",
              lambda: bridge.leaves_of(*trees))
    _emit("adam", "resnet50", "g.contiguous() over 160", lambda: [t.contiguous() for t in g])
    _emit("adam", "resnet50", "hyper_row, device lr and decay products", hyper)
    _emit("adam", "resnet50", "fused_adam, whole", lambda: adam.fused_adam(p, g, m, v, h))
    if hasattr(adam, "_state_plan"):
        _bank_k7(p, g, m, v, h)
    else:
        _device_table_k7(p, g, m, v, h)


def bn_bwd_parts():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for label, m, c, relu in (checks.BN_BWD_CASES[0], checks.BN_BWD_CASES[-2]):
            x = torch.randn(m, c, generator=gen, device=DEVICE).to(dtype)
            dy = torch.randn(m, c, generator=gen, device=DEVICE).to(dtype)
            rows = [torch.rand(c, generator=gen, device=DEVICE) + 0.5 for _ in range(4)]
            case = f"{label} {str(dtype)[6:]}"
            _emit("bn_bwd", case, "whole call", lambda: bn.bn_bwd(x, dy, *rows, relu=relu))
            if not hasattr(bn, "bn_bwd_plan"):
                continue
            f32 = build.rows_f32(*rows)
            vec = bn.bwd_vector_width(x, dy)
            plan = bn.bn_bwd_plan(m, c, vec, bn._sms(x.device.index))
            dx, sums = torch.empty_like(x), torch.empty((2, c), device=DEVICE)
            _emit("bn_bwd", case, "_check_rows", lambda: bn._check_rows("bn_bwd", c, *rows))
            _emit("bn_bwd", case, "build.rows_f32", lambda: build.rows_f32(*rows))
            _emit("bn_bwd", case, "build.on_card",
                  lambda: build.on_card("bn_bwd", x, dy, rows=f32))
            _emit("bn_bwd", case, "load width and plan (cached)", lambda: bn.bn_bwd_plan(
                m, c, bn.bwd_vector_width(x, dy), bn._sms(x.device.index)))
            _emit("bn_bwd", case, "2 torch.empty", lambda: (
                torch.empty_like(x), torch.empty((2, c), dtype=torch.float32, device=DEVICE)))
            _emit("bn_bwd", case, "_bwd_launch (ctypes, 1 launch)",
                  lambda: bn._bwd_launch(x, dy, f32, sums, dx, plan, relu))
            _emit("bn_bwd", case, "unbind, 2 .to", lambda: [
                t.to(torch.float32) for t in sums.unbind(0)])
            _emit("bn_bwd", case, "build.count",
                  lambda: build.count(bn.__name__, "BWD_LAUNCHES", x))


def served_parts():
    from . import conv, fused, matmul, quant

    ops = sys.modules.get(f"{__package__}.ops")
    g = torch.Generator(device=DEVICE).manual_seed(0)
    x, w = (torch.randn(s, generator=g, device=DEVICE) for s in ((8, 56, 56, 64), (3, 3, 64, 64)))
    a, b = (torch.randn(8, 56, 56, 256, generator=g, device=DEVICE) for _ in range(2))
    fa, fb = torch.randn(8, 2048, generator=g, device=DEVICE), torch.randn(
        2048, 1000, generator=g, device=DEVICE)
    xq = torch.randint(-127, 128, (8, 56, 56, 64), generator=g, device=DEVICE, dtype=torch.int8)
    wq = torch.randint(-127, 128, (3, 3, 64, 64), generator=g, device=DEVICE, dtype=torch.int8)
    wk, dq, bias = quant.pack_weight(wq), torch.rand(64, device=DEVICE) * 1e-4, torch.zeros(
        64, device=DEVICE)
    q_args = (xq, wq, dq, bias, wk, 1, 1, True, None, torch.bfloat16)
    cases = [
        ("conv2d", "3x3 (8,56,56,64)", lambda: conv.conv2d(x, w, 1), "conv2d_nhwc",
         "_forward", conv, (x, w, 1)),
        ("add_relu", "(8,56,56,256)", lambda: fused.add_relu(a, b), "add_relu", "_forward",
         fused, (a, b)),
        ("matmul", "(8,2048)@(2048,1000)", lambda: matmul.matmul(fa, fb), "matmul",
         "_forward", matmul, (fa, fb)),
        ("qconv", "3x3 (8,56,56,64)", lambda: quant.qconv(xq, wq, dq, bias, relu=True, wk=wk),
         "qconv", "_qconv", quant, q_args),
        ("quant_act", "(8,56,56,64)", lambda: quant.quant_act(x, 0.37), "quant_act",
         "_quant_act", quant, (x, 0.37)),
    ]
    with torch.inference_mode():
        for kernel, case, whole, op, impl, mod, args in cases:
            parts = {"wrapper, whole call": whole}
            if ops is not None:
                parts["custom op, called directly"] = lambda: getattr(ops, op)(*args)
                parts["its CUDA implementation, called directly"] = (
                    lambda: getattr(mod, impl)(*args))
            times = {part: [] for part in parts}
            for _ in range(SERVED_TURNS):  # the parts in turns, each timed anew
                for part, fn in parts.items():
                    times[part].append(checks.host_us(fn))
            for part, t in times.items():
                print(json.dumps({"kernel": kernel, "case": case, "part": part,
                                  "host_us": statistics.median(t), "turns": t}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("host_parts: needs a CUDA device")
    build.load()
    parts = {"moments": moments_parts, "adam": adam_parts, "bn_bwd": bn_bwd_parts,
             "served": served_parts}
    for name in sys.argv[1:] or parts:
        parts[name]()
    print(build.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), file=sys.stdout)


if __name__ == "__main__":
    main()
