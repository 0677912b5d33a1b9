"""Where one call of K4 (``bn.moments``) and of K7 (``adam.fused_adam``,
with its caller ``optim.adam_update_fused``) spends its host time.

    python -m resnet_tpu_torch.kernels.host_parts

on a CUDA card prints one JSON line per part: ``checks.host_us`` of that
part alone (200 calls enqueued back to back, divided by 200), at the
statistics cases of ``checks.MOMENTS_CASES`` and over ResNet-50's 160
parameter tensors. Each part is one piece of the wrapper's work, done
alone with what it needs made beforehand, so the parts need not add up
to the whole call exactly.

The parts are those of the wrapper the package holds: the two-launch K4
and the device-table K7 (``rt_moments_f32`` with 9 arguments,
``rt_adam_f32`` with a table pointer), or the one-launch K4 and the
parameter-bank K7 that replaced them. Run inside a ``git archive`` of an
older tree, the script times that tree's parts.
"""

from __future__ import annotations

import json
import sys

import torch

from . import adam, bn, build, checks

DEVICE = "cuda"


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
    _emit("moments", label, "workspace lookup", lambda: bn._workspace(x.device.index, plan))
    _emit("moments", label, "launch (ctypes, 1 launch)", lambda: bn._launch(x, out, plan, vec))
    _emit("moments", label, "_forward", lambda: bn._forward(x))


def moments_parts():
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for label, m, c in checks.MOMENTS_CASES:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("host_parts: needs a CUDA device")
    build.load()
    moments_parts()
    adam_parts()
    print(build.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), file=sys.stdout)


if __name__ == "__main__":
    main()
