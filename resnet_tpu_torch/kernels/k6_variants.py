"""K6's device time under source variants of ``csrc/bn.cu``, launch by launch.

    python -m resnet_tpu_torch.kernels.k6_variants             (every variant)
    python -m resnet_tpu_torch.kernels.k6_variants rows2 forward

A variant is a copy of ``bn.cu`` with text patches, and the blocks a SM
its plan counts on:

- ``forward``: the dx pass walks each thread's rows in its summing order
  instead of backwards;
- ``rows2``: batches of 2 rows of x and dy a thread instead of 4;
- ``occ2``, ``occ2_rows2``: two blocks a SM (at most 64 registers a thread)
  instead of one, with batches of 4 or 2 rows.

Each is built from ``bn.cu`` alone into ``build/k6_variants/<name>/`` (all at
once) and run through ``bn._bwd_launch`` with its library's entry points, on
phase 3's eight cases (``checks.BN_BWD_CASES``) in fp32 and bf16, the
unpatched ``base`` first and ``base`` again in two launches (``two``), in
two rounds. One JSON line a case gives the device µs of each kernel one
call launches, in launch order (torch.profiler, the mean over 10 calls),
the blocks of its grid, and whether the output equals ``base``'s bit for
bit (a variant on base's plan sums in the same order; one of two blocks a
SM takes other chunks, so its sums round otherwise). Needs nvcc and a CUDA card;
no model path uses it.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import bn, build, checks

_BN = "bn.cu"
_OCC2 = (_BN, "__launch_bounds__(BWD_THREADS, 1) bn_bwd_kernel",
         "__launch_bounds__(BWD_THREADS, 2) bn_bwd_kernel")
_ROWS2 = (_BN, "constexpr int BWD_ROWS = 4;", "constexpr int BWD_ROWS = 2;")
# name -> (patches, blocks a SM)
VARIANTS = {
    "forward": ([(_BN, "auto dx_row = [rows](int64_t j) { return rows - 1 - j; };",
                  "auto dx_row = [rows](int64_t j) { return j + 0 * rows; };")], 1),
    "rows2": ([_ROWS2], 1),
    "occ2": ([_OCC2], 2),
    "occ2_rows2": ([_OCC2, _ROWS2], 2),
}
OUT = build.BUILD_DIR.parent / "k6_variants"
ENTRIES = ("rt_bn_bwd_f32", "rt_bn_bwd_bf16")


def _build(name: str) -> Path:
    """bn.cu (and its header) patched, compiled into OUT/<name>/libk6.so."""
    src = OUT / name
    if src.exists():
        shutil.rmtree(src)
    src.mkdir(parents=True)
    for f in ("bn.cu", "rowwise.cuh"):
        shutil.copy(build.CSRC / f, src / f)
    for fname, old, new in VARIANTS.get(name, ([], 1))[0]:
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: its patch no longer matches {fname}")
        path.write_text(text.replace(old, new))
    lib = src / "libk6.so"
    done = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                           str(src / "bn.cu")], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n{done.stdout}{done.stderr}"[-4000:])
    return lib


def _entries(path: Path) -> dict:
    lib = ctypes.CDLL(str(path))
    out = {}
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build.SIGNATURES[name], ctypes.c_int
        out[name] = fn
    return out


def _kernel_us(fn, reps: int = 10):
    """Device µs of each kernel one call of fn launches, in launch order,
    the mean over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "bn_bwd" in e.name]
    per = len(times) // reps
    return [sum(times[i::per]) / reps for i in range(per)] if per else None


def _cases():
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        for label, m, c, relu in checks.BN_BWD_CASES:
            gen = torch.Generator(device="cuda").manual_seed(0)
            x = (torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            dy = torch.randn(m, c, generator=gen, device="cuda").to(dtype)
            mean, var = bn.moments_reference(x)
            rows = (mean, torch.rsqrt(var + 1e-7),
                    1 + 0.2 * torch.randn(c, generator=gen, device="cuda"),
                    0.5 * torch.randn(c, generator=gen, device="cuda"))
            yield str(dtype), label, x, dy, rows, relu


def main(names) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"k6_variants: unknown variants {sorted(unknown)}")
    names = ["base", *names]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, map(_entries, pool.map(_build, names))))
    runs = [("base", True), ("two", False)] + [(n, True) for n in names[1:]]
    entry = build.entry
    try:
        for turn in range(2):
            for dtype, label, x, dy, rows, relu in _cases():
                want = None
                for name, fused in runs:
                    fns = libs["base" if name == "two" else name]
                    build.entry = fns.__getitem__
                    per_sm = VARIANTS.get(name, ([], 1))[1]
                    plan = bn.bn_bwd_plan(*x.shape, bn.bwd_vector_width(x, dy),
                                          per_sm * bn._sms(x.device.index))

                    def call(plan=plan._replace(fused=fused)):
                        dx = torch.empty_like(x)
                        sums = torch.empty((2, x.shape[1]), device="cuda")
                        bn._bwd_launch(x, dy, rows, sums, dx, plan, relu)
                        return dx, sums

                    got = call()
                    want = got if want is None else want
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    print(json.dumps({"turn": turn, "variant": name, "dtype": dtype,
                                      "case": label, "blocks": plan.tiles * plan.n_chunks,
                                      "kernel_us": _kernel_us(call),
                                      "same_bits": same}), flush=True)
    finally:
        build.entry = entry


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
