"""K4 (``bn.moments``) at every BN view of a ResNet-50 training step at
batch 32, under its own plan and the alternatives.

    python -m resnet_tpu_torch.kernels.k4_plans

on a CUDA card prints one JSON line per (rows, channels) view: the device
time of one ``bn.moments`` call (torch.profiler, ``checks.device_ms``) and,
where the tree plans K4 with ``bn.moments_plan``, the plan it picks and the
device time of the kernel under each alternative plan (16 or 32 channels
per tile, 1024 threads at one or two blocks per SM, 256 threads at two to
eight), with whether that plan's result agrees with the plain version
within 1e-4. Run inside a ``git archive`` of an older tree, it times that
tree's kernel at the same views.
"""

from __future__ import annotations

import json

import torch

from . import bn, build, checks

# (rows, channels) of the BN views of a ResNet-50 step at batch 32, 224x224
VIEWS = [(401408, 64), (100352, 64), (100352, 128), (100352, 256), (25088, 128),
         (25088, 256), (25088, 512), (6272, 256), (6272, 512), (6272, 1024), (1568, 512),
         (1568, 2048)]
# (ctv, threads, blocks per SM) of the alternatives, 16-byte loads
ALTERNATIVES = [(ctv, threads, per_sm) for ctv in (8, 16)
                for threads, per_sm in ((1024, 1), (1024, 2), (256, 2), (256, 4), (256, 6),
                                        (256, 8))]


def _device_ms(fn) -> float:
    ms = checks.device_ms(fn, reps=20, tries=4)
    return float("nan") if ms is None else ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k4_plans: needs a CUDA device")
    checks.fp32_strict()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, c in VIEWS:
        x = torch.randn(m, c, generator=gen, device="cuda") * 2.0 + 0.5
        row = {"rows": m, "channels": c, "device_ms": _device_ms(lambda: bn.moments(x))}
        if hasattr(bn, "moments_plan"):
            row["plan"] = bn.moments_plan(m, c, 4)._asdict()
            mean, var = bn.moments_reference(x)
            out = torch.empty(2, c, device="cuda")
            row["alternatives"] = []
            for ctv, threads, per_sm in ALTERNATIVES:
                tiles = -(-c // (4 * ctv))
                chunk = bn._chunk_rows(m, tiles, build._SMS * per_sm)
                n_chunks = -(-m // chunk)
                plan = bn.MomentsPlan(ctv, tiles, chunk, n_chunks, 2 * n_chunks * c, threads)
                bn._launch(x, out, plan, 4)
                right = all(((a - b).abs().max() <= checks.REL_TOL * b.abs().max()).item()
                            for a, b in ((out[0], mean), (out[1], var)))
                row["alternatives"].append(
                    {"ctv": ctv, "threads": threads, "blocks_per_sm": per_sm,
                     "n_chunks": n_chunks, "right": right,
                     "device_ms": _device_ms(lambda: bn._launch(x, out, plan, 4))})
        print(json.dumps(row), flush=True)
    print(build.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
