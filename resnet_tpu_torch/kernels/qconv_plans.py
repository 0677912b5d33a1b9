"""Q1 (``quant.qconv``) at phase 3's cases under its own plan and the
alternatives.

    python -m resnet_tpu_torch.kernels.qconv_plans [batch ...]

on a CUDA card prints one JSON line per case of ``checks.QCONV_CASES``
(and, for each batch named, the same sites at that batch): the tile width
and K splits ``build.qconv_plan`` picks, and, for every tile width (64,
128, 256) and every split count whose splits are whole 128-deep slices
with none empty (up to four waves of units), the device time of one
launch (torch.profiler, ``checks.device_ms``) and whether its output
equals the plain version bit for bit. The planner's
costs (``build.QC_SLICE_COST``, ``build.QC_PARTIAL_COST``) are fitted to
these lines.
"""

from __future__ import annotations

import contextlib
import json
import sys

import torch

from . import build, checks, quant


def _device_ms(fn) -> float:
    ms = checks.device_ms(fn, reps=10, tries=4)
    return float("nan") if ms is None else ms


@contextlib.contextmanager
def forced_plan(bn: int, splits: int):
    """``build.qconv_plan`` answers (bn, splits) for every shape while
    open, so ``quant.qconv`` launches under that plan."""
    planner = build.qconv_plan
    build.qconv_plan = lambda m, n, k: (bn, splits)
    try:
        yield
    finally:
        build.qconv_plan = planner


def split_counts(slices: int, tiles: int):
    """Every split count of whole slices with none empty, at most four
    waves of units."""
    counts = sorted({-(-slices // c) for c in range(1, slices + 1)})
    return [s for s in counts if s == 1 or tiles * s <= 4 * build._SMS]


def cases(batches):
    out = list(checks.QCONV_CASES)
    for b in batches:
        out += [(label.replace("(x", f"batch {b} (x"), b, *rest)
                for label, _, *rest in checks.qconv_sites(b)]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qconv_plans: needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in cases([int(b) for b in sys.argv[1:]]):
        label, n, h, cin, cout, k, s, relu, cap, out = case
        xq, w, dq, b, wk, kw = checks.qconv_operands(case, gen, "cuda")
        want = quant.qconv_reference(xq, w, dq, b, **kw)
        m, kk = n * (h // s) ** 2, quant.packed_k((k, k, cin))
        row = {"case": label, "m": m, "n": cout, "k": kk, "slices": -(-kk // build.QC_SLICE),
               "plan": list(build.qconv_plan(m, cout, kk)),
               "device_ms": _device_ms(lambda: quant.qconv(xq, w, dq, b, wk=wk, **kw)),
               "alternatives": []}
        for bn in (64, 128, 256):
            tiles = -(-m // build.QC_BM) * -(-cout // bn)
            for splits in split_counts(row["slices"], tiles):
                def run():
                    return quant.qconv(xq, w, dq, b, wk=wk, **kw)
                with forced_plan(bn, splits):
                    row["alternatives"].append({
                        "bn": bn, "splits": splits, "units": tiles * splits,
                        "same_bits": bool(torch.equal(run(), want)),
                        "device_ms": _device_ms(run)})
        print(json.dumps(row), flush=True)
    print(build.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
