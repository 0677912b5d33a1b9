"""Where Q3's time goes: phase 3's Q3 cases under source variants of
``csrc/qconv.cu`` that each take one part of the kernel's work out, and
under plans beside ``build.q3_plan``'s.

    python -m resnet_tpu_torch.kernels.q3_variants             (every variant)
    python -m resnet_tpu_torch.kernels.q3_variants nocomp plans

A variant is a copy of ``csrc`` with text patches of ``qconv.cu``:

- ``nocomp``: no multiply phase (no item of any tile: no A or B loads, no
  mma, no epilogue);
- ``noload``: no halo copies (the tiles multiply whatever the buffers hold);
- ``nostore``: no stores of the staged tile;
- ``comp``: neither copies nor stores (the multiply phase alone).

Only ``qconv.cu`` is built, into ``build/q3_variants/<name>/`` (one nvcc per
variant, every variant at once), and ``rt_qconv_grouped_s8`` of each
library is launched through ``quant.qconv`` on ``checks.qconv_operands``'
inputs, the unpatched ``base`` first, in two rounds. One JSON line per
variant and case gives the device time of one launch (``checks.device_ms``),
and for ``base`` whether it equals the plain version. ``plans`` times each
batch-128 case on ``base`` under ``build.q3_plan``'s plan and the plans
beside it (sets a span halved and doubled, rows or images a tile halved and
doubled). A variant that drops work computes garbage: only its times mean
anything. Needs nvcc and a CUDA card; no model path uses it.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from . import build, checks, quant

_Q = "qconv.cu"
_NOCOMP = ("    for (int it = warp; it < items; it += Q3_WARPS) {\n",
           "    for (int it = warp + items; it < items; it += Q3_WARPS) {\n")
_NOLOAD = ("        wgb::cp16(buf + ((im * p.HR + hr) * p.HC + hc) * p.pitch + 16 * cc, "
           "src, ok);\n", "        (void)src;\n        (void)ok;\n")
_NOSTORE = ("    uint8_t* y = static_cast<uint8_t*>(p.out) + (m0 * p.Cout + col0) * p.esize;\n",
            "    if (p.mode >= 0) continue;\n"
            "    uint8_t* y = static_cast<uint8_t*>(p.out) + (m0 * p.Cout + col0) * p.esize;\n")
VARIANTS = {"nocomp": [_NOCOMP], "noload": [_NOLOAD], "nostore": [_NOSTORE],
            "comp": [_NOLOAD, _NOSTORE]}
OUT = build.BUILD_DIR.parent / "q3_variants"
ENTRY = "rt_qconv_grouped_s8"


def _build(name: str):
    """qconv.cu with the variant's patches, built alone into OUT/<name>."""
    src = OUT / name / "csrc"
    if src.parent.exists():
        shutil.rmtree(src.parent)
    shutil.copytree(build.CSRC, src)
    path = src / _Q
    text = path.read_text()
    for old, new in VARIANTS.get(name, []):
        if old not in text:
            raise RuntimeError(f"variant {name}: its patch no longer matches {_Q}")
        text = text.replace(old, new)
    path.write_text(text)
    lib = src.parent / "libq3.so"
    p = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n" + p.stdout[-4000:])
    fn = getattr(ctypes.CDLL(str(lib)), ENTRY)
    fn.argtypes, fn.restype = build.SIGNATURES[ENTRY], ctypes.c_int
    return fn


def _time(case, check: bool) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    xq, w, dq, b, wk, kw = checks.qconv_operands(case, gen, "cuda")

    def run():
        return quant.qconv(xq, w, dq, b, wk=wk, **kw)
    line = {"case": case[0], "device_ms": checks.device_ms(run, reps=10)}
    if check:
        line["same_bits"] = bool(torch.equal(run(), quant.qconv_reference(xq, w, dq, b, **kw)))
    return line


def _neighbours(case):
    """q3_plan's plan for a case and the plans beside it that fit."""
    _, n, h, cin, cout, k, s, _, _, out, g = case
    ho = h // s
    args = (n, cin, cout, g, k, k, s, ho, ho, out == "f32", True)
    sb, ti, tr = build.q3_plan(*args)
    tiles = [(ti, max(1, tr // 2)), (ti, min(ho, 2 * tr))] if ti == 1 else [
        (max(1, ti // 2), ho), (min(n, 2 * ti), ho)]
    plans = [(sb, ti, tr)] + [(x, ti, tr) for x in (max(1, sb // 2), 2 * sb)] + [
        (sb, *t) for t in tiles]
    seen = []
    for plan in plans:
        if plan not in seen and build.q3_geometry(*args, *plan) is not None:
            seen.append(plan)
    return seen


def main(names) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("q3_variants: needs a CUDA card")
    unknown = set(names) - set(VARIANTS) - {"plans"}
    if unknown:
        raise SystemExit(f"q3_variants: unknown variants {sorted(unknown)}")
    built = ["base", *(n for n in names if n in VARIANTS)]
    with ThreadPoolExecutor(len(built)) as pool:
        fns = dict(zip(built, pool.map(_build, built)))
    entry, planner = build.entry, build.q3_plan
    try:
        for turn in range(2):
            for name in built:
                build.entry = lambda _, fn=fns[name]: fn
                for case in checks.QCONV_GROUPED_CASES:
                    line = _time(case, check=name == "base" and turn == 0)
                    print(json.dumps({"turn": turn, "variant": name, **line}), flush=True)
        if "plans" in names:
            build.entry = lambda _: fns["base"]
            todo = [(case, _neighbours(case)) for case in checks.QCONV_GROUPED_CASES
                    if case[1] == 128]  # before q3_plan is replaced below
            for case, plans in todo:
                for plan in plans:
                    build.q3_plan = lambda *a, plan=plan: plan
                    print(json.dumps({"variant": "plans", "plan": plan,
                                      **_time(case, check=True)}), flush=True)
    finally:
        build.entry, build.q3_plan = entry, planner


if __name__ == "__main__":
    main(sys.argv[1:] or [*VARIANTS, "plans"])
