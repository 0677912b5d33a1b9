"""Where Q1's time goes: some of phase 3's Q1 cases under source variants
of ``csrc/qconv.cu`` that each take one part of the kernel's work out.

    python -m resnet_tpu_torch.kernels.q1_variants             (every variant)
    python -m resnet_tpu_torch.kernels.q1_variants noA nomma

A variant is a copy of ``csrc`` with text patches of ``qconv.cu`` or
``wgb_gemm.cuh``:

- ``noA``: no cp.async gather of A (the 16-byte path);
- ``noB``: no TMA of B (its mbarrier armed with no bytes);
- ``noAB``: neither;
- ``nomma``: no wgmma;
- ``noepi``: no epilogue (nothing stored);
- ``shallow``: ring slots 4, 3 and 2 at tile widths 64, 128 and 256.

Only ``qconv.cu`` is built, into ``build/q1_variants/<name>/`` (one nvcc per
variant, every variant at once), and ``rt_qconv_s8`` of each library is
launched through ``quant.qconv`` (``build.qconv_plan``'s tiles and splits),
the unpatched ``base`` first, in two rounds. One JSON line per variant and
case gives the device time of one launch (``checks.device_ms``), and for
``base`` whether it equals the plain version. A variant that drops work
computes garbage: only its times mean anything. Needs nvcc and a CUDA
card; no model path uses it.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import build, checks, quant

_Q = "qconv.cu"
_W = "wgb_gemm.cuh"
_NOA = (_Q, "        wgb::cp16(sa + wgb::swz(rlo + NC / 8 * i, cc), src, ok);\n",
        "        (void)src;\n        (void)ok;\n")
_NOB = (_Q, "      if (p.resident_b && units > 1) {  // B is in the ring since the first unit\n",
        "      if (true) {\n")
_NOMMA = (_W, "          MmaS8<BN>::run(acc, desc(base + wg_a + ks * 32, 16), "
              "desc(bb + ks * 32, 16), 1);\n", "          (void)bb;\n")
_NOEPI = (_Q, "  int a[NACC];\n", "  if (p.mode >= 0) return;\n  int a[NACC];\n")
_SHALLOW = (_Q, "static constexpr int S = BN == 256 ? 3 : BN == 128 ? 5 : 8;",
            "static constexpr int S = BN == 256 ? 2 : BN == 128 ? 3 : 4;")
VARIANTS = {"noA": [_NOA], "noB": [_NOB], "noAB": [_NOA, _NOB], "nomma": [_NOMMA],
            "noepi": [_NOEPI], "shallow": [_SHALLOW]}
OUT = build.BUILD_DIR.parent / "q1_variants"
# (label, batch, H, Cin, Cout, k, stride, relu, cap, out): run under
# build.qconv_plan's plan
CASES = [
    ("block 13 proj 3x3/s2 14^2 1024->2048", 8, 14, 1024, 2048, 3, 2, False, None, "bf16"),
    ("block 14 spatial 3x3/s1 7^2 512->512", 8, 7, 512, 512, 3, 1, True, None, "bf16"),
    ("block 3 proj 3x3/s2 56^2 256->512", 8, 56, 256, 512, 3, 2, False, None, "bf16"),
    ("block 0 expand 1x1/s1 56^2 64->256", 8, 56, 64, 256, 1, 1, False, None, "bf16"),
    ("block 0 reduce 1x1/s1 56^2 64->64", 8, 56, 64, 64, 1, 1, True, None, "bf16"),
    ("stem 7x7/s2 224^2 3->64", 8, 224, 3, 64, 7, 2, True, None, "bf16"),
    ("block 0 expand at batch 128", 128, 56, 64, 256, 1, 1, False, None, "bf16"),
    ("block 3 proj at batch 128", 128, 56, 256, 512, 3, 2, False, None, "bf16"),
]


def _source(name: str) -> Path:
    """csrc copied to OUT/<name>/csrc with the variant's patches."""
    src = OUT / name / "csrc"
    if src.parent.exists():
        shutil.rmtree(src.parent)
    shutil.copytree(build.CSRC, src)
    for fname, old, new in VARIANTS.get(name, []):
        path = src / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: its patch no longer matches {fname}")
        path.write_text(text.replace(old, new))
    return src


def _build(name: str) -> Path:
    src = _source(name)
    nvcc = build.find_nvcc()
    lib = src.parent / "libq1.so"
    p = subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src / _Q)],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode:
        raise RuntimeError(f"variant {name}: nvcc failed\n" + p.stdout[-4000:])
    return lib


def main(names) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("q1_variants: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"q1_variants: unknown variants {sorted(unknown)}")
    names = ["base", *names]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build, names)))
    entry = build.entry
    try:
        for turn in range(2):
            for name in names:
                fn = getattr(ctypes.CDLL(str(libs[name])), "rt_qconv_s8")
                fn.argtypes, fn.restype = build.SIGNATURES["rt_qconv_s8"], ctypes.c_int
                build.entry = lambda _, fn=fn: fn
                for case in CASES:
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    xq, w, dq, b, wk, kw = checks.qconv_operands(case, gen, "cuda")

                    def run():
                        return quant.qconv(xq, w, dq, b, wk=wk, **kw)
                    line = {"turn": turn, "variant": name, "case": case[0],
                            "device_ms": checks.device_ms(run, reps=10)}
                    if name == "base":
                        line["same_bits"] = bool(torch.equal(
                            run(), quant.qconv_reference(xq, w, dq, b, **kw)))
                    print(json.dumps(line), flush=True)
    finally:
        build.entry = entry


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
