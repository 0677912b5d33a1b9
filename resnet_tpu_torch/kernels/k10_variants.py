"""Where K10's GEMM time goes: its batch-32 identity-block cases under
source variants that each take one part of the GEMM's work out.

    python -m resnet_tpu_torch.kernels.k10_variants             (every variant)
    python -m resnet_tpu_torch.kernels.k10_variants bare nomma

A variant is a copy of ``csrc`` with text patches of ``wg_gemm.cuh``:

- ``nomma``: no wgmma (the 12 products of each slice);
- ``nopro``: no prologue pass over the gathered A slice;
- ``bare``: neither, so only the copies, the fragment reads and splits, the
  barriers and the epilogue are left;
- ``bare_noA``: ``bare`` without A's cp.async gather;
- ``bare_noB``: ``bare`` without B's TMA loads and their mbarrier waits;
- ``mma_B``: the products and B's loads, no A gather and no prologue;
- ``mma_only``: the products on whatever the ring holds, no loads at all.

Each is built into its own library under ``build/k10_variants/<name>/`` (one
nvcc per source, every variant at once) and run through
``block_fused.block_fused_forward`` with that library, the unpatched
``base`` first, in two rounds. For each case one JSON line gives the device
time of every kernel the call launches (``checks.device_profile``), and for
``base`` its error against the plain version and whether a second run gives
the same bits. A variant that drops work computes garbage: only its times
mean anything. Needs nvcc and a CUDA card; no model path uses it.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import build, checks

_WG = "wg_gemm.cuh"
_MMA = "".join(f"#pragma unroll\n      for (int ks = 0; ks < 4; ++ks) Mma<BN>::run(d, {a}[ks], "
               f"{b} + 2 * ks, {s});\n" for a, b, s in (("al", "bh", "ks"), ("ah", "bl", "1"),
                                                         ("ah", "bh", "1")))
_NOMMA = (_WG, _MMA, "")
_NOPRO = (_WG, "if (a.prologue) {  // the thread's own elements", "if (false) {  //")
_NOA = (_WG, "        tc::cp_async<VEC>(dst + j, ok ? a.at(rows[r], cur[j]) : a.x, ok);\n",
        "        (void)ok;\n        (void)dst;\n")
_NOB = [(_WG, """      mbar_expect_tx(&full[slot], 2 * T::B_BYTES);
      tma_load_3d(bs, bmap, &full[slot], k0, pit.col0, 0);
      tma_load_3d(bs + T::B_BYTES, bmap, &full[slot], k0, pit.col0, 1);
""", "      (void)k0;\n      (void)bs;\n"),
        (_WG, "      mbar_wait(&full[slot], (uint32_t)(g / S) & 1);  // B's two boxes have landed\n",
         "")]
VARIANTS = {
    "nomma": [_NOMMA],
    "nopro": [_NOPRO],
    "bare": [_NOMMA, _NOPRO],
    "bare_noA": [_NOMMA, _NOPRO, _NOA],
    "bare_noB": [_NOMMA, _NOPRO, *_NOB],
    "mma_B": [_NOPRO, _NOA],
    "mma_only": [_NOPRO, _NOA, *_NOB],
}
OUT = build.BUILD_DIR.parent / "k10_variants"


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
    objs = [src.parent / f"{cu.stem}.o" for cu in sorted(src.glob("*.cu"))]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cu, obj in zip(sorted(src.glob("*.cu")), objs)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError(f"variant {name}: nvcc failed\n" + "\n".join(logs)[-4000:])
    lib = src.parent / "libkernels.so"
    subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(lib), *map(str, objs)], check=True)
    return lib


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in build.SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def main(names) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k10_variants: needs a CUDA card")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"k10_variants: unknown variants {sorted(unknown)}")
    names = ["base", *names]
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build, names)))
    checks.fp32_strict()
    cases = [c for c in checks.BLOCK_FUSED_CASES if c[0].startswith("stage")]
    load = build.load
    try:
        for turn in range(2):
            for name in names:
                lib = _load(libs[name])
                build.load = lambda lib=lib: lib
                for case in cases:
                    gen = torch.Generator(device="cuda").manual_seed(0)
                    c = checks._make("block_fused", case, gen, "cuda")
                    line = {"turn": turn, "variant": name, "case": case[0],
                            "device_kernels": checks.device_profile(c.run)}
                    if name == "base":
                        got, want = checks._outputs(c.run()), checks._outputs(c.plain())
                        line["rel_err"] = max(
                            ((g - w).abs().max() / w.abs().max()).item()
                            for g, w in zip(got, want))
                        line["same_bits"] = all(torch.equal(a, b) for a, b in
                                                zip(got, checks._outputs(c.run())))
                    print(json.dumps(line), flush=True)
    finally:
        build.load = load


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
