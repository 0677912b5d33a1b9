"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into a shared library
with a plain C interface (no PyTorch headers, no ninja):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/resnet_tpu_torch/libkernels-<hash>.so *.o

``<hash>`` covers every source and header, so an edited kernel rebuilds and
an unchanged one is reused. Processes that ask for the library together
(the ranks of a data-parallel run, started at once) take turns on a lock
file beside it (``fcntl.flock``): the first compiles, the others find its
library when the lock comes to them. The library is written under a
temporary name and renamed into place, so no process loads a half-written
file. It is loaded with
ctypes; every pointer and the stream are passed as ``c_void_p``, and each
entry point returns ``cudaGetLastError()`` after its launch. A float
argument is a ``c_float``.

There is no fallback: without nvcc, ``load()`` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "resnet_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# entry point -> argtypes; the last argument of each is the CUDA stream
SIGNATURES = {
    # x, w, scale, shift, y, part, sums, N, H, W, Cin, Cout, k, stride,
    # pad_top, pad_left, Ho, Wo, prologue, relu, has_cap, cap, ws, splits
    "rt_fused_conv_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _F, _P, _I, _P],
    "rt_fused_join_f32": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _F, _P],
    # x, w1, w2, w3, g1, b1, g2, b2, g3, b3, out, r, s, e, sums_r, sums_s,
    # sums_e, rows, part, ws, wsplit, N, H, W, C4, C, eps, has_cap, cap,
    # splits x 3
    "rt_block_fused_f32": [*[_P] * 21, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _I, _P],
    # the same block one stage at a time (stage, the one call's arguments,
    # the device float of the global row count): BN statistics summed over
    # ranks between the stages
    "rt_block_fused_stage_f32": [_I, *[_P] * 21, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _I,
                                 _P, _P],
    # b, bs, K, N: K10's K-major tf32 split of one weight
    "rt_split_tf32_f32": [_P, _P, _I, _I, _P],
    "rt_bn_apply_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _F, _P],
    # x, dy, mean, inv, gamma, beta, part, tickets, sums, dx, M, C, chunk,
    # n_chunks, vec, ctv, fused, relu
    "rt_bn_bwd_f32": [*[_P] * 10, _I64, _I, _I64, _I, _I, _I, _I, _I, _P],
    # GEMMs: ..., workspace, splits (split-K, see tiled_gemm.cuh); the conv
    # entries x, w|g, out, N, H, W, Cin, Cout, k, stride, then the window
    # grid pad_top, pad_left, Ho, Wo (conv.geometry), workspace, splits
    "rt_conv2d_nhwc_f32": [_P, _P, _P, *[_I] * 11, _P, _I, _P],
    "rt_conv2d_dx_nhwc_f32": [_P, _P, _P, *[_I] * 11, _P, _I, _P],
    "rt_conv2d_dw_nhwc_f32": [_P, _P, _P, *[_I] * 11, _P, _I, _P],
    "rt_matmul_f32": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "rt_matmul_skinny_f32": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # a, b, g, da (or null), db (or null), M, K, N, da_blocks, db_blocks
    "rt_matmul_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_add_relu_f32": [_P, _P, _P, _I64, _P],
    "rt_add_relu_mask_f32": [_P, _P, _P, _P, _I64, _P],
    # x, part, tickets, stats, M, C, chunk, n_chunks, vec, ctv, threads
    "rt_moments_f32": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _P],
    # the same launch writing the raw (sum, sum of squares) in place of the
    # statistics (the data-parallel step adds them across ranks)
    "rt_moments_sums_f32": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _P],
    # the host table of (p, m, v, numel, first block, flags, tensor) rows, its
    # row count, the host array of gradient pointers, h
    "rt_adam_f32": [_P, _I, _P, _P, _P],
    # the bf16 entry points (the bf16 sections of conv.cu, matmul.cu,
    # add_relu.cu and moments.cu) take the fp32 ones' arguments; the
    # persistent kernels' entries also the loaders the wrapper names
    # (conv.FWD_ROUTES, conv.DX_ROUTES, matmul.FWD_BF16_ROUTES)
    "rt_conv2d_nhwc_bf16": [_P, _P, _P, *[_I] * 11, _P, _I, _I, _P],
    # g, w (as it lies, not the fp32 entry's phase slices of w^T), dx, ...
    "rt_conv2d_dx_nhwc_bf16": [_P, _P, _P, *[_I] * 11, _P, _I, _I, _P],
    "rt_conv2d_dw_nhwc_bf16": [_P, _P, _P, *[_I] * 11, _P, _I, _P],
    # dW's route on bf16_gemm.cuh for the widths the wgmma core does not take
    "rt_conv2d_dw_nhwc_bf16_mma": [_P, _P, _P, *[_I] * 11, _P, _I, _P],
    # the FC forward for every M, on wgb_gemm.cuh's persistent loop
    "rt_matmul_bf16": [_P, _P, _P, _I64, _I, _I, _P, _I, _I, _P],
    # a, b, g, da (or null), db (or null), M, K, N, da_blocks, db_blocks
    "rt_matmul_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_add_relu_bf16": [_P, _P, _P, _I64, _P],
    "rt_add_relu_mask_bf16": [_P, _P, _P, _P, _I64, _P],
    "rt_moments_bf16": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _P],
    "rt_moments_sums_bf16": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _P],
    # K5, K6, K8 and K9 on bf16 data take the fp32 entries' arguments (their
    # per-channel rows fp32)
    "rt_fused_conv_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _P, _I, _P],
    "rt_fused_join_bf16": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _F, _P],
    "rt_bn_apply_bf16": [_P, _P, _P, _P, _I64, _I, _I, _I, _F, _P],
    "rt_bn_bwd_bf16": [*[_P] * 10, _I64, _I, _I64, _I, _I, _I, _I, _I, _P],
    # K10 on bf16: rt_block_fused_f32's arguments without wsplit (the bf16
    # weights need no split)
    "rt_block_fused_bf16": [*[_P] * 20, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _I, _P],
    "rt_block_fused_stage_bf16": [_I, *[_P] * 20, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I, _I,
                                  _P, _P],
    # K10-bf16's stage GEMM alone, with rt_fused_conv_bf16's arguments: K8's
    # bits witness on the card (tests/test_torch_gpu.py)
    "rt_block_gemm_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _F, _P, _I, _P],
    # the int8 serving kernels (qconv.cu): Q1 x, w (Cout, Kp), dq, bias (or
    # null), out, the split partials and tile tickets (null for one split),
    # N, H, W, Cin, Cout, kh, kw, stride, pad_top, pad_left, Ho, Wo, Kp, mode,
    # has_cap, cap, tile width, splits; Q2 x, q, inv, n
    "rt_qconv_s8": [*[_P] * 7, *[_I] * 15, _F, _I, _I, _P],
    # Q3 x, w (KH * KW, Cout, Cgp), dq, bias (or null), out, N, H, W, Cin,
    # Cout, groups, kh, kw, stride, pad_top, pad_left, Ho, Wo, mode, has_cap,
    # cap, q3_plan's sets a span, images a tile, rows a tile
    "rt_qconv_grouped_s8": [*[_P] * 5, *[_I] * 15, _F, _I, _I, _I, _P],
    "rt_quant_act_f32": [_P, _P, _F, _I64, _P],
    "rt_quant_act_bf16": [_P, _P, _F, _I64, _P],
}
# the entry-point suffix of each tensor dtype the kernels take
SUFFIX = {"torch.float32": "f32", "torch.bfloat16": "bf16"}
# the FMA GEMM core's output tile and K-step (tiled_gemm.cuh BM, BN, BK;
# the FC forward above 32 rows)
GEMM_TILE = 64
GEMM_BK = 16
# the tensor-core core's (tc_gemm.cuh BM, BK, STAGES; BN is tc_tile_n),
# and its kernels' blocks resident per SM by tile width (the conv forward,
# dW, dx, K8 alike):
# 256 threads capped at 128 registers (BN = 64) fit twice, uncapped
# (BN = 128) once (conv.cu, fused_conv.cuh; ptxas, PERF.md)
TC_BM = 128
TC_BK = 32
TC_STAGES = 3
TC_BLOCKS_PER_SM = {64: 2, 128: 1}
# the wgmma core's (wg_gemm.cuh BM, BK; Tile<BN>::STAGES and MIN_BLOCKS by
# tile width, BN = wg_tile_n): K10's three GEMMs
WG_BM = 128
WG_BK = 32
WG_STAGES = {64: 3, 128: 4}
WG_BLOCKS_PER_SM = {64: 2, 128: 1}
# the bf16 wgmma core's (wgb_gemm.cuh BM, BK, Tile<BN>::STAGES and
# MIN_BLOCKS by tile width, BN = wgb_tile_n): K1's bf16 dW and K8-bf16;
# K10-bf16's three GEMMs run K8's tiles and K splits (wgb_split) on its
# warp-specialized persistent loop (wgb::specialized), one block per SM,
# and K1's bf16 forward the same tiles on `persistent`, K split by tc_split
WGB_BM = 128
WGB_BK = 64
WGB_STAGES = {64: 4, 128: 6}
WGB_BLOCKS_PER_SM = {64: 2, 128: 1}
WGB_MIN_SLICES = 8  # the shallowest split, in slices
# Q1's (qconv.cu, int8 on wgb_gemm.cuh's specialized loop): tile height,
# slice depth in bytes, and qconv_plan's costs in tenths of a microsecond by
# tile width: a slice, a unit's epilogue, and an int32 value of a split's
# partial tile
QC_BM = 128
QC_SLICE = 128
QC_SLICE_COST = {64: 2, 128: 3, 256: 4.5}
QC_UNIT_COST = {64: 2, 128: 3, 256: 6}
QC_PARTIAL_COST = 2e-5
# Q3's (qconv.cu Q3_THREADS, Q3_CHUNKS, Q3_SMEM, Q3_BUFS: a block's
# threads, its threads' 16-byte halo copies a tile at most, its shared
# memory, two blocks a SM, its halo buffers) and q3_plan's fixed cost of a
# tile, in bytes of halo or output (its resident blocks Q3_SLOTS below)
Q3_THREADS = 256
Q3_CHUNKS = 8
Q3_SMEM = 115712
Q3_BUFS = 2
Q3_NB_MAX = 4
Q3_TILE_COST = 16384
# dW's 64-pixel slices on the wgmma core: bw x bh rectangles of the output
# grid, in conv.cu dw_box's order of preference
DW_BOXES = ((64, 1), (32, 2), (16, 4), (8, 8), (4, 16), (2, 32), (1, 64))
# the skinny FC kernel's (matmul.cu skinny::COLS, KG, KC_MAX, MAX_M)
SKINNY_COLS = 32
SKINNY_STAGE = 16
SKINNY_MAX_CHUNK = 256
SKINNY_MAX_M = 32
# the FC backward kernel's (matmul.cu bwd::R, MT, NC; TK, TN, MC): a da block
# owns BWD_R rows of b and BWD_MT rows of g over the whole contraction N, in
# slices of BWD_NC columns; a db block a BWD_TK x BWD_TN tile of db over the
# whole contraction M, BWD_MC rows at a time
BWD_R = 16
BWD_MT = 32
BWD_NC = 32
BWD_TK = 64
BWD_TN = 128
BWD_MC = 32
# the bf16 FC backward's (matmul.cu bwd16::R, MT, TK, TN): a da block owns
# BWD16_R columns of da and BWD16_MT rows over the whole contraction N, a db
# block a BWD16_TK x BWD16_TN tile of db over the whole contraction M
BWD16_R = 16
BWD16_MT = 32
BWD16_TK = 128
BWD16_TN = 128
_SMS = 132  # streaming multiprocessors of an H100 SXM
Q3_SLOTS = 2 * _SMS  # Q3's resident blocks, two a SM
# one build at a time in this process (the file lock is per process)
_BUILD_LOCK = threading.Lock()


def find_nvcc() -> str:
    """nvcc on PATH, else under torch's CUDA_HOME; RuntimeError if neither."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under torch.utils.cpp_extension.CUDA_HOME: "
        "the resnet_tpu_torch CUDA kernels cannot be built on this machine"
    )


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkernels-{source_hash()}.so"


def build() -> Path:
    """Compile the library unless this source hash is built already, holding
    the build directory's lock file while it looks and compiles.

    nvcc's report (registers, shared memory, spills per kernel from
    ``-Xptxas -v``) is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()  # raises before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build-lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.is_file():  # another process may have built it meanwhile
            _compile(out, nvcc)
    return out


def _compile(out: Path, nvcc: str) -> None:
    """nvcc each source, all at once, then link ``out`` under a temporary
    name and rename it into place."""
    tag = f"{out.stem}.tmp-{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}-{src.stem}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.so")
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                             for src, obj in zip(sources(), objs))]
        logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for *_, rc in logs):
            done = subprocess.run(link, capture_output=True, text=True)
            logs.append((link, done.stdout + done.stderr, done.returncode))
        report = "\n".join(f"$ {' '.join(cmd)}\n{text}" for cmd, text, _ in logs)
        if len(logs) <= len(objs) or any(rc != 0 for *_, rc in logs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        out.with_suffix(".log").write_text(report)
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with argtypes set; builds it on first use."""
    with _BUILD_LOCK:
        path = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def split_k(m: int, n: int, k: int) -> int:
    """K splits of tiled_gemm.cuh (the FC forward above 32 rows) for an
    (m, n) output over depth k: enough blocks for two per
    SM when the output alone has too few tiles, each split at least 512
    deep, at most 256 splits. Depends on the shapes only, so a call
    repeats exactly."""
    tiles = -(-m // GEMM_TILE) * -(-n // GEMM_TILE)
    if tiles >= _SMS or k <= 512:
        return 1
    splits = min(-(-2 * _SMS // tiles), -(-k // 512), 256)
    return _drop_empty(k, splits, GEMM_BK)


def k_chunk(k: int, splits: int, step: int) -> int:
    """K rows per split as the C launchers compute them: ceil(k / splits)
    rounded up to a whole K-step (tiled_gemm.cuh and tc_gemm.cuh
    k_chunk_for, matmul.cu rt_matmul_skinny_f32)."""
    return -(-(-(-k // splits)) // step) * step


def _drop_empty(k: int, splits: int, step: int) -> int:
    """The split count whose rounded chunks leave none empty."""
    return -(-k // k_chunk(k, splits, step))


def tc_tile_n(n: int) -> int:
    """tc_gemm.cuh's tile width for an N-wide output: 64 up to 64, else 128
    (conv.cu's forward, dW and dx entry points and fused_conv.cuh pick the
    same)."""
    return 64 if n <= 64 else 128


def _waves_plan(m: int, n: int, k: int, bm: int, bn: int, bk: int, resident: int,
                fill: int) -> int:
    """K splits of an (m, n) output over depth k on bm x bn tiles: of the
    counts whose chunks, rounded to whole bk-deep K-steps, keep each split
    at least 16 K-steps deep, at most 256, the one whose blocks finish
    soonest, counted in K-steps: waves of ``resident`` blocks times (chunk
    steps + ``fill``, the ring's fill), fewer splits on a tie."""
    tiles = -(-m // bm) * -(-n // bn)
    best = None
    for splits in range(1, min(256, max(1, -(-k // (16 * bk)))) + 1):
        splits = _drop_empty(k, splits, bk)
        if splits > 1 and k_chunk(k, splits, bk) < 16 * bk:
            continue  # rounding to whole K-steps left the chunks too shallow
        cost = -(-tiles * splits // resident) * (k_chunk(k, splits, bk) // bk + fill)
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


@functools.lru_cache(maxsize=None)
def tc_split(m: int, n: int, k: int) -> int:
    """K splits of an (m, n) output over depth k on tc_gemm.cuh's tiles:
    conv dW (m = k*k*Cin, n = Cout, k = the pixels), conv dx at stride 1
    (m = the pixels, n = Cin, k = k*k*Cout), and the conv forward (fp32;
    bf16 on wgb_gemm.cuh's persistent kernel, which keeps these chunks) and
    the fused conv (m = the output pixels, n = Cout, k = k*k*Cin), planned in
    waves of resident blocks (``_waves_plan``). A function of the shapes
    only (cached), so a call repeats exactly."""
    bn = tc_tile_n(n)
    return _waves_plan(m, n, k, TC_BM, bn, TC_BK, _SMS * TC_BLOCKS_PER_SM[bn], TC_STAGES - 1)


def wg_tile_n(n: int) -> int:
    """wg_gemm.cuh's tile width for an N-wide output: 64 up to 64, else 128
    (block_fused.cu's stage picks the same)."""
    return 64 if n <= 64 else 128


@functools.lru_cache(maxsize=None)
def wg_split(m: int, n: int, k: int) -> int:
    """K splits of one of K10's GEMMs (m = the block's pixels, n = Cout,
    k = k*k*Cin) on wg_gemm.cuh's tiles, planned in waves of its resident
    blocks (``_waves_plan``; the ring holds WG_STAGES slices). A function
    of the shapes only (cached), so a call repeats exactly."""
    bn = wg_tile_n(n)
    return _waves_plan(m, n, k, WG_BM, bn, WG_BK, _SMS * WG_BLOCKS_PER_SM[bn],
                       WG_STAGES[bn] - 1)


def wgb_tile_n(n: int) -> int:
    """wgb_gemm.cuh's tile width for an N-wide output: 64 up to 64, else 128
    (conv.cu's bf16 dW and fused_conv.cuh's bf16 GEMM pick the same)."""
    return 64 if n <= 64 else 128


@functools.lru_cache(maxsize=None)
def wgb_split(m: int, n: int, k: int) -> int:
    """K splits of an (m, n) output over depth k on wgb_gemm.cuh's tiles:
    K1's bf16 dW (m = k*k*Cin, n = Cout, k = 64 x its slices of pixels,
    ``dw_slices``), K8-bf16's GEMM and K10-bf16's three, which keep K8's
    splits on the persistent loop so as to keep its bits (m = the output
    pixels, n = Cout, k = k*k*Cin). Each split is a whole number of WGB_BK-deep
    slices, at least WGB_MIN_SLICES deep, none empty, at most 256. Of
    those, the count that finishes soonest in slice times: waves of the
    resident blocks times (the chunk's slices + the ring's fill), plus, for
    more than one split, the fp32 partials written and read back (m * n *
    8 bytes a split) in slice times of the resident blocks' copies
    ((WGB_BM + BN) * WGB_BK bf16 each); fewer splits on a tie. A function
    of the shapes only (cached), so a call repeats exactly."""
    bn = wgb_tile_n(n)
    slices = -(-k // WGB_BK)
    tiles = -(-m // WGB_BM) * -(-n // bn)
    resident = _SMS * WGB_BLOCKS_PER_SM[bn]
    slice_bytes = resident * (WGB_BM + bn) * WGB_BK * 2
    best = None
    for want in range(1, min(256, max(1, slices // WGB_MIN_SLICES)) + 1):
        chunk = -(-slices // want)
        splits = -(-slices // chunk)  # the count whose chunks leave none empty
        cost = -(-tiles * splits // resident) * (chunk + WGB_STAGES[bn] - 1)
        if splits > 1:
            cost += splits * m * n * 8 / slice_bytes
        if best is None or cost < best[0]:
            best = (cost, splits)
    return best[1]


def wgb_chunks(k: int, splits: int) -> Tuple[int, ...]:
    """The K depth of each split of depth k as the wgmma core cuts it:
    ceil(slices / splits) whole slices each, the last the rest."""
    chunk = -(-(-(-k // WGB_BK)) // splits) * WGB_BK
    return tuple(min(chunk, k - i * chunk) for i in range(splits))


@functools.lru_cache(maxsize=None)
def qconv_plan(m: int, n: int, k: int) -> Tuple[int, int]:
    """(tile width, K splits) of Q1 (qconv.cu) for an (m, n) output over
    its packed depth k (``quant.packed_k``): the candidate with the least
    cost among tile widths 64, 128 and 256 and every split count of whole
    QC_SLICE-deep slices with none empty (splits = ceil(slices / chunk) for
    chunk = ceil(slices / splits)). The cost, in tenths of a microsecond:
    the waves of units (tiles x splits over the SMs) one SM takes, each the
    chunk's slices at QC_SLICE_COST and an epilogue at QC_UNIT_COST by tile
    width, plus, for more than one split, QC_PARTIAL_COST a value of the
    int32 partial tiles written and read back (the constants fitted to
    ``python -m resnet_tpu_torch.kernels.qconv_plans 1 128``'s device times
    of every candidate at batches 8, 1 and 128, PERF.md). On a tie the
    wider tile (fewer bytes through the L2), then fewer splits. A function
    of the shapes only (cached), so a call repeats exactly."""
    slices = -(-k // QC_SLICE)
    best = None
    for bn in (256, 128, 64):
        tiles = -(-m // QC_BM) * -(-n // bn)
        for splits in sorted({-(-slices // c) for c in range(1, slices + 1)}):
            chunk = -(-slices // splits)
            cost = -(-tiles * splits // _SMS) * (chunk * QC_SLICE_COST[bn] + QC_UNIT_COST[bn])
            if splits > 1:
                cost += splits * m * n * QC_PARTIAL_COST
            if best is None or cost < best[0]:
                best = (cost, bn, splits)
    return best[1], best[2]


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _odd16(v: int) -> int:
    """v rounded up to an odd multiple of 16 (qconv.cu q3_odd16)."""
    v = _r16(v)
    return v if v // 16 % 2 else v + 16


def q3_geometry(n: int, cin: int, cout: int, groups: int, kh: int, kw: int, stride: int,
                ho: int, wo: int, f32: bool, aligned: bool, sb: int, ti: int, tr: int):
    """Q3's layout (qconv.cu q3_geometry, the same function) for the plan sb
    sets of column blocks a span, ti images a tile or, at ti = 1, tr output
    rows of one image: a dict of the kernel's derived sizes and its shared
    memory ``smem``, or None where the kernel does not take the plan (it
    would not fit Q3_SMEM, or the shapes leave it nothing to cover)."""
    cg, ng = cin // groups, cout // groups
    ncb = -(-cout // 8)
    glo = [8 * cb // ng for cb in range(ncb)]
    wg = max(min(8 * cb + 7, cout - 1) // ng - glo[cb] + 1 for cb in range(ncb))
    if sb < 1 or ti < 1 or tr < 1 or tr > ho or ti > n or (ti > 1 and tr != ho):
        return None
    for dense in ((True, False) if aligned and cin % 16 == 0 and cg % 4 == 0 else (False,)):
        cgs = cg if dense else _r16(cg)
        if dense and wg * cgs <= 8 and all(g * cgs % 8 == 0 for g in glo):
            wb = 8
        elif not dense or all(g * cgs % 16 == 0 for g in glo):
            wb = _r16(wg * cgs)
        else:
            continue
        pair = wb == 8
        taps, words = kh * kw, wb // 4
        ks = kh * -(-kw // 4) if pair else -(-taps * words // 8)
        nb = 1
        if not pair and ng % 8 == 0:
            nb = next(d for d in (4, 2, 1) if ng // 8 % d == 0 and d <= Q3_NB_MAX)
        mt = 4 if nb == 1 else 2
        sets = ncb // nb
        if sb > sets:
            return None
        cbs = sb * nb
        spans = -(-sets // sb)
        spb = 0
        for s in range(spans):
            c0 = glo[s * cbs] * cgs // 16 * 16
            spb = max([spb] + [glo[cb] * cgs + wb - c0
                               for cb in range(s * cbs, min(s * cbs + cbs, ncb))])
        spb = _r16(spb)
        pitch = _odd16(spb)
        hr, hc = (tr - 1) * stride + kh, (wo - 1) * stride + kw
        hpx, tp = ti * hr * hc, ti * tr * wo
        mtiles = -(-tp // 16)
        if dense and (hpx * (spb // 16) > Q3_THREADS * Q3_CHUNKS or ti > 1023 or hr > 255
                      or hc > 2047 or spb > 128):
            continue
        ncols = cbs * 8
        opitch = _odd16(ncols * (4 if f32 else 2))
        halo = -(-hpx * pitch // 128) * 128
        rows = -(-mtiles // mt) * mt * 16  # the staged tile's rows: every row computed
        smem = (Q3_BUFS * halo + cbs * ks * 256 + _r16(rows * opitch) + 8 * ncols + 16 * ks
                + 4 * rows)
        if smem > Q3_SMEM:
            return None
        rt = -(-ho // tr)
        return {"dense": dense, "group_bytes": cgs, "window_bytes": wb,
                "loads": "pair" if pair else "ldmatrix", "nb": nb, "ks": ks, "cbs": cbs,
                "spans": spans, "span_bytes": spb, "halo_pixels": hpx, "tile_pixels": tp,
                "m_tiles": mtiles, "tiles": -(-n // ti) if ti > 1 else n * rt, "row_tiles": rt,
                "smem": smem}
    return None


@functools.lru_cache(maxsize=None)
def q3_plan(n: int, cin: int, cout: int, groups: int, kh: int, kw: int, stride: int, ho: int,
            wo: int, f32: bool, aligned: bool) -> Tuple[int, int, int]:
    """(sb, ti, tr), Q3's plan: the span the fewest sets whose windows
    cover 32 bytes of a pixel (a full sector of x; all sets if fewer), then
    the tile, tr output rows of an image or ti whole images, of least cost
    among those that fit: the tiles one of Q3_SLOTS resident blocks takes,
    plus one (the first tile's copies overlap nothing), times a tile's halo
    and output bytes plus Q3_TILE_COST (fitted to the card's times of
    phase 3's plans); on a tie the larger tile. A function of the shapes
    and of x's alignment only (cached); None where no plan fits (rows too
    wide for shared memory)."""
    args = (n, cin, cout, groups, kh, kw, stride, ho, wo, f32, aligned)
    ng, sb = cout // groups, 1
    while True:
        g = q3_geometry(*args, sb, 1, 1)
        if g is None or g["cbs"] * 8 >= cout:
            break
        # the bytes a pixel's first span reads: its column blocks' windows
        last = 8 * (g["cbs"] - 1) // ng
        if last * g["group_bytes"] + g["window_bytes"] >= 32:
            break
        sb += 1
    if g is None:
        sb = max(1, sb - 1)
    best = None
    for ti, tr in [(1, tr) for tr in range(1, ho + 1)] + [(ti, ho) for ti in range(2, n + 1)]:
        g = q3_geometry(*args, sb, ti, tr)
        if g is None:
            continue
        units = g["spans"] * g["tiles"]
        cost = (-(-units // Q3_SLOTS) + 1) * (g["halo_pixels"] * g["span_bytes"]
                                              + g["tile_pixels"] * g["cbs"] * 8 * (4 if f32 else 2)
                                              + Q3_TILE_COST)
        key = (cost, -g["tile_pixels"])
        if best is None or key < best[0]:
            best = (key, (sb, ti, tr))
    return None if best is None else best[1]


def dw_box(ho: int, wo: int) -> Tuple[int, int]:
    """(bw, bh): the 64-pixel rectangle of DW_BOXES that tiles an ho x wo
    output grid with the fewest padded pixels, the first on a tie (conv.cu
    dw_box)."""
    return min(DW_BOXES, key=lambda b: -(-wo // b[0]) * b[0] * (-(-ho // b[1]) * b[1]))


@functools.lru_cache(maxsize=None)
def dw_slices(n: int, ho: int, wo: int, k: int, stride: int, flat: bool = True) -> int:
    """The 64-pixel slices of K1's bf16 dW on the wgmma core: a 1x1 conv at
    stride 1 on a ``flat`` window grid (no padding, the input's own; conv.cu
    dw_flat) reads its n*ho*wo pixels in a row, any other conv a dw_box
    rectangle of one image at a time (conv.cu dw_wg). Cached: a function of
    the shapes only."""
    if k == 1 and stride == 1 and flat:
        return -(-n * ho * wo // 64)
    bw, bh = dw_box(ho, wo)
    return n * -(-wo // bw) * -(-ho // bh)


def kmajor_ld(k: int) -> int:
    """The row stride of a K-major split weight (block_fused.cu kmajor_ld):
    k rounded up to a multiple of 4 floats, as TMA takes 16-byte strides."""
    return -(-k // 4) * 4


def skinny_split(m: int, n: int, k: int) -> int:
    """K splits of the skinny FC kernel (1 <= m <= 32) over depth k for an
    n-wide output:
    enough (slabs of 32 columns) x (splits) blocks for two per SM, each
    chunk at most 256 rows (A's chunk fits in shared memory) and at least
    one 16-row stage. Depends on the shapes only."""
    if k <= 0:
        return 1
    slabs = -(-n // SKINNY_COLS)
    splits = max(-(-2 * _SMS // slabs), -(-k // SKINNY_MAX_CHUNK))
    splits = min(splits, -(-k // SKINNY_STAGE))
    return _drop_empty(k, splits, SKINNY_STAGE)


def matmul_bwd_plan(m: int, k: int, n: int, need_a: bool = True, need_b: bool = True
                    ) -> Tuple[int, int]:
    """(da blocks, db blocks) of rt_matmul_bwd_f32 for a (m, k), b (k, n),
    g (m, n): ceil(k / BWD_R) slabs of b's rows times ceil(m / BWD_MT) row
    tiles of g for da = g @ b^T, ceil(k / BWD_TK) x ceil(n / BWD_TN) tiles
    for db = a^T @ g; 0 for a product that is not needed. Each block runs its
    whole contraction in one fixed order, so nothing is split and a call
    repeats exactly. Block i < da blocks is slab i % slabs, row tile
    i // slabs; block da blocks + t is db tile (t // n tiles, t % n tiles)."""
    da = -(-k // BWD_R) * -(-m // BWD_MT) if need_a else 0
    db = -(-k // BWD_TK) * -(-n // BWD_TN) if need_b else 0
    return da, db


def matmul_bwd_plan_bf16(m: int, k: int, n: int, need_a: bool = True, need_b: bool = True
                         ) -> Tuple[int, int]:
    """(da blocks, db blocks) of rt_matmul_bwd_bf16 for a (m, k), b (k, n),
    g (m, n): ceil(k / BWD16_R) slabs of da's columns times ceil(m /
    BWD16_MT) row tiles for da = g @ b^T, ceil(k / BWD16_TK) x ceil(n /
    BWD16_TN) tiles for db = a^T @ g; 0 for a product that is not needed.
    The FC at batch 32 is 128 + 128 blocks. Each block runs its whole
    contraction in one fixed order: a call repeats exactly. Block i < da
    blocks is slab i % slabs, row tile i // slabs; block da blocks + t is db
    tile (t // n tiles, t % n tiles)."""
    da = -(-k // BWD16_R) * -(-m // BWD16_MT) if need_a else 0
    db = -(-k // BWD16_TK) * -(-n // BWD16_TN) if need_b else 0
    return da, db


def gemm_workspace(splits: int, m: int, n: int, like):
    """(pointer, tensor) of the split-K partials; (None, None) for 1 split.
    Keep the tensor alive until the launch is enqueued."""
    import torch

    if splits == 1:
        return None, None
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=like.device)
    return ws.data_ptr(), ws


def aligned16(*tensors) -> bool:
    """Whether every tensor's data start on a 16-byte boundary, as the
    kernels' 16-byte copies and TMA boxes need (a new output always does)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def on_card(name: str, *tensors, bf16: bool = True, rows=()) -> bool:
    """Validate a wrapper's inputs; True to launch the kernel, False to run
    the plain version (CPU tensors only).

    Raises on anything the kernels do not take: a dtype other than fp32 or
    (with ``bf16``) bfloat16, tensors of two dtypes, a non-contiguous
    tensor, mixed devices, a device other than CPU or CUDA. ``rows`` are
    per-channel rows, which the kernels read as fp32 whatever the
    tensors' dtype (``rows_f32``)."""
    import torch

    dev, dtype = tensors[0].device, tensors[0].dtype
    allowed = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if dtype not in allowed:
        raise TypeError(f"{name}: expected {' or '.join(map(str, allowed))}, got {dtype}")
    for t, want in (*((t, dtype) for t in tensors), *((r, torch.float32) for r in rows)):
        if t.dtype != want:
            raise TypeError(f"{name}: tensors of {want} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def rows_f32(*rows):
    """Per-channel rows as the kernels read them: fp32, contiguous. The
    Pallas kernels take theirs through ``jnp.asarray(v, jnp.float32)``
    (bn.py:210, fused_conv.py:170-175, :536-538, block_fused.py:281), so a bf16 row
    (a bf16 parameter's gamma) is cast, and an fp32 one passes as it is
    (without a dispatch: the check alone is cheaper)."""
    import torch

    return tuple(r if r.dtype == torch.float32 and r.is_contiguous()
                 else r.to(torch.float32).contiguous() for r in rows)


def entry_name(base: str, t) -> str:
    """The C entry point ``base`` for tensors of t's dtype: rt_<base>_f32 or
    rt_<base>_bf16."""
    return f"rt_{base}_{SUFFIX[str(t.dtype)]}"


def count(module: str, counter: str, t) -> None:
    """Add one to the launch counter ``counter`` of the kernel module named
    ``module`` for a launch on tensors of t's dtype: ``counter`` itself for
    fp32, ``counter + "_BF16"`` for bfloat16 (``entry_name``'s choice)."""
    mod = sys.modules[module]
    name = counter + ("_BF16" if SUFFIX[str(t.dtype)] == "bf16" else "")
    setattr(mod, name, getattr(mod, name) + 1)


@functools.cache
def entry(name: str):
    """The library's C entry point ``name``, argtypes set."""
    return getattr(load(), name)


def launch_on(index: int, stream: int, fn, *args) -> None:
    """Call the C entry point ``fn`` (``entry``) with ``args`` and the raw
    ``stream`` handle of CUDA device ``index``; raise if it reports a CUDA
    error. The device is switched only when it is not the current one."""
    import torch

    if index == torch._C._cuda_getDevice():
        status = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {status} at launch")


def launch(name: str, *args, device) -> None:
    """Call a C entry point on ``device``'s current stream; raise if it
    reports a CUDA error. The stream is read as a raw handle: a Python
    stream object and a device guard on every launch add host time that a
    small kernel (the FC) waits behind."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    launch_on(index, torch._C._cuda_getCurrentRawStream(index), entry(name), *args)
