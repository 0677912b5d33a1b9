"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into a shared library
with a plain C interface (no PyTorch headers, no ninja):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/resnet_tpu_torch/libkernels-<hash>.so *.o

``<hash>`` covers every source and header, so an edited kernel rebuilds and
an unchanged one is reused. The library is written under a temporary name
and moved into place, so concurrent builds are safe. It is loaded with
ctypes; every pointer and the stream are passed as ``c_void_p``, and each
entry point returns ``cudaGetLastError()`` after its launch. A float
argument is a ``c_float``.

There is no fallback: without nvcc, ``load()`` raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
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
    # b, bs, K, N: K10's K-major tf32 split of one weight
    "rt_split_tf32_f32": [_P, _P, _I, _I, _P],
    "rt_bn_apply_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _F, _P],
    "rt_bn_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I64, _I, _I, _P],
    # GEMMs: ..., workspace, splits (split-K, see tiled_gemm.cuh)
    "rt_conv2d_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_conv2d_dx_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_conv2d_dw_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_matmul_f32": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "rt_matmul_skinny_f32": [_P, _P, _P, _I, _I, _I, _P, _I, _P],
    # a, b, g, da (or null), db (or null), M, K, N, da_blocks, db_blocks
    "rt_matmul_bwd_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_add_relu_f32": [_P, _P, _P, _I64, _P],
    "rt_add_relu_mask_f32": [_P, _P, _P, _P, _I64, _P],
    # x, part, tickets, stats, M, C, chunk, n_chunks, vec, ctv, threads
    "rt_moments_f32": [_P, _P, _P, _P, _I64, _I, _I64, _I, _I, _I, _I, _P],
    # the host table of (p, m, v, numel, first block, flags, tensor) rows, its
    # row count, the host array of gradient pointers, h
    "rt_adam_f32": [_P, _I, _P, _P, _P],
}
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
_SMS = 132  # streaming multiprocessors of an H100 SXM
# one build at a time in this process (the temporary name is per process)
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
    """Compile the library unless this source hash is built already.

    nvcc's report (registers, shared memory, spills per kernel from
    ``-Xptxas -v``) is kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return out


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
    (m = the pixels, n = Cin, k = k*k*Cout), and the conv forward and the
    fused conv (m = the output pixels, n = Cout, k = k*k*Cin), planned in
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


def gemm_workspace(splits: int, m: int, n: int, like):
    """(pointer, tensor) of the split-K partials; (None, None) for 1 split.
    Keep the tensor alive until the launch is enqueued."""
    import torch

    if splits == 1:
        return None, None
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=like.device)
    return ws.data_ptr(), ws


def on_card(name: str, *tensors) -> bool:
    """Validate a wrapper's inputs; True to launch the kernel, False to run
    the plain version (CPU tensors only).

    Raises on anything the kernels do not take: a dtype other than fp32, a
    non-contiguous tensor, mixed devices, a device other than CPU or CUDA."""
    import torch

    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


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
