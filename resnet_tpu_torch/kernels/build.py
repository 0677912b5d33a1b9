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
    "rt_bn_apply_f32": [_P, _P, _P, _P, _I64, _I, _I, _I, _F, _P],
    "rt_bn_bwd_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I64, _I, _I, _P],
    # GEMMs: ..., workspace, splits (split-K, see tiled_gemm.cuh)
    "rt_conv2d_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_conv2d_dx_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_conv2d_dw_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "rt_matmul_f32": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "rt_matmul_nt_f32": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "rt_matmul_tn_f32": [_P, _P, _P, _I64, _I, _I, _P, _I, _P],
    "rt_add_relu_f32": [_P, _P, _P, _I64, _P],
    "rt_add_relu_mask_f32": [_P, _P, _P, _P, _I64, _P],
    "rt_moments_f32": [_P, _P, _P, _P, _I64, _I, _I64, _I, _P],
    "rt_adam_f32": [_P, _I, _I, _P, _P],
}
# the GEMM core's output tile and K-step (tiled_gemm.cuh BM, BN, BK)
GEMM_TILE = 64
GEMM_BK = 16
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
    """K splits for an (m, n) output over depth k: enough blocks for two per
    SM when the output alone has too few tiles, each split at least 512
    deep, at most 256 splits. Depends on the shapes only, so a call
    repeats exactly."""
    tiles = -(-m // GEMM_TILE) * -(-n // GEMM_TILE)
    if tiles >= _SMS or k <= 512:
        return 1
    splits = min(-(-2 * _SMS // tiles), -(-k // 512), 256)
    # drop splits that the rounded chunk (tiled_gemm.cuh k_chunk_for) leaves empty
    chunk = -(-k // splits)
    chunk = -(-chunk // GEMM_BK) * GEMM_BK
    return -(-k // chunk)


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


def launch(entry: str, *args, device) -> None:
    """Call a C entry point on ``device``'s current stream; raise if it
    reports a CUDA error."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        status = getattr(load(), entry)(*args, stream)
    if status != 0:
        raise RuntimeError(f"{entry}: CUDA error {status} at launch")
