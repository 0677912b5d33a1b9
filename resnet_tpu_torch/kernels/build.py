"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources compile with nvcc in one call into a shared
library with a plain C interface (no PyTorch headers, no ninja):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/resnet_tpu_torch/libkernels-<hash>.so csrc/*.cu

``<hash>`` covers every source and header, so an edited kernel rebuilds and
an unchanged one is reused. The library is written under a temporary name
and moved into place, so concurrent builds are safe. It is loaded with
ctypes; every pointer and the stream are passed as ``c_void_p``, and each
entry point returns ``cudaGetLastError()`` after its launch.

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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# entry point -> argtypes; the last argument of each is the CUDA stream
SIGNATURES = {
    "rt_conv2d_nhwc_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_matmul_f32": [_P, _P, _P, _I64, _I, _I, _P],
    "rt_add_relu_f32": [_P, _P, _P, _I64, _P],
}
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
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
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


def on_card(name: str, *tensors) -> bool:
    """Validate a wrapper's inputs; True to launch the kernel, False to run
    the plain version (CPU tensors only).

    Raises on anything the kernels do not take: a dtype other than fp32, a
    non-contiguous tensor, mixed devices, a device other than CPU or CUDA,
    and a CUDA tensor that requires grad (the kernels are forward only)."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; its backward comes "
            "with the training step (ROADMAP.md queue A, item A2)"
        )
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
