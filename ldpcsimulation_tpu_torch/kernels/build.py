"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so one ``nvcc`` call
(seconds, no PyTorch headers) compiles them for Hopper into a shared library
under ``build/torch_kernels/`` at the checkout root.  The library's name
carries a hash of the sources and flags, so an edited source is never
served by a stale build.  Nothing is built when this module is imported:
the first kernel launch builds, and CPU tensors never reach this module.

Every C entry returns the ``cudaGetLastError()`` of its launch (0 when
clean); :func:`check` raises on anything else.  ``LAUNCHES`` counts each
kernel's launches, so a run can show that its main path went through them.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["LAUNCHES", "BUILD_DIR", "build", "library", "check", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("awgn_philox.cu", "minsum_cn_scan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel name, counted by each wrapper where it launches
LAUNCHES: collections.Counter = collections.Counter()

_LIB = None
_P = ctypes.c_void_p


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME)"
        )
    return found


def build() -> tuple[Path, str, float]:
    """Compile the kernels (if this exact build is not there yet).

    Returns (library path, compiler log, seconds spent compiling — 0 when
    the library was already built)."""
    paths = [CSRC / s for s in SOURCES] + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libldpc_torch_kernels_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp)]
    cmd += [str(CSRC / s) for s in SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, log, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.ldpc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
        lib.ldpc_awgn_philox.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, _P, _P, ctypes.c_int, _P,
        ]
        lib.ldpc_awgn_philox.restype = ctypes.c_int
        lib.ldpc_minsum_cn_scan.argtypes = [
            _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            _P, ctypes.c_int, _P,
        ]
        lib.ldpc_minsum_cn_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().ldpc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
