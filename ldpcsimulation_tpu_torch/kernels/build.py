"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them for Hopper in seconds (no PyTorch headers): one compiler process per
source, all started together, then one link into a shared library under
``build/torch_kernels/`` at the checkout root.  The library's name
carries a hash of the sources and flags, so an edited source is never
served by a stale build.  Nothing is built when this module is imported:
the first kernel launch builds, and CPU tensors never reach this module.

Every C entry returns the ``cudaGetLastError()`` of its launch (0 when
clean); :func:`check` raises on anything else.  ``LAUNCHES`` counts each
kernel's launches, so a run can show that its main path went through them;
``PATHS`` counts the Philox kernels' launches by ``(name, "fast" | "tail")``,
the instance their C entry chose (wide stores, or the scalar tail), the
decision merge's by ``("et_merge", "wide" | "tail")``, the layer step's by
``("minsum_layer_step", lanes)``, and the bit-flip
decoder's steps by ``("gdbf_step", "chunk" | "loop")``, the path that
issued them (on every device: the CPU's chunks are plain twins).
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

__all__ = ["LAUNCHES", "PATHS", "BUILD_DIR", "build", "library", "check",
           "launch_philox", "stream_of"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("awgn_philox.cu", "bp_cn_pair.cu", "bp_vn_update.cu",
           "et_merge.cu", "gdbf_chunk.cu", "gdbf_step.cu",
           "minsum_cn_scan.cu", "minsum_layer_step.cu", "minsum_vn_update.cu",
           "parity_check.cu", "uniform_philox.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: launches per kernel name, counted by each wrapper where it launches
LAUNCHES: collections.Counter = collections.Counter()
#: launches per (kernel name, instance: "fast" or "tail"; B10 "wide" or
#: "tail"; B11 its lanes a thread)
PATHS: collections.Counter = collections.Counter()

_LIB = None
_P = ctypes.c_void_p
_INT_P = ctypes.POINTER(ctypes.c_int)


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
    objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
             str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    log = "".join(p.communicate()[0] for p in procs)
    rcs = [p.returncode for p in procs]
    if not any(rcs):
        link = subprocess.run(
            [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        rcs.append(link.returncode)
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log_path.write_text(log)
    if any(rcs):
        raise RuntimeError(f"nvcc failed (exit codes {rcs}):\n{log}")
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
            ctypes.c_int64, ctypes.c_float, _P, _P, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_awgn_philox.restype = ctypes.c_int
        lib.ldpc_minsum_cn_scan.argtypes = [
            _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, _P, ctypes.c_int, ctypes.c_int, _P,
        ]
        lib.ldpc_minsum_cn_scan.restype = ctypes.c_int
        lib.ldpc_minsum_layer_step.argtypes = [
            _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, _P, ctypes.c_int, _P,
        ]
        lib.ldpc_minsum_layer_step.restype = ctypes.c_int
        lib.ldpc_bp_cn_pair.argtypes = [
            _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
        ]
        lib.ldpc_bp_cn_pair.restype = ctypes.c_int
        lib.ldpc_bp_vn_update.argtypes = [
            _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_float, ctypes.c_int, _P, _P,
            ctypes.c_int, ctypes.c_int, _P,
        ]
        lib.ldpc_bp_vn_update.restype = ctypes.c_int
        lib.ldpc_minsum_vn_update.argtypes = [
            _P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P, ctypes.c_int, _P,
        ]
        lib.ldpc_minsum_vn_update.restype = ctypes.c_int
        lib.ldpc_parity_check.argtypes = [
            _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, _P,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P, _P, ctypes.c_int,
            _P,
        ]
        lib.ldpc_parity_check.restype = ctypes.c_int
        lib.ldpc_et_merge.argtypes = [
            _P, ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
        ]
        lib.ldpc_et_merge.restype = ctypes.c_int
        lib.ldpc_gdbf_parallel_step.argtypes = [
            _P, ctypes.c_int, _P, _P, _P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, _P, _P, _P, ctypes.c_float, _P, _P, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, _P,
        ]
        lib.ldpc_gdbf_parallel_step.restype = ctypes.c_int
        lib.ldpc_gdbf_chunk.argtypes = [
            _P, ctypes.c_int64, ctypes.c_int, _P, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, _P, ctypes.c_int, _P, _P, _P, _P,
            _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_float, ctypes.c_float, _P, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_gdbf_chunk.restype = ctypes.c_int
        draw = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint32, ctypes.c_int]
        lib.ldpc_uniform_philox.argtypes = draw + [
            _P, _P, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_uniform_philox.restype = ctypes.c_int
        lib.ldpc_gauss_philox.argtypes = draw + [
            ctypes.c_float, ctypes.c_float, _P, _P, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_gauss_philox.restype = ctypes.c_int
        lanes = [ctypes.c_uint64, _P, _P, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_uint32, ctypes.c_int]
        lib.ldpc_uniform_philox_lanes.argtypes = lanes + [
            _P, _P, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_uniform_philox_lanes.restype = ctypes.c_int
        lib.ldpc_gauss_philox_lanes.argtypes = lanes + [
            ctypes.c_float, ctypes.c_float, _P, _P, ctypes.c_int, _P, _INT_P,
        ]
        lib.ldpc_gauss_philox_lanes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = library().ldpc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def launch_philox(entry: str, name: str, *args) -> None:
    """Call a Philox kernel's C entry, raise on a CUDA error, and count the
    launch in ``LAUNCHES`` and its instance in ``PATHS`` (an empty shape
    launches nothing and counts nothing)."""
    fast = ctypes.c_int(-1)
    rc = getattr(library(), entry)(*args, ctypes.byref(fast))
    check(rc, name)
    if fast.value < 0:
        return
    LAUNCHES[name] += 1
    PATHS[name, "fast" if fast.value else "tail"] += 1


def stream_of(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
