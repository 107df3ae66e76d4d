"""ctypes bindings to the framework-free C++ tier (``native/ldpcnative.cpp``):
the PEG construction and the alist tokenizer.

Counterpart of ``ldpcsimulation_tpu.native``.  At first use the source is
compiled with ``g++ -O2 -shared -fPIC`` into ``build/torch_native/`` at the
checkout root (the source is only read); the library's name carries a hash
of the source and flags, and it is built under a temporary name and renamed,
so concurrent first uses cannot load a half-written file.  There is no
fallback: the Python PEG draws another random stream and would build a
different code under the same name, so a missing compiler raises
(:func:`available` says beforehand whether the library builds).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from .codes.alist import Alist

__all__ = ["SOURCE", "BUILD_DIR", "available", "build", "peg_native",
           "parse_alist_native"]

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "ldpcnative.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"the native PEG needs a C++ compiler ({cxx!r} not found; set "
            "CXX): without it the codes built by the native PEG "
            "(regular codes with n > 2000) cannot be constructed"
        )
    return found


def build() -> Path:
    """Compile the library if this exact build is not there yet; return its
    path."""
    src = SOURCE.read_bytes()
    h = hashlib.sha256(" ".join(FLAGS).encode() + src).hexdigest()[:16]
    out = BUILD_DIR / f"libldpcnative_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [_compiler(), *FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native PEG failed (exit {res.returncode}):\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def _get() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.peg_construct.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
            ]
            lib.peg_construct.restype = ctypes.c_int
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.alist_parse_fill.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, i32p,
                i32p, i32p,
            ]
            lib.alist_parse_fill.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built or builds here (a missing or failing
    compiler gives False; nothing is raised)."""
    try:
        _get()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


def peg_native(n: int, m: int, dv: int, seed: int = 0) -> Alist:
    """PEG construction in C++ (the same algorithm family as
    :func:`.codes.construct.peg`, with its own RNG stream: the same seed
    gives another code than the Python PEG, and the same code as the JAX
    package's native PEG)."""
    out = np.zeros(n * dv, np.int32)
    rc = _get().peg_construct(
        n, m, dv, seed, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    if rc != 0:
        raise RuntimeError(f"peg_construct failed rc={rc}")
    nlist: List[List[int]] = [
        sorted(int(c) for c in out[v * dv : (v + 1) * dv]) for v in range(n)
    ]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for v in range(n):
        for c in nlist[v]:
            mlist[c].append(v)
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def parse_alist_native(text: str, nonbinary: bool = False) -> Alist:
    """Alist parse through the C++ tokenizer: the lists
    :func:`.codes.alist.parse_alist` gives (padded or unpadded adjacency;
    a header of three integers, or ``nonbinary``, reads a GF(q) file with
    its coefficients).  The JAX package's binding, argument for
    argument."""
    raw = text.encode()
    head = text.split("\n", 2)
    h0 = [int(x) for x in head[0].split()]
    if nonbinary or len(h0) >= 3:
        nonbinary = True
        n, m, q = h0[:3]
    else:
        n, m = h0[:2]
        q = 0
    h1 = [int(x) for x in head[1].split()]
    dv_max, dc_max = h1[0], h1[1]
    i32 = ctypes.POINTER(ctypes.c_int32)
    n_deg = np.zeros(n, np.int32)
    m_deg = np.zeros(m, np.int32)
    n_idx = np.zeros(n * dv_max, np.int32)
    n_val = np.zeros(n * dv_max, np.int32)
    m_idx = np.zeros(m * dc_max, np.int32)
    m_val = np.zeros(m * dc_max, np.int32)
    rc = _get().alist_parse_fill(
        raw, len(raw), 1 if nonbinary else 0, n, m, dv_max, dc_max, q,
        n_deg.ctypes.data_as(i32), m_deg.ctypes.data_as(i32),
        n_idx.ctypes.data_as(i32), n_val.ctypes.data_as(i32),
        m_idx.ctypes.data_as(i32), m_val.ctypes.data_as(i32),
    )
    if rc != 0:
        raise ValueError(f"alist_parse_fill failed rc={rc}")
    n_idx = n_idx.reshape(n, dv_max)
    n_val = n_val.reshape(n, dv_max)
    m_idx = m_idx.reshape(m, dc_max)
    m_val = m_val.reshape(m, dc_max)
    nlist = [[int(x) for x in n_idx[v, : n_deg[v]]] for v in range(n)]
    mlist = [[int(x) for x in m_idx[c, : m_deg[c]]] for c in range(m)]
    nvals: Optional[List[List[int]]] = None
    mvals: Optional[List[List[int]]] = None
    if nonbinary:
        nvals = [[int(x) for x in n_val[v, : n_deg[v]]] for v in range(n)]
        mvals = [[int(x) for x in m_val[c, : m_deg[c]]] for c in range(m)]
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist, q=q, nvals=nvals,
                 mvals=mvals)
