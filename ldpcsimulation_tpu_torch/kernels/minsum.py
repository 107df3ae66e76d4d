"""Kernel B1: min-sum check-node update with the routing inside
(``csrc/minsum_cn_scan.cu``).

Port of ``ldpcsimulation_tpu.kernels.minsum_pallas.minsum_cn_scan_pallas``.
The TPU kernel scanned pre-gathered ``[M, dc_max, B]`` blocks; this one
reads check ``c``'s slot ``t`` from row ``cn_rows[c, t]`` of the message
planes ``v2c [R, B]`` and writes that slot's output to the same row of
``c2v [R, B]`` (f32).  ``cn_rows`` holds −1 for an absent slot; every other
entry must lie in [0, R) and name its row only once (the kernel does not
check: the tables come from ``decoders.minsum_qc.qc_plan`` and
``decoders.minsum.minsum_plan``, which build them so).  A row that no check
names is left unwritten (``torch.empty``): the callers zero it themselves
(the slot-array decoder's padding slots, the QC decoder's absent edges).
The kernel takes any M and ``dc_max`` up to 64, as the Pallas kernel's
tiles can hold; a table of more than 65535 checks takes one grid per 65535
(still one call, one count in ``LAUNCHES``).  Each thread takes several
contiguous batch lanes: :func:`lane_width` picks the kernel instance from
the batch, the storage type and the pointers' alignment.

:func:`minsum_cn_scan` launches the kernel for CUDA tensors and runs
:func:`minsum_cn_scan_plain` for CPU tensors.  Both are exact: the scan only
selects stored values, and the variant post-op is one correctly rounded
operation in the storage precision.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["VARIANTS", "LANES", "minsum_cn_scan", "minsum_cn_scan_plain",
           "in_storage", "lane_width"]

#: variant name -> id passed to the kernel
VARIANTS = {"plain": 0, "normalized": 1, "offset": 2}
#: lanes per thread of the kernel's instances (f16 and f32), widest first
LANES = (4, 2, 1)
_MAX_DC = 64  # the most slots a check's sign mask holds


def lane_width(batch: int, dtype: torch.dtype, v2c_ptr: int,
               c2v_ptr: int) -> int:
    """Lanes per thread of the instance that takes a call: the widest
    whose vector accesses stay aligned — ``batch`` a multiple of it, the
    v2c address of its load (lanes × element bytes) and the c2v address of
    its f32 stores (lanes × 4 bytes, at most 16)."""
    size = torch.finfo(dtype).bits // 8
    for lanes in LANES[:-1]:
        if (batch % lanes == 0 and v2c_ptr % (lanes * size) == 0
                and c2v_ptr % min(lanes * 4, 16) == 0):
            return lanes
    return 1  # takes any call


def in_storage(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` — what the JAX decoder's weakly
    typed ``alpha``/``delta`` become next to storage-typed messages."""
    return float(torch.tensor(x, dtype=dtype))


def _check(v2c, cn_rows, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")
    if v2c.dim() != 2 or v2c.dtype not in (torch.float16, torch.float32):
        raise ValueError(f"v2c must be [R, B] f16/f32, got "
                         f"{tuple(v2c.shape)} {v2c.dtype}")
    if cn_rows.dim() != 2 or cn_rows.dtype != torch.int32:
        raise ValueError(f"cn_rows must be [M, dc_max] int32, got "
                         f"{tuple(cn_rows.shape)} {cn_rows.dtype}")
    if cn_rows.device != v2c.device:
        raise ValueError(f"cn_rows on {cn_rows.device}, v2c on {v2c.device}")
    if not (v2c.is_contiguous() and cn_rows.is_contiguous()):
        raise ValueError("v2c and cn_rows must be contiguous")


def _post_op(out, variant, alpha, delta, sdt):
    """Variant post-op on f32 values, each result rounded to ``sdt``."""
    if variant == "normalized":
        # divide by a device tensor: a Python-scalar divisor would let the
        # CUDA division run as a multiply by its reciprocal (not exact)
        a = torch.tensor(alpha, dtype=torch.float32, device=out.device)
        return (out / a).to(sdt).float()
    if variant == "offset":
        m2 = (out.abs() - delta).to(sdt).float()
        return torch.where(
            m2 > 0, torch.where(out >= 0, m2, -m2), torch.zeros_like(out)
        )
    return out


def minsum_cn_scan_plain(v2c, cn_rows, variant="plain", alpha=1.0,
                         delta=0.0):
    """Plain PyTorch twin of the kernel (same scan, same outputs)."""
    _check(v2c, cn_rows, variant)
    sdt = v2c.dtype
    alpha, delta = in_storage(alpha, sdt), in_storage(delta, sdt)
    m, dc = cn_rows.shape
    b = v2c.shape[1]
    valid = cn_rows >= 0
    rows = cn_rows.clamp(min=0).long()
    msgs = v2c[rows].float()  # [M, dc, B]
    min1 = torch.full((m, b), float("inf"), device=v2c.device)
    min2 = torch.full((m, b), float("inf"), device=v2c.device)
    minidx = torch.full((m, b), -1, dtype=torch.int32, device=v2c.device)
    sprod = torch.ones((m, b), device=v2c.device)
    for t in range(dc):
        msg = msgs[:, t]
        ok = valid[:, t, None]
        a = msg.abs()
        sprod = torch.where(ok, sprod * torch.where(msg >= 0, 1.0, -1.0),
                            sprod)
        is_min = ok & (a <= min1)
        min2 = torch.where(is_min, min1,
                           torch.where(ok & (a < min2), a, min2))
        minidx = torch.where(is_min, t, minidx)
        min1 = torch.where(is_min, a, min1)
    c2v = torch.empty(v2c.shape, dtype=torch.float32, device=v2c.device)
    for t in range(dc):
        msg = msgs[:, t]
        mag = torch.where(minidx == t, min2, min1)
        out = sprod * mag * torch.where(msg >= 0, 1.0, -1.0)
        out = _post_op(out, variant, alpha, delta, sdt)
        ok = valid[:, t]
        c2v[rows[ok, t]] = out[ok]
    return c2v


def minsum_cn_scan(v2c, cn_rows, variant="plain", alpha=1.0, delta=0.0):
    """c2v [R, B] f32 from v2c [R, B] (f16 or f32) through ``cn_rows``.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if v2c.device.type == "cpu":
        return minsum_cn_scan_plain(v2c, cn_rows, variant, alpha, delta)
    if v2c.device.type != "cuda":
        raise ValueError(f"minsum_cn_scan: unsupported device {v2c.device}")
    _check(v2c, cn_rows, variant)
    m, dc = cn_rows.shape
    if dc > _MAX_DC:
        raise ValueError(
            f"minsum_cn_scan: the kernel takes dc_max <= {_MAX_DC}, got "
            f"dc_max={dc}"
        )
    sdt = v2c.dtype
    batch = v2c.shape[1]
    c2v = torch.empty(v2c.shape, dtype=torch.float32, device=v2c.device)
    rc = build.library().ldpc_minsum_cn_scan(
        v2c.data_ptr(), int(sdt == torch.float16), cn_rows.data_ptr(), m, dc,
        batch, lane_width(batch, sdt, v2c.data_ptr(), c2v.data_ptr()),
        VARIANTS[variant], in_storage(alpha, sdt),
        in_storage(delta, sdt), c2v.data_ptr(), v2c.device.index,
        build.stream_of(v2c.device),
    )
    build.check(rc, "minsum_cn_scan")
    build.LAUNCHES["minsum_cn_scan"] += 1
    return c2v
