"""Kernel B1: min-sum check-node update with the routing inside
(``csrc/minsum_cn_scan.cu``); kernel B5: the flooding min-sum
variable-node update (``csrc/minsum_vn_update.cu``).

Port of ``ldpcsimulation_tpu.kernels.minsum_pallas.minsum_cn_scan_pallas``.
The TPU kernel scanned pre-gathered ``[M, dc_max, B]`` blocks; this one
reads check ``c``'s slot ``t`` from row ``cn_rows[c, t]`` of the message
planes ``v2c [R, B]`` and writes that slot's output to the same row of
``c2v [R, B]`` (f32, or with ``out_dtype=torch.float16`` in the f16
storage type of v2c: exact, since every output is a stored magnitude or a
post-op already rounded to the storage type).  ``cn_rows`` holds −1 for an
absent slot; every other entry must lie in [0, R) and name its row only
once (the kernel does not check: the tables come from
``decoders.minsum_qc.qc_plan`` and ``decoders.minsum.minsum_plan``, which
build them so).  A row that no check names is left unwritten
(``torch.empty``): the slot-array decoder's padding slots and the QC
decoder's absent edges, which B5 reads as +0.0 terms.
The kernel takes any M and ``dc_max`` up to 64, as the Pallas kernel's
tiles can hold; a table of more than 65535 checks takes one grid per 65535
(still one call, one count in ``LAUNCHES``).  Each thread takes several
contiguous batch lanes: :func:`lane_width` picks the kernel instance from
the batch, the storage type and the pointers' alignment.

:func:`minsum_cn_scan` launches the kernel for CUDA tensors and runs
:func:`minsum_cn_scan_plain` for CPU tensors.  Both are exact: the scan only
selects stored values, and the variant post-op is one correctly rounded
operation in the storage precision.

B5 (:func:`minsum_vn_update`) has no Pallas original: it is the XLA fusion
of the JAX flooding steps (fold, total, extrinsic subtraction, saturating
store), one pass over c2v that overwrites it in place with v2c'.  Its
table ``vn_rows [N, dv]`` lists each column's terms in fold order: a row
``r >= 0``, :data:`NO_TERM` (−1: no term at that position), or
:func:`zero_term` of a row (a +0.0 term whose output still goes to that
row: the slot arrays' padding slots, the QC decoder's absent edges, which
B1 leaves unwritten).
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["VARIANTS", "LANES", "NO_TERM", "minsum_cn_scan",
           "minsum_cn_scan_plain", "in_storage", "lane_width", "zero_term",
           "vn_lane_width", "minsum_vn_update", "minsum_vn_update_plain"]

#: variant name -> id passed to the kernel
VARIANTS = {"plain": 0, "normalized": 1, "offset": 2}
#: lanes per thread of the kernel's instances (f16 and f32), widest first
LANES = (4, 2, 1)
_MAX_DC = 64  # the most slots a check's sign mask holds
#: B5's table entry for "no term at this position"
NO_TERM = -1
_F16_MAX = torch.finfo(torch.float16).max


def zero_term(rows):
    """B5's table entry for a +0.0 term whose output goes to ``rows``."""
    return -rows - 2


def _size(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def lane_width(batch: int, dtype: torch.dtype, v2c_ptr: int,
               c2v_ptr: int, out_dtype: torch.dtype = torch.float32) -> int:
    """Lanes per thread of the instance that takes a call: the widest
    whose vector accesses stay aligned — ``batch`` a multiple of it, the
    v2c address of its load (lanes × element bytes) and the c2v address of
    its stores (lanes × ``out_dtype``'s bytes, at most 16)."""
    size, out = _size(dtype), _size(out_dtype)
    for lanes in LANES[:-1]:
        if (batch % lanes == 0 and v2c_ptr % (lanes * size) == 0
                and c2v_ptr % min(lanes * out, 16) == 0):
            return lanes
    return 1  # takes any call


def vn_lane_width(c2v: torch.Tensor, y: torch.Tensor,
                  total: torch.Tensor) -> int:
    """Lanes per thread of B5's instance for a call: the widest that
    divides the batch and keeps every vector access aligned (c2v's rows in
    its type, y's and total's in the channel's)."""
    batch = c2v.shape[1]
    for lanes in LANES[:-1]:
        if batch % lanes == 0 and all(
                t.data_ptr() % (lanes * t.element_size()) == 0
                for t in (c2v, y, total)):
            return lanes
    return 1


def in_storage(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` — what the JAX decoder's weakly
    typed ``alpha``/``delta`` become next to storage-typed messages."""
    return float(torch.tensor(x, dtype=dtype))


def _check(v2c, cn_rows, variant, out_dtype=torch.float32):
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")
    if out_dtype not in (torch.float32, v2c.dtype):
        raise ValueError(f"c2v is f32 or v2c's dtype {v2c.dtype}, not "
                         f"{out_dtype}")
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
                         delta=0.0, out_dtype=torch.float32):
    """Plain PyTorch twin of the kernel (same scan, same outputs)."""
    _check(v2c, cn_rows, variant, out_dtype)
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
    c2v = torch.empty(v2c.shape, dtype=out_dtype, device=v2c.device)
    for t in range(dc):
        msg = msgs[:, t]
        mag = torch.where(minidx == t, min2, min1)
        out = sprod * mag * torch.where(msg >= 0, 1.0, -1.0)
        out = _post_op(out, variant, alpha, delta, sdt)
        ok = valid[:, t]
        c2v[rows[ok, t]] = out[ok].to(out_dtype)  # exact
    return c2v


def minsum_cn_scan(v2c, cn_rows, variant="plain", alpha=1.0, delta=0.0,
                   out_dtype=torch.float32):
    """c2v [R, B] from v2c [R, B] (f16 or f32) through ``cn_rows``, in f32
    or (``out_dtype``) in v2c's dtype.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if v2c.device.type == "cpu":
        return minsum_cn_scan_plain(v2c, cn_rows, variant, alpha, delta,
                                    out_dtype)
    if v2c.device.type != "cuda":
        raise ValueError(f"minsum_cn_scan: unsupported device {v2c.device}")
    _check(v2c, cn_rows, variant, out_dtype)
    m, dc = cn_rows.shape
    if dc > _MAX_DC:
        raise ValueError(
            f"minsum_cn_scan: the kernel takes dc_max <= {_MAX_DC}, got "
            f"dc_max={dc}"
        )
    sdt = v2c.dtype
    batch = v2c.shape[1]
    c2v = torch.empty(v2c.shape, dtype=out_dtype, device=v2c.device)
    rc = build.library().ldpc_minsum_cn_scan(
        v2c.data_ptr(), int(sdt == torch.float16), cn_rows.data_ptr(), m, dc,
        batch, lane_width(batch, sdt, v2c.data_ptr(), c2v.data_ptr(),
                          out_dtype),
        VARIANTS[variant], in_storage(alpha, sdt),
        in_storage(delta, sdt), c2v.data_ptr(),
        int(out_dtype == torch.float16), v2c.device.index,
        build.stream_of(v2c.device),
    )
    build.check(rc, "minsum_cn_scan")
    build.LAUNCHES["minsum_cn_scan"] += 1
    return c2v


def _check_vn(c2v, y, vn_rows):
    for name, t in (("c2v", c2v), ("y", y)):
        if t.dim() != 2 or t.dtype not in (torch.float16, torch.float32):
            raise ValueError(f"{name} must be 2-D f16/f32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if vn_rows.dim() != 2 or vn_rows.dtype != torch.int32:
        raise ValueError(f"vn_rows must be [N, dv] int32, got "
                         f"{tuple(vn_rows.shape)} {vn_rows.dtype}")
    if y.shape[0] != vn_rows.shape[0] or y.shape[1] != c2v.shape[1]:
        raise ValueError(f"y {tuple(y.shape)} against vn_rows "
                         f"{tuple(vn_rows.shape)} and c2v {tuple(c2v.shape)}")
    if not (c2v.device == y.device == vn_rows.device):
        raise ValueError(f"c2v on {c2v.device}, y on {y.device}, vn_rows on "
                         f"{vn_rows.device}")
    if not (c2v.is_contiguous() and y.is_contiguous()
            and vn_rows.is_contiguous()):
        raise ValueError("c2v, y and vn_rows must be contiguous")


def minsum_vn_update_plain(c2v, y, vn_rows):
    """Plain PyTorch twin of kernel B5 (same fold order, same roundings).

    Writes v2c' over ``c2v`` and returns (c2v, total)."""
    _check_vn(c2v, y, vn_rows)
    cdt = y.dtype
    e = vn_rows.long()
    has = e != NO_TERM
    rows = torch.where(e >= 0, e, -e - 2)

    def term(s):
        t = c2v[e[:, s].clamp(min=0)].to(cdt)
        return torch.where((e[:, s] >= 0)[:, None], t, 0.0)  # +0.0 terms

    acc = torch.full_like(y, -0.0)  # the identity of IEEE addition
    for s in range(e.shape[1]):
        acc = torch.where(has[:, s, None], acc + term(s), acc)
    total = y + acc
    for s in range(e.shape[1]):  # no row has two slots: a write here
        out = total - term(s)    # changes no later term
        if c2v.dtype == torch.float16:  # saturate, then cast
            out = torch.clamp(out, -_F16_MAX, _F16_MAX)
        c2v[rows[has[:, s], s]] = out[has[:, s]].to(c2v.dtype)
    return c2v, total


def minsum_vn_update(c2v, y, vn_rows):
    """Flooding min-sum VN update: from c2v [R, B] (the storage type) and
    the channel y [N, B] (f16 or f32), total [N, B] in y's dtype and, over
    c2v's own memory, v2c' [R, B].  Returns (v2c', total).

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if c2v.device.type == "cpu":
        return minsum_vn_update_plain(c2v, y, vn_rows)
    if c2v.device.type != "cuda":
        raise ValueError(f"minsum_vn_update: unsupported device {c2v.device}")
    _check_vn(c2v, y, vn_rows)
    n, dv = vn_rows.shape
    total = torch.empty_like(y)
    rc = build.library().ldpc_minsum_vn_update(
        c2v.data_ptr(), int(c2v.dtype == torch.float16), y.data_ptr(),
        int(y.dtype == torch.float16), vn_rows.data_ptr(), n, dv,
        c2v.shape[1], vn_lane_width(c2v, y, total), total.data_ptr(),
        c2v.device.index, build.stream_of(c2v.device),
    )
    build.check(rc, "minsum_vn_update")
    build.LAUNCHES["minsum_vn_update"] += 1
    return c2v, total
