"""Kernel B8: the sum-product check-node update with the routing inside
(``csrc/bp_cn_pair.cu``).

No Pallas original: the JAX package leaves the update to XLA, which fuses
``ldpcsimulation_tpu.decoders.bp_qc.qc_cn_bp_slots``.  The kernel reads
check ``c``'s slot ``t`` from row ``cn_rows[c, t]`` of the message planes
``v2c [R, B]`` (f16 or f32) and writes that slot's output, f32, to the same
row of ``c2v [R, B]``, as kernel B1 does (``kernels/minsum.py``).
``cn_rows`` holds −1 for an absent slot; every other entry must lie in
[0, R) and name its row only once (the kernel does not check: the table
comes from ``decoders.minsum_qc.qc_plan``).  A row that no check names is
left unwritten (``torch.empty``): the caller zeroes the rows of absent
edges.

The function is the hyperbolic-pair evaluation of ``decoders/bp.py``: per
check and lane ``u = e^-|m|`` for each slot, the exclusive (s, d) pairs by
a prefix and a suffix fold, ``|out| = log(num / den)``, and the product of
the other slots' signs.  :func:`bp_cn_pair` launches the kernel for CUDA
tensors and runs :func:`bp_cn_pair_plain` for CPU tensors; on the card the
two agree bit for bit (``chip_smoke.py``), since the kernel takes the
twin's operations in the twin's order with the same correctly rounded
``exp``, ``log`` and division.  :func:`bp_instance` picks the kernel's
instance: the slot cap from ``dc_max``, the lanes per thread from the cap,
the batch and the pointers' alignment.
"""

from __future__ import annotations

import torch

from . import build
from .minsum import _check as _check_planes
from .minsum import lane_width

__all__ = ["CAP_LANES", "bp_instance", "bp_cn_pair", "bp_cn_pair_plain"]

#: slot cap of each kernel instance -> the most lanes a thread takes under
#: it (its registers hold u, pre_s and pre_d: 3 × cap × lanes floats)
CAP_LANES = {8: 4, 16: 2, 32: 1, 64: 1}


def bp_instance(dc_max: int, batch: int, dtype: torch.dtype, v2c_ptr: int,
                c2v_ptr: int) -> tuple[int, int]:
    """(slot cap, lanes per thread) of the instance that takes a call: the
    smallest cap that holds ``dc_max``, then the widest lane count under
    the cap's limit whose vector accesses stay aligned (B1's
    :func:`.minsum.lane_width`: ``batch`` a multiple of it, the v2c and the
    f32 c2v addresses of its loads and stores)."""
    caps = [cap for cap in CAP_LANES if dc_max <= cap]
    if not caps:
        raise ValueError(f"bp_cn_pair: the kernel takes dc_max <= "
                         f"{max(CAP_LANES)}, got dc_max={dc_max}")
    cap = caps[0]
    return cap, min(CAP_LANES[cap],
                    lane_width(batch, dtype, v2c_ptr, c2v_ptr))


def _check(v2c, cn_rows):
    """B1's checks: f16/f32 planes and an int32 table, on one device, both
    contiguous."""
    _check_planes(v2c, cn_rows, "plain")


def bp_cn_pair_plain(v2c, cn_rows):
    """Plain PyTorch twin of the kernel: one plane per slot, an absent
    slot read as +inf (u = e^-inf = 0 and sign +1, the folds' neutral
    element), each output written to its slot's row."""
    from ..decoders.base import sgn_pos
    from ..decoders.bp import excl_sign_products, pair_excl_logmags

    _check(v2c, cn_rows)
    r, b = v2c.shape
    cdt = torch.promote_types(v2c.dtype, torch.float32)
    views, writes = [], []
    for t in range(cn_rows.shape[1]):
        rows = cn_rows[:, t].long()
        gone = rows < 0
        msg = v2c[rows.clamp(min=0)].to(cdt)
        views.append(torch.where(gone[:, None], float("inf"), msg))
        writes.append(torch.where(gone, r, rows))  # the spare row r
    mags = pair_excl_logmags([torch.exp(-v.abs()) for v in views])
    sprods = excl_sign_products([sgn_pos(v) for v in views])
    c2v = torch.empty((r + 1, b), dtype=cdt, device=v2c.device)
    for rows_w, sp, mg in zip(writes, sprods, mags):
        c2v[rows_w] = sp * mg
    return c2v[:-1]


def bp_cn_pair(v2c, cn_rows):
    """c2v [R, B] f32 from v2c [R, B] (f16 or f32) through ``cn_rows``.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if v2c.device.type == "cpu":
        return bp_cn_pair_plain(v2c, cn_rows)
    if v2c.device.type != "cuda":
        raise ValueError(f"bp_cn_pair: unsupported device {v2c.device}")
    _check(v2c, cn_rows)
    m, dc = cn_rows.shape
    batch = v2c.shape[1]
    c2v = torch.empty(v2c.shape, dtype=torch.float32, device=v2c.device)
    cap, lanes = bp_instance(dc, batch, v2c.dtype, v2c.data_ptr(),
                             c2v.data_ptr())
    rc = build.library().ldpc_bp_cn_pair(
        v2c.data_ptr(), int(v2c.dtype == torch.float16), cn_rows.data_ptr(),
        m, dc, batch, cap, lanes, c2v.data_ptr(), v2c.device.index,
        build.stream_of(v2c.device),
    )
    build.check(rc, "bp_cn_pair")
    build.LAUNCHES["bp_cn_pair"] += 1
    return c2v
