"""Kernel B8: the sum-product check-node update with the routing inside
(``csrc/bp_cn_pair.cu``); kernel B9: the sum-product variable-node update
(``csrc/bp_vn_update.cu``).

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
a prefix and a suffix fold (:func:`pair_excl_sums`), ``|out| = log(num /
den)`` (:func:`pair_excl_logmags`), and the product of the other slots'
signs (:func:`excl_sign_products`, with ``sgn(0) = +1``:
:func:`sgn_pos`).  :func:`bp_cn_pair` launches the kernel for CUDA
tensors and runs :func:`bp_cn_pair_plain` for CPU tensors; on the card the
two agree bit for bit (``chip_smoke.py``), since the kernel takes the
twin's operations in the twin's order with the same correctly rounded
``exp``, ``log`` and division.  :func:`bp_instance` picks the kernel's
instance: the slot cap from ``dc_max``, the lanes per thread from the cap,
the batch and the pointers' alignment.

B9 (:func:`bp_vn_update`) has no Pallas original either: it is the XLA
fusion of the JAX QC step's VN side.  From c2v ``[R, B]`` f32 (B8's
output, +0.0 in the rows of absent edges) and the channel LLRs
``y [N, B]`` (f16 or f32) it computes, through kernel B5's table
``vn_rows`` (:mod:`.minsum`: a row, :data:`.minsum.NO_TERM`, or a
:func:`.minsum.zero_term`), the posterior ``total = y + ((c₀ + c₁) + …)``
in f32 and, in a fresh plane of the storage type (f16 or f32), ``v2c' =
storage_cast(clamp(total − c, ±max_llr))``.  :func:`bp_vn_update` launches
the kernel for CUDA tensors and runs :func:`bp_vn_update_plain` for CPU
tensors; the two agree bit for bit on the card (``chip_smoke.py``): every
operation is one correctly rounded f32 add, compare or cast, in the same
order.
"""

from __future__ import annotations

import torch

from . import build
from .minsum import _F16_MAX, NO_TERM, _check_vn, lane_width, vn_lane_width
from .minsum import _check as _check_planes

__all__ = ["CAP_LANES", "bp_instance", "bp_cn_pair", "bp_cn_pair_plain",
           "sgn_pos", "pair_excl_sums", "pair_excl_logmags",
           "excl_sign_products", "bp_vn_update", "bp_vn_update_plain"]

#: slot cap of each kernel instance -> the most lanes a thread takes under
#: it (its registers hold u, pre_s and pre_d: 3 × cap × lanes floats)
CAP_LANES = {8: 4, 16: 2, 32: 1, 64: 1}


def sgn_pos(x: torch.Tensor) -> torch.Tensor:
    """sgn(0) = +1 convention (BP/min-sum/DDBMP); -0.0 counts as +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def pair_excl_sums(us):
    """Per output t the (numerator, denominator) of the exclusive product's
    ``(1+P_t)/(1-P_t)``: multiplies and adds only, in a fixed order.  The
    (s, d) pairs fold from the neutral (1, 0): ``pre[t]`` over u_0..u_{t-1}
    left to right, ``suf[t]`` over u_{k-1}..u_{t+1} right to left."""
    k = len(us)
    one = torch.ones_like(us[0])
    zero = torch.zeros_like(us[0])
    pre = [(one, zero)]
    for t in range(k - 1):
        s, d = pre[-1]
        u = us[t]
        pre.append((s + d * u, d + s * u))
    suf = [(one, zero)]
    for t in range(k - 1, 0, -1):
        s, d = suf[-1]
        u = us[t]
        suf.append((s + d * u, d + s * u))
    suf.reverse()
    return [
        (sp * ss + dp * ds, sp * ds + dp * ss)
        for (sp, dp), (ss, ds) in zip(pre, suf)
    ]


def pair_excl_logmags(us):
    """Exclusive tanh-product magnitudes from ``u = e^-|m|``.

    us: list of per-edge u tensors of one shape.  Returns the list of
    ``|out|_t = log((1+P_t)/(1-P_t))`` with ``P_t = Π_{k≠t} tanh(|m_k|/2)``.
    The neutral element is (1, 0): an absent edge must present u = 0 (a
    message of +inf), which leaves the fold untouched bit for bit
    (``s + d·0 == s``).
    """
    return [torch.log(num / den) for num, den in pair_excl_sums(us)]


def excl_sign_products(signs):
    """Per output t the product of the other slots' ±1 signs (exclusive
    prefix times exclusive suffix)."""
    k = len(signs)
    ones = torch.ones_like(signs[0])
    pre = [ones]
    for t in range(k - 1):
        pre.append(pre[-1] * signs[t])
    suf = [ones]
    for t in range(k - 1, 0, -1):
        suf.append(suf[-1] * signs[t])
    suf.reverse()
    return [p * s for p, s in zip(pre, suf)]


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


def _check_bp_vn(c2v, y, vn_rows, storage_dtype):
    """B5's checks, then f32 c2v and an f16/f32 storage dtype."""
    _check_vn(c2v, y, vn_rows)
    if c2v.dtype != torch.float32:
        raise ValueError(f"c2v must be f32, got {c2v.dtype}")
    if storage_dtype not in (torch.float16, torch.float32):
        raise ValueError(f"v2c' is stored in f16 or f32, not {storage_dtype}")


def bp_vn_update_plain(c2v, y, vn_rows, max_llr, storage_dtype):
    """Plain PyTorch twin of kernel B9: the QC step's VN expression on
    B5's table (the same fold order, the same roundings).  Returns (v2c'
    [R, B] in ``storage_dtype``, a new plane; total [N, B] f32)."""
    _check_bp_vn(c2v, y, vn_rows, storage_dtype)
    e = vn_rows.long()
    has = e != NO_TERM
    rows = torch.where(e >= 0, e, -e - 2)

    def term(s):
        t = c2v[e[:, s].clamp(min=0)]
        return torch.where((e[:, s] >= 0)[:, None], t, 0.0)  # +0.0 terms

    acc = torch.full(y.shape, -0.0, device=y.device)  # the identity of +
    for s in range(e.shape[1]):
        acc = torch.where(has[:, s, None], acc + term(s), acc)
    total = y + acc  # an f16 channel widens to f32
    v2c = torch.empty(c2v.shape, dtype=storage_dtype, device=c2v.device)
    for s in range(e.shape[1]):
        out = torch.clamp(total - term(s), -max_llr, max_llr)
        if storage_dtype == torch.float16:  # the saturating storage cast
            out = torch.clamp(out, -_F16_MAX, _F16_MAX)
        v2c[rows[has[:, s], s]] = out[has[:, s]].to(storage_dtype)
    return v2c, total


def bp_vn_update(c2v, y, vn_rows, max_llr, storage_dtype):
    """Sum-product VN update: (v2c' [R, B] in ``storage_dtype``, total
    [N, B] f32) from c2v [R, B] f32 and the channel y [N, B] (f16 or f32)
    through ``vn_rows``.  v2c' is a new plane: c2v is not written.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if c2v.device.type == "cpu":
        return bp_vn_update_plain(c2v, y, vn_rows, max_llr, storage_dtype)
    if c2v.device.type != "cuda":
        raise ValueError(f"bp_vn_update: unsupported device {c2v.device}")
    _check_bp_vn(c2v, y, vn_rows, storage_dtype)
    n, dv = vn_rows.shape
    total = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    v2c = torch.empty(c2v.shape, dtype=storage_dtype, device=c2v.device)
    # B5's rule on the planes it shares with B9, then on v2c'
    lanes = min(vn_lane_width(c2v, y, total), vn_lane_width(v2c, v2c, v2c))
    rc = build.library().ldpc_bp_vn_update(
        c2v.data_ptr(), y.data_ptr(), int(y.dtype == torch.float16),
        vn_rows.data_ptr(), n, dv, c2v.shape[1], max_llr, lanes,
        total.data_ptr(), v2c.data_ptr(),
        int(storage_dtype == torch.float16), c2v.device.index,
        build.stream_of(c2v.device),
    )
    build.check(rc, "bp_vn_update")
    build.LAUNCHES["bp_vn_update"] += 1
    return v2c, total
