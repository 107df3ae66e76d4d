"""Flooding min-sum decoder for quasi-cyclic codes.

Port of ``ldpcsimulation_tpu.decoders.minsum_qc`` with the same arithmetic,
slot order and tie-breaking, so its decisions equal the JAX decoder's bit
for bit on the same samples.

Message layout: ONE flat buffer of message planes ``[P * z, B]``, batch
last, planes ordered (VN block bj, slot s) — plane ``p(bj, s)`` is
``sum(deg_j for j < bj) + s`` and row ``p * z + c`` carries the message on
the edge of column ``bj * z + c``.  For a regular code this is the memory of
the JAX stacked ``[Nb, dv_max, z, B]`` carry; for an irregular one, its
ragged per-block tuple concatenated.

The JAX decoder routes with static rolls (a CN block reads a plane rolled
by −shift and rolls its output back by +shift).  Here :func:`qc_plan` turns
the block structure into row tables once per code and device, and kernel B1
(:func:`..kernels.minsum.minsum_cn_scan`) does the routing: check (bi, r)
reads and writes, for its slot t, row ``p(bj_t, vslot_t) * z +
(r + shift_t) % z``, in the storage type.  Kernel B5
(:func:`..kernels.minsum.minsum_vn_update`) then runs the VN update in one
pass on the table ``QCPlan.vn_rows`` (messages left-folded in the generic
decoder's slot order, channel term added last, the extrinsic and the
saturating storage cast) and writes v2c' over B1's output, as the JAX step
keeps c2v out of memory.  The syndrome check is plain torch.

The generalized structures of real standards (``extra_edges``: two
circulants on one block pair; ``minus_edges``: single absent edges, as in
DVB-S2) live in the same tables, where the JAX decoder keeps per-row
``where`` views (``qc_slot_plan``):

* **pairs**: in the check rows where the expanded H orders the second
  circulant's column first, the two ``cn_rows`` entries are exchanged, so
  the scan sees the generic slot order and its tie-break stays exact; the
  VN fold takes the pair's two terms in the same per-column order;
* **absent edges**: −1 in ``cn_rows`` (the scan skips the slot, as the JAX
  decoder's +inf read does) and the sentinel column N in ``check_cols``;
  B1 leaves that message row unwritten, and ``vn_rows`` names it as a +0.0
  term (:func:`..kernels.minsum.zero_term`), where the JAX decoder adds an
  exact zero.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..codes.qc import QCCode
from ..kernels.minsum import (
    NO_TERM,
    VARIANTS,
    zero_term,
)
from .base import (
    DecodeResult,
    minsum_iteration,
    run_flooding_soft,
    xor_satisfied,
)

__all__ = [
    "QCPlan",
    "LayerPlan",
    "assert_layered_compatible",
    "qc_plan",
    "qc_check_satisfied",
    "qc_fold",
    "qc_minsum_step",
    "qc_ragged_init",
    "decode_minsum_qc",
]


@dataclasses.dataclass(frozen=True, eq=False)
class LayerPlan:
    """One base row (layer) of a QC code as the row-layered decoders see it.

    The layer's messages live in a buffer ``[dc * z, B]`` of its own, in the
    PHYSICAL circulant order of ``qc.cn_blocks[bi]`` (the order the JAX
    layered decoders scan and fold in; a pair is not exchanged row by row
    here, unlike ``QCPlan.cn_rows``): local row ``t * z + r`` is the edge of
    check (bi, r) in circulant t.

    cols:        [dc*z] int64 — the column of each local row.
    scan_rows:   [z, dc] int32 — kernels B1's and B8's routing table over
                 the local rows, −1 where the edge is absent.
    slot_cols:   [z, dc] int32 — kernel B11's table: the column of check
                 r's edge in circulant t (``cols[scan_rows[r, t]]``), −1
                 where the edge is absent.
    absent:      int64 local rows of absent edges (None if there are none).
    single_rows: int64 local rows of the circulants that are alone on their
                 block pair (None when every circulant is: all rows).
    pair_first, pair_second: int64 local rows of a two-circulant pair's
                 first member and, column for column, of its second (None
                 without pairs).
    """

    dc: int
    cols: torch.Tensor
    scan_rows: torch.Tensor
    slot_cols: torch.Tensor
    absent: Optional[torch.Tensor]
    single_rows: Optional[torch.Tensor]
    pair_first: Optional[torch.Tensor]
    pair_second: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True, eq=False)
class QCPlan:
    """Static row tables of one QC code on one device.

    cn_rows:     [M, dc_max] int32 — message row of check (bi, r), slot t
                 (−1 for an absent slot), in the generic slot order; the
                 kernel's routing table.
    check_cols:  [M, dc_max] int64 — column of that edge (N for an absent
                 slot, a sentinel row); the syndrome check's table.
    row_col:     [R] int64 — column of each message row.
    fold:        per fold position s, (columns with a term there, or None
                 for all N; the message row of that term) — the VN fold's
                 order.
    absent_rows: int64 message rows of absent edges (None if there are
                 none), zeroed before the fold.
    vn_rows:     [N, dv_max] int32 — kernel B5's table: column j's terms in
                 ``fold`` order (a pair's two swapped per column), absent
                 edges as +0.0 terms, ``NO_TERM`` past a column's degree.
    fold_phys:   ``fold`` in the physical circulant order of
                 ``qc.vn_blocks`` (no per-column pair exchange; ``fold``
                 itself for a code without pairs).
    row_check:   [R] int64 — the check of each message row.
    slots:       per slot t of ``cn_rows``, for the decoders that route with
                 plain row gathers: (the [M] int64 rows to read, 0 standing
                 in for an absent slot; the [M, 1] bool mask of absent
                 slots, None if there are none; the rows to write, the spare
                 row R standing in for an absent slot).
    layers:      per base row, its :class:`LayerPlan`.
    """

    z: int
    nb: int
    num_planes: int
    cn_rows: torch.Tensor
    check_cols: torch.Tensor
    row_col: torch.Tensor
    fold: Tuple[Tuple[Optional[torch.Tensor], torch.Tensor], ...]
    absent_rows: Optional[torch.Tensor]
    vn_rows: torch.Tensor
    fold_phys: Tuple[Tuple[Optional[torch.Tensor], torch.Tensor], ...]
    row_check: torch.Tensor
    slots: Tuple[Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor],
                 ...]
    layers: Tuple[LayerPlan, ...]


def _pairs(keys):
    """Indices k where entries k and k+1 share a key (a two-circulant
    pair), walking left to right; three in a row raise."""
    out, k = [], 0
    while k < len(keys):
        if k + 1 < len(keys) and keys[k + 1] == keys[k]:
            if k + 2 < len(keys) and keys[k + 2] == keys[k]:
                raise NotImplementedError(
                    ">2 circulants between one block pair")
            out.append(k)
            k += 2
        else:
            k += 1
    return out


def _swap(rows, k, sw):
    rows[k], rows[k + 1] = (np.where(sw, rows[k + 1], rows[k]),
                            np.where(sw, rows[k], rows[k + 1]))


@functools.lru_cache(maxsize=None)
def qc_plan(qc: QCCode, device) -> QCPlan:
    """Row tables of ``qc`` on ``device`` (built once, cached)."""
    if any(len(blocks) == 0 for blocks in qc.vn_blocks):
        raise ValueError("every VN block needs at least one circulant")
    z, nb, n = qc.z, qc.nb, qc.n
    plane_of = {}
    plane_block = []
    for bj in range(nb):
        for bi, shift in qc.vn_blocks[bj]:
            plane_of[(bj, bi, shift)] = len(plane_block)
            plane_block.append(bj)
    off = np.arange(z)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    # VN side: per block, the message rows of its columns in fold order
    # (a pair's two terms swap where the second circulant's row comes
    # first in the expanded column)
    fold_rows, phys_rows = [], []
    row_check = np.zeros(len(plane_block) * z, np.int64)
    for bj in range(nb):
        ents = qc.vn_blocks[bj]
        rows = [plane_of[(bj, bi, s)] * z + off for bi, s in ents]
        for (bi, s), rt in zip(ents, rows):
            row_check[rt] = bi * z + (off - s) % z
        phys_rows.append(list(rows))
        for k in _pairs([bi for bi, _ in ents]):
            _swap(rows, k, (off - ents[k + 1][1]) % z < (off - ents[k][1]) % z)
        fold_rows.append(rows)
    absent = []
    for bi, bj, s, r in qc.minus_edges:
        if (bj, bi, s) not in plane_of:
            raise ValueError(f"minus edge {(bi, bj, s, r)} has no circulant")
        absent.append(plane_of[(bj, bi, s)] * z + (r + s) % z)

    # CN side: absent slots first, then the pair swaps carry them along
    minus = {}
    for bi, bj, s, r in qc.minus_edges:
        minus.setdefault((bi, bj, s), []).append(r)
    cn_rows = np.full((qc.m, qc.dc_max), -1, np.int64)
    check_cols = np.full((qc.m, qc.dc_max), n, np.int64)
    layers = []
    for bi in range(qc.mb):
        ents = qc.cn_blocks[bi]
        rows, cols = [], []
        for bj, s in ents:
            at = (off + s) % z
            rt, ct = plane_of[(bj, bi, s)] * z + at, bj * z + at
            gone = minus.get((bi, bj, s), [])
            rt[gone], ct[gone] = -1, n
            rows.append(rt)
            cols.append(ct)
        firsts = _pairs([bj for bj, _ in ents])
        layers.append(_layer_plan(
            z, ents, [rt < 0 for rt in rows], firsts, dev))
        for k in firsts:
            sw = (off + ents[k + 1][1]) % z < (off + ents[k][1]) % z
            _swap(rows, k, sw)
            _swap(cols, k, sw)
        for t in range(len(ents)):
            cn_rows[bi * z:(bi + 1) * z, t] = rows[t]
            check_cols[bi * z:(bi + 1) * z, t] = cols[t]

    def fold_of(block_rows):
        fold = []
        for s in range(qc.dv_max):
            blocks = [bj for bj in range(nb) if len(block_rows[bj]) > s]
            rows = np.concatenate([block_rows[bj][s] for bj in blocks])
            cols = (None if len(blocks) == nb else
                    np.concatenate([bj * z + off for bj in blocks]))
            fold.append((None if cols is None else dev(cols), dev(rows)))
        return tuple(fold)

    fold = fold_of(fold_rows)
    vn_rows = np.full((n, qc.dv_max), NO_TERM, np.int64)
    for bj, rows in enumerate(fold_rows):
        for s, rt in enumerate(rows):
            vn_rows[bj * z + off, s] = rt
    if absent:
        gone = np.isin(vn_rows, absent)
        vn_rows[gone] = zero_term(vn_rows[gone])
    spare = len(plane_block) * z
    slots = []
    for t in range(qc.dc_max):
        rows = cn_rows[:, t]
        gone = rows < 0
        slots.append((
            dev(np.maximum(rows, 0)),
            torch.as_tensor(gone[:, None], device=device) if gone.any()
            else None,
            dev(np.where(gone, spare, rows)),
        ))
    return QCPlan(
        z=z,
        nb=nb,
        num_planes=len(plane_block),
        cn_rows=torch.as_tensor(cn_rows.astype(np.int32), device=device),
        check_cols=dev(check_cols),
        row_col=dev((np.asarray(plane_block)[:, None] * z + off).reshape(-1)),
        fold=fold,
        absent_rows=dev(absent) if absent else None,
        vn_rows=torch.as_tensor(vn_rows.astype(np.int32), device=device),
        fold_phys=fold_of(phys_rows) if qc.extra_edges else fold,
        row_check=dev(row_check),
        slots=tuple(slots),
        layers=tuple(layers),
    )


def _layer_plan(z, ents, gone, firsts, dev) -> LayerPlan:
    """The :class:`LayerPlan` of one base row: ``ents`` its (bj, shift)
    circulants, ``gone[t]`` the [z] mask of circulant t's absent edges,
    ``firsts`` the indices of the pairs' first members."""
    off = np.arange(z)
    dc = len(ents)
    paired = {k + i for k in firsts for i in (0, 1)}
    local = [t * z + off for t in range(dc)]
    cols = np.concatenate([bj * z + (off + s) % z for bj, s in ents])
    scan = np.stack([np.where(gone[t], -1, local[t]) for t in range(dc)], 1)
    absent = np.concatenate([local[t][gone[t]] for t in range(dc)])
    single = [local[t] for t in range(dc) if t not in paired]
    # the pair's second member, column for column: the first's row r holds
    # column (r + s1) % z, which the second holds in row (r + s1 - s2) % z
    second = [(k + 1) * z + (off + ents[k][1] - ents[k + 1][1]) % z
              for k in firsts]
    return LayerPlan(
        dc=dc,
        cols=dev(cols),
        scan_rows=dev(scan).to(torch.int32).contiguous(),
        slot_cols=dev(np.where(scan >= 0, cols[np.maximum(scan, 0)], -1)
                      ).to(torch.int32).contiguous(),
        absent=dev(absent) if len(absent) else None,
        single_rows=(None if not paired else
                     dev(np.concatenate(single)) if single else dev([])),
        pair_first=dev(np.concatenate([local[k] for k in firsts]))
        if firsts else None,
        pair_second=dev(np.concatenate(second)) if firsts else None,
    )


def assert_layered_compatible(qc: QCCode) -> None:
    """The layered decoders take pairs and absent edges, but not an absent
    edge INSIDE a pair (the pair's accumulate would need a third posterior
    term there): raise early with a clear message."""
    minus = {(bi, bj, s) for bi, bj, s, _ in qc.minus_edges}
    for bi, ents in enumerate(qc.cn_blocks):
        for k in _pairs([bj for bj, _ in ents]):
            if (bi, *ents[k]) in minus or (bi, *ents[k + 1]) in minus:
                raise NotImplementedError("minus edge inside a pair block")


def qc_fold(fold, msgs: torch.Tensor, acc=None) -> torch.Tensor:
    """Left fold of the message rows ``msgs [P*z, B]`` into ``[N, B]``
    through a fold table (``QCPlan.fold`` or ``fold_phys``): position by
    position, ``acc`` first when given."""
    for cols, rows in fold:
        if acc is None:  # position 0: every column has a term
            acc = msgs[rows]
        elif cols is None:
            acc = acc + msgs[rows]
        else:
            acc[cols] = acc[cols] + msgs[rows]
    return acc


def qc_check_satisfied(qc: QCCode, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] (or [Nb, z, B]) ±1 decisions -> [B] all checks satisfied."""
    d = d.reshape(qc.n, -1)
    return xor_satisfied(qc_plan(qc, d.device).check_cols, d)


def qc_minsum_step(qc: QCCode, variant: str = "plain", alpha: float = 1.0,
                   delta: float = 0.0, storage_dtype=None):
    """One flooding iteration as a function of (messages, channel term):
    ``step(v2c, yb) -> (v2c', total)`` with ``v2c`` the ``[P*z, B]`` planes
    (v2c' in the storage dtype; messages in another dtype take
    :func:`.base.minsum_iteration`'s f32 route) and ``yb``/``total`` the
    ``[N, B]`` channel samples and posterior.

    The same operations as the JAX ``qc_minsum_step``: c2v from the CN
    update (kernel B1, stored in the storage dtype, which is exact; cast
    to the channel's dtype), total = y + ((c₀ + c₁) + c₂ …) in VN slot
    order, then v2c' = storage_cast(total − c_s) (kernel B5, over B1's
    output: ``v2c`` itself is not written).
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")

    def step(v2c, yb):
        plan = qc_plan(qc, v2c.device)
        return minsum_iteration(v2c, yb.contiguous(), plan.cn_rows,
                                plan.vn_rows, variant, alpha, delta,
                                storage_dtype)

    return step



def qc_ragged_init(qc: QCCode, yb: torch.Tensor, sdt) -> torch.Tensor:
    """Initial v2c planes ``[P*z, B]``: every slot starts at its column's
    channel sample (cast first: the gather then moves storage words)."""
    return yb.to(sdt)[qc_plan(qc, yb.device).row_col]


def decode_minsum_qc(
    qc: QCCode,
    y: torch.Tensor,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding min-sum on a QC code.  y: [B, N] samples.

    storage_dtype: optional narrower message dtype (e.g. torch.float16);
    arithmetic stays f32 and each v2c store saturates at the storage range.
    """
    y_t = y.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != qc.n:
        raise ValueError(f"y has {n} columns, the code {qc.n}")
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype
    step_y = qc_minsum_step(qc, variant, alpha, delta, storage_dtype)
    d, iters, done = run_flooding_soft(  # the initial planes without a name
        y_t, qc_ragged_init(qc, y_t, sdt), lambda v2c: step_y(v2c, y_t),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
