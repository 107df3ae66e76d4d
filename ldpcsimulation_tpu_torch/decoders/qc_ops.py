"""Graph operations of the bit-flip family on QC codes, as row gathers.

Port of ``ldpcsimulation_tpu.decoders.qc_ops``.  The GDBF/NGDBF decoders
touch the Tanner graph in two places: the bipolar syndrome per check and
the per-variable sum of neighbouring syndromes.  The JAX package wrote both
as static per-block rolls; here :func:`qc_graph` turns the block structure
into two row tables once per (code, device).  The syndrome is kernel B6
(:func:`..kernels.check.parity_check`) on the check table, the neighbour
sum one gather per slot.  The outputs are bit-identical to the rolls:
parities of ±1 and sums of small integers, in any order.

Multi-edge blocks (``extra_edges``) are further slots.  A defect edge
(``minus_edges`` entry ``(bi, bj, s, r)``) is an absent slot: the table
points it at a sentinel row (+1 for the product, 0 for the sum), where the
rolls multiplied the spurious factor out again and subtracted it.

:func:`slot_graph` reads the same two tables off any code's slot arrays
(padding slots point at the sentinel rows), so a decoder that takes either
graph runs :func:`syndrome_bipolar` and :func:`syndrome_sum_per_vn` on it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.qc import QCCode
from ..kernels.check import parity_check

__all__ = ["QCGraph", "qc_graph", "slot_graph", "syndrome_bipolar",
           "syndrome_sum_per_vn", "qc_syndrome_bipolar",
           "qc_syndrome_sum_per_vn"]


@dataclasses.dataclass(frozen=True, eq=False)
class QCGraph:
    """Row tables of one code on one device.

    check_cols: [M, dc_max] int64 — the column of check (bi, r)'s slot t,
                ``N`` (a sentinel row) for an absent slot.
    vn_checks:  [N, dv_max] int64 — the check of column (bj, c)'s slot s,
                ``M`` (a sentinel row) for an absent slot.
    """

    check_cols: torch.Tensor
    vn_checks: torch.Tensor
    padded_checks: bool  # some check_cols entry is the sentinel
    padded_vns: bool  # some vn_checks entry is the sentinel


@functools.lru_cache(maxsize=None)
def qc_graph(qc: QCCode, device) -> QCGraph:
    """Row tables of ``qc`` on ``device`` (built once, cached)."""
    z, n, m = qc.z, qc.n, qc.m
    r = np.arange(z)
    check_cols = np.full((m, qc.dc_max), n, np.int64)
    for bi in range(qc.mb):
        for t, (bj, s) in enumerate(qc.cn_blocks[bi]):
            check_cols[bi * z + r, t] = bj * z + (r + s) % z
    vn_checks = np.full((n, qc.dv_max), m, np.int64)
    for bj in range(qc.nb):
        for slot, (bi, s) in enumerate(qc.vn_blocks[bj]):
            vn_checks[bj * z + r, slot] = bi * z + (r - s) % z
    for bi, bj, s, rr in qc.minus_edges:
        check_cols[bi * z + rr, qc.cn_blocks[bi].index((bj, s))] = n
        vn_checks[bj * z + (rr + s) % z, qc.vn_blocks[bj].index((bi, s))] = m
    return QCGraph(
        check_cols=torch.tensor(check_cols, device=device),
        vn_checks=torch.tensor(vn_checks, device=device),
        padded_checks=bool((check_cols == n).any()),
        padded_vns=bool((vn_checks == m).any()),
    )


@functools.lru_cache(maxsize=None)
def slot_graph(code, device) -> QCGraph:
    """Row tables of any :class:`..codes.code.Code` on ``device``, from its
    slot arrays (built once, cached)."""
    return QCGraph(
        check_cols=torch.where(code.cn_mask, code.cn_vn, code.n).long().to(
            device),
        vn_checks=torch.where(code.vn_mask, code.vn_cn, code.m).long().to(
            device),
        padded_checks=bool((~code.cn_mask).any()),
        padded_vns=bool((~code.vn_mask).any()),
    )


def _gather_rows(x, table, padded, fill, combine):
    """combine over slots t of x[table[:, t]], with row ``len(x)`` = fill."""
    if padded:
        x = torch.cat([x, torch.full((1, x.shape[1]), fill, dtype=x.dtype,
                                     device=x.device)])
    out = torch.index_select(x, 0, table[:, 0])
    for t in range(1, table.shape[1]):
        out = combine(out, torch.index_select(x, 0, table[:, t]))
    return out


def syndrome_bipolar(g: QCGraph, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] ±1 int8/int32 -> bipolar syndrome [M, B] (+1 satisfied),
    d's dtype: kernel B6 on the check table."""
    return parity_check(g.check_cols, d.contiguous(), syndrome=True)[1]


def syndrome_sum_per_vn(g: QCGraph, syn: torch.Tensor) -> torch.Tensor:
    """syn: [M, B] -> per-variable neighbour syndrome sums [N, B]."""
    return _gather_rows(syn, g.vn_checks, g.padded_vns, 0, torch.add)


def qc_syndrome_bipolar(qc: QCCode, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] ±1 -> bipolar syndrome [M, B] (+1 satisfied), d's dtype."""
    return syndrome_bipolar(qc_graph(qc, d.device), d)


def qc_syndrome_sum_per_vn(qc: QCCode, syn: torch.Tensor) -> torch.Tensor:
    """syn: [M, B] -> per-variable neighbour syndrome sums [N, B]."""
    return syndrome_sum_per_vn(qc_graph(qc, syn.device), syn)
