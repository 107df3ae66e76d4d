"""Quasi-cyclic code structure.

A QC-LDPC parity-check matrix is an (Mb × Nb) base matrix of z×z blocks,
each block either zero or a cyclic shift of the identity.  The slot orders
used here (base-edges sorted by base-row within a column, by base-column
within a row) coincide with the alist file order of the expanded matrix
(``qc_expand`` emits sorted adjacency), so the QC decoder is bit-identical
to a slot-array decoder on the same H.

Numpy port of ``ldpcsimulation_tpu.codes.qc``: the same seeds give the same
base matrices and shifts.  The decoder turns this block view into row
tables (:func:`..decoders.minsum_qc.qc_plan`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .alist import Alist
from .code import Code, build_code
from .construct import peg, qc_expand

__all__ = [
    "QCCode",
    "build_qc_code",
    "build_qc_code_edges",
    "qc_peg",
    "qc_ira",
    "find_girth6_shifts",
]


@dataclasses.dataclass(frozen=True)
class QCCode:
    """QC structure companion to :class:`Code` (same H, block view).

    base: [Mb, Nb] shift matrix (−1 = zero block) as a tuple of tuples, so
    the object is hashable and per-code tables can be cached on it.
    vn_blocks[bj] = ((bi, shift), ...) sorted by bi (column slot order);
    cn_blocks[bi] = ((bj, shift), ...) sorted by bj (row slot order).

    Generalizations for real standards: ``extra_edges`` lists further
    circulants of a (bi, bj) pair beyond the one ``base`` records, and
    ``minus_edges`` entries (bi, bj, shift, r) remove the edge at row offset
    r of that circulant.  The min-sum decoder's row tables take both
    (:func:`..decoders.minsum_qc.qc_plan`).
    """

    z: int
    mb: int
    nb: int
    base: Tuple[Tuple[int, ...], ...]
    vn_blocks: Tuple[Tuple[Tuple[int, int], ...], ...]
    cn_blocks: Tuple[Tuple[Tuple[int, int], ...], ...]
    extra_edges: Tuple[Tuple[int, int, int], ...] = ()
    minus_edges: Tuple[Tuple[int, int, int, int], ...] = ()

    @property
    def n(self) -> int:
        return self.nb * self.z

    @property
    def m(self) -> int:
        return self.mb * self.z

    @property
    def dv_max(self) -> int:
        return max(len(b) for b in self.vn_blocks)

    @property
    def dc_max(self) -> int:
        return max(len(b) for b in self.cn_blocks)

    @classmethod
    def from_reference(cls, obj) -> "QCCode":
        """Copy a ``QCCode`` of the JAX package (read by attribute, so the
        port needs no import of it)."""

        def tup(x):
            return tuple(tup(v) for v in x) if isinstance(
                x, (tuple, list)
            ) else int(x)

        return cls(
            z=int(obj.z), mb=int(obj.mb), nb=int(obj.nb),
            base=tup(obj.base), vn_blocks=tup(obj.vn_blocks),
            cn_blocks=tup(obj.cn_blocks), extra_edges=tup(obj.extra_edges),
            minus_edges=tup(obj.minus_edges),
        )

    def to_code(self, device="cpu") -> Code:
        """Expanded slot-array Code (same H, same slot order)."""
        return build_code(self.to_alist(), device=device)

    def to_alist(self) -> Alist:
        if not self.extra_edges and not self.minus_edges:
            return qc_expand(np.array(self.base), self.z)
        # general expansion (multi-edge blocks, defect edges)
        minus = set(self.minus_edges)
        n, m, z = self.n, self.m, self.z
        nlist: List[List[int]] = [[] for _ in range(n)]
        mlist: List[List[int]] = [[] for _ in range(m)]
        for bi in range(self.mb):
            for bj, s in self.cn_blocks[bi]:
                for r in range(z):
                    if (bi, bj, s, r) in minus:
                        continue
                    row = bi * z + r
                    col = bj * z + (r + s) % z
                    mlist[row].append(col)
                    nlist[col].append(row)
        for lst in nlist:
            lst.sort()
        for lst in mlist:
            lst.sort()
        return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def build_qc_code(base: np.ndarray, z: int) -> QCCode:
    base = np.asarray(base, np.int64)
    mb, nb = base.shape
    edges = [
        (int(bi), int(bj), int(base[bi, bj]) % z)
        for bi in range(mb)
        for bj in range(nb)
        if base[bi, bj] >= 0
    ]
    return build_qc_code_edges(edges, z, mb, nb)


def build_qc_code_edges(
    edges: List[Tuple[int, int, int]],
    z: int,
    mb: int,
    nb: int,
    minus_edges: Tuple[Tuple[int, int, int, int], ...] = (),
) -> QCCode:
    """QCCode from an explicit circulant-edge list (repeats = multi-edge
    blocks; ``minus_edges`` removes single edges from their circulants)."""
    edges = [(int(bi), int(bj), int(s) % z) for bi, bj, s in edges]
    base = np.full((mb, nb), -1, np.int64)
    extra: List[Tuple[int, int, int]] = []
    for bi, bj, s in edges:
        if base[bi, bj] < 0:
            base[bi, bj] = s
        else:
            extra.append((bi, bj, s))
    vn_blocks: List[Tuple[Tuple[int, int], ...]] = []
    for bj in range(nb):
        rows = sorted((bi, s) for (bi, b2, s) in edges if b2 == bj)
        vn_blocks.append(tuple(rows))
    cn_blocks: List[Tuple[Tuple[int, int], ...]] = []
    for bi in range(mb):
        cols = sorted((bj, s) for (b1, bj, s) in edges if b1 == bi)
        cn_blocks.append(tuple(cols))
    return QCCode(
        z=z,
        mb=mb,
        nb=nb,
        base=tuple(tuple(int(v) for v in row) for row in base),
        vn_blocks=tuple(vn_blocks),
        cn_blocks=tuple(cn_blocks),
        extra_edges=tuple(extra),
        minus_edges=tuple(
            (int(a), int(b), int(s) % z, int(r) % z)
            for a, b, s, r in minus_edges
        ),
    )


def _base_cycles4_ok(base: np.ndarray, z: int) -> bool:
    """No 4-cycles: for every pair of columns sharing two base rows,
    (s[r1,c1] − s[r1,c2] + s[r2,c2] − s[r2,c1]) ≠ 0 (mod z)."""
    mb, nb = base.shape
    for c1 in range(nb):
        for c2 in range(c1 + 1, nb):
            rows = [
                r for r in range(mb) if base[r, c1] >= 0 and base[r, c2] >= 0
            ]
            for i in range(len(rows)):
                for j in range(i + 1, len(rows)):
                    r1, r2 = rows[i], rows[j]
                    d = (
                        base[r1, c1] - base[r1, c2] + base[r2, c2] - base[r2, c1]
                    ) % z
                    if d == 0:
                        return False
    return True


def find_girth6_shifts(
    base_mask: np.ndarray, z: int, seed: int = 0, tries: int = 2000
) -> np.ndarray:
    """Assign random circulant shifts to a 0/1 base-graph mask until the
    expanded graph has girth ≥ 6 (no 4-cycles)."""
    rng = np.random.default_rng(seed)
    mb, nb = base_mask.shape
    for _ in range(tries):
        base = np.where(base_mask > 0, rng.integers(0, z, (mb, nb)), -1)
        if _base_cycles4_ok(base, z):
            return base
    raise RuntimeError("no girth-6 shift assignment found; increase z/tries")


def qc_peg(nb: int, mb: int, dv: int, z: int, seed: int = 0) -> QCCode:
    """QC code: PEG base graph + random girth-6 circulant shifts.
    (nb*z, mb*z) code, dv-regular."""
    base_alist = peg(nb, mb, dv, seed=seed)
    mask = base_alist.to_dense()
    base = find_girth6_shifts(mask, z, seed=seed)
    return build_qc_code(base, z)


def qc_ira(
    nb_info: int,
    mb: int,
    z: int,
    dv_info: int = 4,
    seed: int = 0,
    tries: int = 2000,
) -> QCCode:
    """802.11n/802.16e-style IRA-structured QC code.

    Base = [H_info | h0 | T]: a PEG-constructed info part of column weight
    ``dv_info``, a weight-3 first parity column (rows 0, mb//2, mb−1 with
    shifts s, 0, s) and a zero-shift dual-diagonal accumulator T.  Shifts on
    the info part are searched for girth ≥ 6 with the fixed parity structure
    included in the cycle test.  The shift table is a girth-6 search of our
    own, not the standard's.
    """
    rng = np.random.default_rng(seed)
    nb = nb_info + mb
    info_alist = peg(nb_info, mb, dv_info, seed=seed)
    info_mask = info_alist.to_dense()  # [mb, nb_info]

    def parity_base(s0: int) -> np.ndarray:
        p = np.full((mb, mb), -1, np.int64)
        p[0, 0] = s0
        p[mb // 2, 0] = 0
        p[mb - 1, 0] = s0
        for i in range(mb - 1):
            p[i, i + 1] = 0
            p[i + 1, i + 1] = 0
        return p

    for _ in range(tries):
        base = np.full((mb, nb), -1, np.int64)
        base[:, :nb_info] = np.where(
            info_mask > 0, rng.integers(0, z, (mb, nb_info)), -1
        )
        base[:, nb_info:] = parity_base(int(rng.integers(1, z)))
        if _base_cycles4_ok(base, z):
            return build_qc_code(base, z)
    raise RuntimeError("no girth-6 IRA shift assignment found")
