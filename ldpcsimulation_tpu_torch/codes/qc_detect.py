"""Auto-detect quasi-cyclic structure in loaded parity-check matrices.

Port of ``ldpcsimulation_tpu.codes.qc_detect``.  The reference stores every
code as a flat alist even when the standard is block-circulant; this module
recovers the structure from the expanded H so the QC decoder can take it:

  * candidate expansion factors z: divisors of gcd(n, m), largest first;
  * candidate row/column orderings: contiguous blocks (the natural QC
    layout) and the q-interleave ``i -> (i mod q)·z + i div q`` (the
    DVB-S2-style storage where block membership is ``i mod q``);
  * a layout is accepted only if EVERY nonzero z×z block is a single
    cyclic shift of the identity, verified edge for edge.

The returned :class:`DetectedQC` satisfies ``expand(qc) == H[row_perm][:,
col_perm]`` as an edge set.  Codes whose blocks are sums of shifts or
general permutations are rejected (None).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .alist import Alist
from .qc import QCCode, build_qc_code

__all__ = ["DetectedQC", "detect_qc", "permuted_decoder"]


@dataclasses.dataclass(frozen=True)
class DetectedQC:
    """QC structure of a loaded H, up to row/column relabeling.

    ``qc`` expands to exactly ``H[row_perm][:, col_perm]``.  Rows are
    checks (relabeling is statistically invisible); columns are variables,
    so decoders run in the permuted order — :func:`permuted_decoder` wraps
    the in/out mapping.
    """

    qc: QCCode
    row_perm: np.ndarray  # [M] original row index per permuted position
    col_perm: np.ndarray  # [N] original column index per permuted position

    @property
    def inv_col_perm(self) -> np.ndarray:
        return np.argsort(self.col_perm)


def _edge_arrays(alist: Alist) -> Tuple[np.ndarray, np.ndarray]:
    rows = []
    cols = []
    for r, lst in enumerate(alist.mlist):
        rows.append(np.full(len(lst), r, np.int64))
        cols.append(np.asarray(lst, np.int64))
    return np.concatenate(rows), np.concatenate(cols)


def _maps(size: int, z: int) -> List[Tuple[str, Optional[np.ndarray]]]:
    """Candidate index relabelings: (name, perm) with perm[i] the PERMUTED
    position of original index i; None denotes identity."""
    q = size // z
    out: List[Tuple[str, Optional[np.ndarray]]] = [("contig", None)]
    if 1 < q < size:
        i = np.arange(size)
        # block = i mod q, offset = i div q (DVB-S2-style interleave)
        out.append(("interleave", (i % q) * z + i // q))
    return out


def _try_layout(
    rows: np.ndarray,
    cols: np.ndarray,
    m: int,
    n: int,
    z: int,
    rmap: Optional[np.ndarray],
    cmap: Optional[np.ndarray],
) -> Optional[np.ndarray]:
    """If every block is a single circulant under the maps, return the
    [mb, nb] shift base matrix (−1 for zero blocks)."""
    pr = rows if rmap is None else rmap[rows]
    pc = cols if cmap is None else cmap[cols]
    mb, nb = m // z, n // z
    bi, ri = pr // z, pr % z
    bj, cj = pc // z, pc % z
    key = bi * nb + bj
    shift = (cj - ri) % z
    order = np.argsort(key, kind="stable")
    k = key[order]
    s = shift[order]
    uniq, start, cnt = np.unique(k, return_index=True, return_counts=True)
    if (cnt != z).any():
        return None
    # all shifts within a block equal
    first = s[start]
    if not (s == np.repeat(first, cnt)).all():
        return None
    # full circulant: the z row offsets of each block are all distinct
    r_sorted = ri[order]
    for st in start:
        if len(np.unique(r_sorted[st : st + z])) != z:
            return None
    base = np.full((mb, nb), -1, np.int64)
    base[uniq // nb, uniq % nb] = first
    return base


def detect_qc(
    alist: Alist,
    z_candidates: Optional[Sequence[int]] = None,
    min_z: int = 4,
    max_candidates: Optional[int] = None,
) -> Optional[DetectedQC]:
    """Detect circulant-block structure; None if no exact layout found.

    Candidates are every divisor z of gcd(n, m) with z >= min_z whose
    block grid could hold the edge set (num_edges % z == 0), largest
    first; all of them are tried unless ``max_candidates`` bounds the list.
    """
    n, m = alist.n, alist.m
    if getattr(alist, "q", 0) and alist.q > 2:
        return None  # non-binary alists keep their own decoders
    rows, cols = _edge_arrays(alist)
    g = math.gcd(n, m)
    if z_candidates is None:
        num_edges = len(rows)
        z_candidates = sorted(
            (
                d
                for d in range(min_z, g + 1)
                if g % d == 0 and num_edges % d == 0
            ),
            reverse=True,
        )
        if max_candidates is not None:
            z_candidates = z_candidates[:max_candidates]
    for z in z_candidates:
        for _rname, rmap in _maps(m, z):
            for _cname, cmap in _maps(n, z):
                base = _try_layout(rows, cols, m, n, z, rmap, cmap)
                if base is None:
                    continue
                row_perm = np.arange(m) if rmap is None else np.argsort(rmap)
                col_perm = np.arange(n) if cmap is None else np.argsort(cmap)
                return DetectedQC(qc=build_qc_code(base, z),
                                  row_perm=row_perm, col_perm=col_perm)
    return None


def permuted_decoder(det: DetectedQC, decode_fn):
    """Wrap a QC decoder so it accepts and returns natural-order frames.

    decode_fn(y_qc [B, N], key) -> result with .hard [B, N] (QC order).
    The wrapper permutes the input columns in and the hard decisions back
    out; one gather each way per decode, on the input's device.
    """
    col = torch.as_tensor(det.col_perm, dtype=torch.int64)
    inv = torch.as_tensor(det.inv_col_perm, dtype=torch.int64)

    def fn(y, key):
        res = decode_fn(y[:, col.to(y.device)], key)
        return dataclasses.replace(
            res, hard=res.hard[:, inv.to(res.hard.device)])

    return fn
