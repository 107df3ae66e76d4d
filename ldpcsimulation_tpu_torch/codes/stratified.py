"""Stratified block-permutation structure: the edge permutation of a code
that is neither circulant nor QC-relabelable, as static row tables.

Port of ``ldpcsimulation_tpu.codes.stratified``, with the same partitions
found in the same order:

  * rows partition into ``mb`` strata such that every column has at most
    one edge per stratum (contiguous blocks, as in the 802.3an RS-LDPC H,
    ``C_implementations/codes/802_3/802_3_H.alist``; greedy row coloring
    otherwise);
  * columns partition into ``kg`` groups that are independent sets of the
    column conflict graph (no two members share a row): the RS exact
    partition where it holds, else capacity-bounded greedy coloring.

Within one (stratum, group) pair the edges form a partial permutation, so
every message has one slot in each of two padded grids:

  * VN slots ``[mb, kg, w, B]`` — one message per (stratum, column);
  * CN slots ``[mb, h, kg, B]`` — one message per (stratum row, group).

The JAX package moves messages between them with an ``[mb, kg, w, h]`` f32
one-hot einsum on the TPU's MXU.  Here the same map is two index tables:
``cn_from_vn`` (per CN slot, its flat VN-slot row ``(b·kg + g)·w + j``, or
−1) and ``vn_from_cn`` (per VN slot, its flat CN slot ``(b·h + i)·kg + g``,
or −1).  ``cn_from_vn`` reshaped to ``[mb·h, kg]`` is kernel B1's routing
table: the check update reads the VN-slot planes and writes them back in
place, so neither interleave is materialized (``decoders/minsum_stratified``).

Every rejection of the JAX module is kept, the one-hot size limit
included although the port never allocates the one-hot, so that
:func:`detect_stratified` returns None on exactly the alists where JAX's
does and both sweep CLIs route the same file the same way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .alist import Alist

__all__ = ["StratifiedCode", "stratify", "detect_stratified"]

_ARRAY_FIELDS = ("col_slot", "pos_of_col", "row_of", "vn_valid", "cn_valid",
                 "cn_rank", "cn_from_vn", "vn_from_cn")


@dataclasses.dataclass(frozen=True, eq=False)
class StratifiedCode:
    """Stratified slot grids of a binary code (layouts in the module
    docstring; B, the batch, always last).

    col_slot:   [kg, w] int32 — column of each grid cell, −1 pad.
    pos_of_col: [N] int32 — flat grid position ``g·w + c`` of each column.
    row_of:     [mb, h] int32 — row of each stratum cell, −1 pad.
    vn_valid:   [mb, kg, w] bool — the column has an edge in the stratum.
    cn_valid:   [mb, h, kg] bool — the row has an edge in the group.
    cn_rank:    [mb, h, kg] int32 — the edge's position in the row's alist
                order, −1 pad.
    cn_from_vn: [mb, h, kg] int32 — flat VN-slot row of each CN slot, −1.
    vn_from_cn: [mb, kg, w] int32 — flat CN slot of each VN slot, −1.
    """

    n: int
    m: int
    mb: int  # number of row strata
    h: int   # stratum height (padded)
    kg: int  # number of column groups
    w: int   # group width (padded)
    num_edges: int

    col_slot: torch.Tensor
    pos_of_col: torch.Tensor
    row_of: torch.Tensor
    vn_valid: torch.Tensor
    cn_valid: torch.Tensor
    cn_rank: torch.Tensor
    cn_from_vn: torch.Tensor
    vn_from_cn: torch.Tensor

    @property
    def cost(self) -> float:
        """Slot-traffic overhead vs ideal edge arrays (1.0 = perfect)."""
        return (self.mb * self.kg * self.w + self.mb * self.h * self.kg) / (
            2.0 * self.num_edges
        )

    def to(self, device) -> "StratifiedCode":
        """The same structure with its tables on ``device`` (self if they
        are there already)."""
        device = torch.device(device)
        if self.col_slot.device == device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _ARRAY_FIELDS
        })

    def __repr__(self) -> str:
        return (
            f"StratifiedCode(n={self.n}, m={self.m}, "
            f"strata={self.mb}x{self.h}, groups={self.kg}x{self.w}, "
            f"cost={self.cost:.2f})"
        )


def _contiguous_strata(alist: Alist) -> Optional[List[List[int]]]:
    """Largest h | m whose contiguous h-row blocks give each column <= 1
    edge per block (the 802.3an layout).  None if no useful h works.

    Only *dense* strata qualify (dv_max <= mb <= 2·dv_max): every m has the
    degenerate h=1 solution, whose near-empty slot grid is wasteful (cost
    ~dc/2).  Sparse cases fall back to greedy coloring."""
    m = alist.m
    dv_max = alist.dv_max
    for h in sorted((d for d in range(1, m + 1) if m % d == 0), reverse=True):
        if not dv_max <= m // h <= 2 * dv_max:
            continue
        seen = np.zeros((alist.n,), np.int64)
        ok = True
        for b in range(m // h):
            seen[:] = 0
            for r in range(b * h, (b + 1) * h):
                for c in alist.mlist[r]:
                    if seen[c]:
                        ok = False
                        break
                    seen[c] = 1
                if not ok:
                    break
            if not ok:
                break
        if ok:
            return [list(range(b * h, (b + 1) * h)) for b in range(m // h)]
    return None


def _greedy_row_strata(alist: Alist) -> List[List[int]]:
    """Greedy coloring of the row conflict graph (rows sharing a column)."""
    m = alist.m
    adj: List[set] = [set() for _ in range(m)]
    for rows in alist.nlist:
        for a in rows:
            adj[a].update(rows)
    for a in range(m):
        adj[a].discard(a)
    order = sorted(range(m), key=lambda r: -len(adj[r]))
    color = [-1] * m
    for r in order:
        used = {color[o] for o in adj[r] if color[o] >= 0}
        k = 0
        while k in used:
            k += 1
        color[r] = k
    strata: List[List[int]] = [[] for _ in range(max(color) + 1)]
    for r, k in enumerate(color):
        strata[k].append(r)
    return strata


def _rs_exact_col_groups(
    alist: Alist, row_strata: Sequence[Sequence[int]]
) -> Optional[List[List[int]]]:
    """The *exact* equitable column partition of a permutation-array code
    (the 802.3an RS-LDPC class): ``n/h`` groups of exactly ``h`` columns,
    each an exact cover of all rows (zero padding, cost 1.0).

    Column ``(a, b)`` over GF(h) has its stratum-``i`` edge at row
    ``a·x_i + b``; columns of equal slope ``a`` form the groups.  The slopes
    are hidden by the file's relabeling, but a same-slope consistency
    relation is not: for columns c, c' and strata i≠j the crossover column
    with rows ``(r_i(c'), r_j(c))`` exists iff the mirrored one at
    ``(r_i(c), r_j(c'))`` does.  A mutual-neighbor filter removes the
    chance passes, and connected components are the groups.  None (the
    caller colors greedily) where the structure does not hold.
    """
    n, m = alist.n, alist.m
    mb = len(row_strata)
    if mb < 4 or n > 8192 or n % (m // mb) or m % mb:
        return None  # need >=6 pair-tests; O(n^2) arrays must stay small
    h = m // mb
    if any(len(s) != h for s in row_strata):
        return None
    stratum_of = np.full(m, -1, np.int64)
    rowpos = np.full(m, -1, np.int64)
    for b, s in enumerate(row_strata):
        for i, r in enumerate(s):
            stratum_of[r] = b
            rowpos[r] = i

    # per-column stratum-row tuple; requires exactly one edge per stratum
    R = np.full((n, mb), -1, np.int64)
    for c in range(n):
        rows = alist.nlist[c]
        if len(rows) != mb:
            return None
        for r in rows:
            b = stratum_of[r]
            if R[c, b] >= 0:
                return None
            R[c, b] = rowpos[r]

    exists = np.zeros((mb, mb, h, h), bool)
    for i in range(mb):
        for j in range(mb):
            exists[i, j, R[:, i], R[:, j]] = True

    conflict = np.zeros((n, n), bool)
    for i in range(mb):
        conflict |= R[:, i][:, None] == R[:, i][None, :]

    passing = ~conflict
    for i in range(mb):
        for j in range(i + 1, mb):
            E = exists[i, j]
            passing &= E[R[:, i][None, :], R[:, j][:, None]] == (
                E[R[:, i][:, None], R[:, j][None, :]]
            )

    # true groupmates share ~h-2 passing-neighbors; false positives ~0
    P = passing.astype(np.float32)
    strong = passing & ((P @ P.T) >= h // 2)

    color = np.full(n, -1, np.int64)
    k = 0
    for c in range(n):
        if color[c] >= 0:
            continue
        stack = [c]
        color[c] = k
        while stack:
            u = stack.pop()
            for v in np.nonzero(strong[u])[0]:
                if color[v] < 0:
                    color[v] = int(k)
                    stack.append(int(v))
        k += 1
    if k != n // h or (np.bincount(color) != h).any():
        return None
    groups = [np.nonzero(color == g)[0].tolist() for g in range(k)]
    for grp in groups:  # each group must cover every row exactly once
        rows = [r for c in grp for r in alist.nlist[c]]
        if len(set(rows)) != m:
            return None
    return groups


def _greedy_col_groups(alist: Alist, cap: int) -> List[List[int]]:
    """Capacity-bounded greedy coloring of the column conflict graph
    (columns sharing a row conflict); each color class is an independent
    set, so every (stratum, group) block is a partial permutation."""
    n = alist.n
    adj: List[set] = [set() for _ in range(n)]
    for cols in alist.mlist:
        for a in cols:
            adj[a].update(cols)
    for a in range(n):
        adj[a].discard(a)
    order = sorted(range(n), key=lambda c: -len(adj[c]))
    color = [-1] * n
    counts: dict = {}
    for c in order:
        used = {color[o] for o in adj[c] if color[o] >= 0}
        k = 0
        while k in used or counts.get(k, 0) >= cap:
            k += 1
        color[c] = k
        counts[k] = counts.get(k, 0) + 1
    groups: List[List[int]] = [[] for _ in range(max(color) + 1)]
    for c, k in enumerate(color):
        groups[k].append(c)
    return groups


def stratify(
    alist: Alist,
    row_strata: Optional[Sequence[Sequence[int]]] = None,
    col_groups: Optional[Sequence[Sequence[int]]] = None,
    cap: Optional[int] = None,
    max_cost: Optional[float] = None,
) -> StratifiedCode:
    """The stratified structure of a binary alist, its tables on the CPU.

    ``row_strata``/``col_groups`` override the automatic search (they must
    satisfy the <=1-edge-per-stratum-column / independent-set invariants,
    which are verified here).  ``max_cost`` rejects (ValueError) structures
    whose slot-traffic overhead exceeds the bound.  A structure whose JAX
    one-hot ``[mb, kg, w, h]`` would pass 2^30 entries is rejected as
    JAX's is, so both packages accept the same alists.
    """
    if getattr(alist, "q", 0) and alist.q > 2:
        raise ValueError("stratified structure is for binary codes")
    n, m = alist.n, alist.m

    if row_strata is None:
        row_strata = _contiguous_strata(alist) or _greedy_row_strata(alist)
    row_strata = [list(s) for s in row_strata]
    mb = len(row_strata)
    h = max(len(s) for s in row_strata)

    if col_groups is None:
        col_groups = _rs_exact_col_groups(alist, row_strata)
        if col_groups is None:
            if cap is None:
                cap = max(64, h)
            col_groups = _greedy_col_groups(alist, cap)
    col_groups = [list(g) for g in col_groups]
    kg = len(col_groups)
    w = max(len(g) for g in col_groups)

    stratum_of = np.full(m, -1, np.int64)
    rowpos = np.full(m, -1, np.int64)
    for b, s in enumerate(row_strata):
        for i, r in enumerate(s):
            stratum_of[r] = b
            rowpos[r] = i
    group_of = np.full(n, -1, np.int64)
    colpos = np.full(n, -1, np.int64)
    for g, grp in enumerate(col_groups):
        for i, c in enumerate(grp):
            group_of[c] = g
            colpos[c] = i
    if (stratum_of < 0).any() or (group_of < 0).any():
        raise ValueError("strata/groups must cover all rows/columns")

    col_slot = np.full((kg, w), -1, np.int32)
    for g, grp in enumerate(col_groups):
        col_slot[g, : len(grp)] = grp
    pos_of_col = (group_of * w + colpos).astype(np.int32)
    row_of = np.full((mb, h), -1, np.int32)
    for b, s in enumerate(row_strata):
        row_of[b, : len(s)] = s

    edges = sum(len(cols) for cols in alist.mlist)
    slot_cost = (mb * kg * w + mb * h * kg) / (2.0 * max(edges, 1))
    if max_cost is not None and slot_cost > max_cost:
        raise ValueError(
            f"stratified slot cost {slot_cost:.2f} exceeds max_cost "
            f"{max_cost:.2f}"
        )
    if mb * kg * w * h > 1 << 30:  # JAX's one-hot limit (4 GiB of f32)
        raise ValueError(
            f"stratified one-hot tensor {mb}x{kg}x{w}x{h} is too large"
        )

    vn_valid = np.zeros((mb, kg, w), bool)
    cn_valid = np.zeros((mb, h, kg), bool)
    cn_rank = np.full((mb, h, kg), -1, np.int32)
    cn_from_vn = np.full((mb, h, kg), -1, np.int32)
    vn_from_cn = np.full((mb, kg, w), -1, np.int32)
    num_edges = 0
    for r, cols in enumerate(alist.mlist):
        b, i = stratum_of[r], rowpos[r]
        for t, c in enumerate(cols):
            g, j = group_of[c], colpos[c]
            if vn_valid[b, g, j]:
                raise ValueError(
                    f"column {c} has two edges in row stratum {b} — "
                    "invalid strata"
                )
            if cn_valid[b, i, g]:
                raise ValueError(
                    f"row {r} has two edges in column group {g} — "
                    "groups are not independent sets"
                )
            vn_valid[b, g, j] = True
            cn_valid[b, i, g] = True
            cn_rank[b, i, g] = t
            cn_from_vn[b, i, g] = (b * kg + g) * w + j
            vn_from_cn[b, g, j] = (b * h + i) * kg + g
            num_edges += 1

    return StratifiedCode(
        n=n, m=m, mb=mb, h=h, kg=kg, w=w, num_edges=num_edges,
        col_slot=torch.from_numpy(col_slot),
        pos_of_col=torch.from_numpy(pos_of_col),
        row_of=torch.from_numpy(row_of),
        vn_valid=torch.from_numpy(vn_valid),
        cn_valid=torch.from_numpy(cn_valid),
        cn_rank=torch.from_numpy(cn_rank),
        cn_from_vn=torch.from_numpy(cn_from_vn),
        vn_from_cn=torch.from_numpy(vn_from_cn),
    )


def detect_stratified(
    alist: Alist, max_cost: float = 2.0
) -> Optional[StratifiedCode]:
    """The stratified structure if its slot overhead is worth it, else None.

    Only codes whose strata are *dense* (mb close to dv) pay off; random
    codes (PEG, MacKay) give sparse strata and stay on the slot arrays.
    ``max_cost`` bounds the slot-traffic overhead (1.0 = perfect; 802.3an
    reaches exactly 1.0 through the RS exact partition).
    """
    if getattr(alist, "q", 0) and alist.q > 2:
        return None
    if alist.n * alist.m == 0:
        return None
    try:
        sc = stratify(alist, max_cost=max_cost)
    except (ValueError, MemoryError):
        return None
    if sc.cost > max_cost:
        return None
    return sc
