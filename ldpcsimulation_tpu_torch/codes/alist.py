"""MacKay *alist* sparse-matrix format: parsing, writing, orientation handling.

The alist format describes a binary (or GF(q)) sparse parity-check matrix H with
N columns (variable nodes) and M rows (check nodes):

    line 1:  N M            (binary)   |   N M q   (non-binary)
    line 2:  dv_max dc_max
    line 3:  per-column degrees (N integers)
    line 4:  per-row degrees (M integers)
    next N lines:  for column n, the 1-based row indices of its nonzeros
                   (optionally zero-padded out to dv_max)
    next M lines:  for row m, the 1-based column indices of its nonzeros
                   (optionally zero-padded out to dc_max)

Non-binary files interleave (position, GF-value) pairs on the adjacency lines.

Behavioral parity notes (reference = ereiss123/LDPCsimulation):
  * Binary loader: ``C_implementations/src/alist.cpp:22-95`` — reads the dual
    adjacency lists ``nlist[n][j]`` (checks touching column n) and
    ``mlist[m][j]`` (symbols touching row m) in file order.  We preserve file
    order exactly, because min-sum tie-breaking and trace tools are sensitive
    to the slot ordering (``decodeMinSum.cpp:428-437``).
  * Non-binary loader: ``SystemC/NB-LDPC/src/alist.cpp:23-124`` — header
    "N M q", interleaved (index, value) pairs via ``fread_nbmatrix``.
  * The reference ships *transposed* alists (header "M N", adjacency roles
    swapped): ``SystemC/NGDBF/codes/PegReg/PEGReg504x1008.alist`` starts
    "504 1008" and ``ldpcsim.cpp:107-110`` silently role-swaps.  Since a code
    always has N > M (rate > 0), :func:`load_alist` auto-detects and
    normalizes the orientation unless told otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Alist", "parse_alist", "load_alist", "dumps_alist", "save_alist"]


@dataclasses.dataclass
class Alist:
    """Parsed alist: dual adjacency lists in file order, 0-based indices.

    ``nlist[n]`` lists the check (row) indices adjacent to variable (column)
    ``n``; ``mlist[m]`` lists the variable indices adjacent to check ``m``.
    For non-binary codes, ``nvals``/``mvals`` carry the GF(q) coefficient of
    each edge in the same slot order, and ``q`` > 0.
    """

    n: int
    m: int
    nlist: List[List[int]]
    mlist: List[List[int]]
    q: int = 0  # 0 => binary file (no GF column)
    nvals: Optional[List[List[int]]] = None
    mvals: Optional[List[List[int]]] = None

    @property
    def dv(self) -> List[int]:
        return [len(x) for x in self.nlist]

    @property
    def dc(self) -> List[int]:
        return [len(x) for x in self.mlist]

    @property
    def dv_max(self) -> int:
        return max(self.dv) if self.nlist else 0

    @property
    def dc_max(self) -> int:
        return max(self.dc) if self.mlist else 0

    @property
    def num_edges(self) -> int:
        return sum(self.dv)

    def transpose(self) -> "Alist":
        """Swap row/column roles (used to normalize transposed files)."""
        return Alist(
            n=self.m,
            m=self.n,
            nlist=[list(x) for x in self.mlist],
            mlist=[list(x) for x in self.nlist],
            q=self.q,
            nvals=None if self.mvals is None else [list(x) for x in self.mvals],
            mvals=None if self.nvals is None else [list(x) for x in self.nvals],
        )

    def to_dense(self) -> np.ndarray:
        """Dense H as int array; entries are GF values (1 for binary)."""
        h = np.zeros((self.m, self.n), dtype=np.int32)
        for j, (rows) in enumerate(self.nlist):
            vals = self.nvals[j] if self.nvals is not None else [1] * len(rows)
            for i, v in zip(rows, vals):
                h[i, j] = v
        return h

    def validate(self) -> None:
        """Check that nlist and mlist describe the same matrix."""
        edges_n = {(i, j) for j, rows in enumerate(self.nlist) for i in rows}
        edges_m = {(i, j) for i, cols in enumerate(self.mlist) for j in cols}
        if edges_n != edges_m:
            raise ValueError(
                f"alist adjacency mismatch: nlist has {len(edges_n)} edges, "
                f"mlist has {len(edges_m)}, symmetric difference "
                f"{len(edges_n ^ edges_m)}"
            )
        if self.q:
            vals_n = {
                (i, j): v
                for j, (rows, vv) in enumerate(zip(self.nlist, self.nvals))
                for i, v in zip(rows, vv)
            }
            vals_m = {
                (i, j): v
                for i, (cols, vv) in enumerate(zip(self.mlist, self.mvals))
                for j, v in zip(cols, vv)
            }
            if vals_n != vals_m:
                raise ValueError("alist GF coefficient mismatch between nlist/mvals")


def _parse_adjacency_line(tokens: Sequence[int], degree: int, what: str) -> List[int]:
    """One adjacency line: `degree` 1-based entries, optionally zero-padded."""
    entries = [t for t in tokens if t != 0]
    if len(entries) != degree:
        raise ValueError(
            f"{what}: expected {degree} nonzero entries, got {len(entries)} "
            f"in line {tokens!r}"
        )
    return [t - 1 for t in entries]


def _parse_nb_adjacency_line(
    tokens: Sequence[int], degree: int, what: str
) -> tuple[List[int], List[int]]:
    """Non-binary adjacency line: (index, value) pairs, optionally 0,0-padded.

    Mirrors ``fread_nbmatrix`` (SystemC/NB-LDPC/src/alist.cpp:97-124) which
    reads exactly ``degree`` pairs.
    """
    pairs = [(tokens[i], tokens[i + 1]) for i in range(0, len(tokens) - 1, 2)]
    pairs = [(p, v) for (p, v) in pairs if p != 0]
    if len(pairs) != degree:
        raise ValueError(
            f"{what}: expected {degree} (index,value) pairs, got {len(pairs)}"
        )
    return [p - 1 for p, _ in pairs], [v for _, v in pairs]


def parse_alist(text: str, nonbinary: Optional[bool] = None) -> Alist:
    """Parse alist text (binary or non-binary).

    ``nonbinary=None`` auto-detects from the header arity (3 leading ints on
    line one => "N M q" non-binary header).
    """
    lines = [ln for ln in (l.strip() for l in text.splitlines()) if ln]
    if len(lines) < 4:
        raise ValueError("alist too short")
    header = [int(t) for t in lines[0].split()]
    if nonbinary is None:
        nonbinary = len(header) >= 3
    if nonbinary:
        if len(header) < 3:
            raise ValueError(f"non-binary alist needs 'N M q' header, got {header}")
        n, m, q = header[:3]
    else:
        n, m = header[:2]
        q = 0

    dmax = [int(t) for t in lines[1].split()]
    dv_max, dc_max = dmax[0], dmax[1]

    # Degree lists may wrap across lines in some writers; consume a flat token
    # stream for them.
    toks: List[int] = []
    idx = 2
    while len(toks) < n + m and idx < len(lines):
        toks.extend(int(t) for t in lines[idx].split())
        idx += 1
    if len(toks) < n + m:
        raise ValueError("alist truncated in degree lists")
    dv = toks[:n]
    dc = toks[n : n + m]
    extra = toks[n + m :]  # tokens spilled past the degree lists

    # Adjacency lines: one line per node (zero-padded or not). If a previous
    # line spilled tokens, fold them back in front.
    adj_tokens: List[int] = list(extra)
    for j in range(idx, len(lines)):
        adj_tokens.extend(int(t) for t in lines[j].split())

    nlist: List[List[int]] = []
    mlist: List[List[int]] = []
    nvals: Optional[List[List[int]]] = [] if nonbinary else None
    mvals: Optional[List[List[int]]] = [] if nonbinary else None

    pos = 0
    per_entry = 2 if nonbinary else 1
    total_needed = per_entry * (sum(dv) + sum(dc))
    padded = len(adj_tokens) >= per_entry * (n * dv_max + m * dc_max)
    if not padded and len(adj_tokens) < total_needed:
        raise ValueError(
            f"alist truncated in adjacency lists: have {len(adj_tokens)} tokens, "
            f"need at least {total_needed}"
        )

    def take(degree: int, width: int) -> List[int]:
        nonlocal pos
        count = per_entry * (width if padded else degree)
        out = adj_tokens[pos : pos + count]
        pos += count
        return out

    for col in range(n):
        t = take(dv[col], dv_max)
        if nonbinary:
            e, v = _parse_nb_adjacency_line(t, dv[col], f"column {col}")
            nlist.append(e)
            nvals.append(v)
        else:
            nlist.append(_parse_adjacency_line(t, dv[col], f"column {col}"))
    for row in range(m):
        t = take(dc[row], dc_max)
        if nonbinary:
            e, v = _parse_nb_adjacency_line(t, dc[row], f"row {row}")
            mlist.append(e)
            mvals.append(v)
        else:
            mlist.append(_parse_adjacency_line(t, dc[row], f"row {row}"))

    out = Alist(n=n, m=m, nlist=nlist, mlist=mlist, q=q, nvals=nvals, mvals=mvals)
    if out.dv_max != dv_max or out.dc_max != dc_max:
        raise ValueError(
            f"declared max degrees ({dv_max},{dc_max}) != observed "
            f"({out.dv_max},{out.dc_max})"
        )
    return out


def load_alist(
    path: str,
    orientation: str = "auto",
    nonbinary: Optional[bool] = None,
    validate: bool = True,
) -> Alist:
    """Load an alist file, normalizing to columns=variables / rows=checks.

    orientation:
      * ``"auto"`` — if the header's first dimension is *smaller* than the
        second, assume the file is transposed (checks listed first, as in the
        SystemC trees — `SystemC/NGDBF/src/ldpcsim.cpp:107-110`) and swap.
        Valid for every real code since N > M whenever rate > 0.
      * ``"normal"`` — trust the file as-is (N M header).
      * ``"transposed"`` — unconditionally swap roles.
    """
    with open(path, "r") as f:
        a = parse_alist(f.read(), nonbinary=nonbinary)
    if orientation == "transposed" or (orientation == "auto" and a.n < a.m):
        a = a.transpose()
    elif orientation not in ("auto", "normal"):
        raise ValueError(f"bad orientation {orientation!r}")
    if validate:
        a.validate()
    return a


def dumps_alist(a: Alist, pad: bool = True) -> str:
    """Serialize to alist text (1-based indices, zero-padded by default)."""
    out: List[str] = []
    if a.q:
        out.append(f"{a.n} {a.m} {a.q}")
    else:
        out.append(f"{a.n} {a.m}")
    out.append(f"{a.dv_max} {a.dc_max}")
    out.append(" ".join(str(d) for d in a.dv))
    out.append(" ".join(str(d) for d in a.dc))

    def fmt(entries: List[int], vals: Optional[List[int]], width: int) -> str:
        toks: List[str] = []
        for k in range(width if pad else len(entries)):
            if k < len(entries):
                toks.append(str(entries[k] + 1))
                if a.q:
                    toks.append(str(vals[k]))
            else:
                toks.append("0")
                if a.q:
                    toks.append("0")
        return " ".join(toks)

    for col in range(a.n):
        out.append(fmt(a.nlist[col], a.nvals[col] if a.q else None, a.dv_max))
    for row in range(a.m):
        out.append(fmt(a.mlist[row], a.mvals[row] if a.q else None, a.dc_max))
    return "\n".join(out) + "\n"


def save_alist(a: Alist, path: str, pad: bool = True) -> None:
    with open(path, "w") as f:
        f.write(dumps_alist(a, pad=pad))


def from_dense(h: np.ndarray, q: int = 0) -> Alist:
    """Build an Alist from a dense matrix (rows=checks, cols=variables).

    Adjacency order is ascending index, matching how MacKay's tools emit
    alists. Nonzero entries are the GF values when ``q`` > 0.
    """
    m, n = h.shape
    nlist = [[int(i) for i in np.flatnonzero(h[:, j])] for j in range(n)]
    mlist = [[int(j) for j in np.flatnonzero(h[i, :])] for i in range(m)]
    nvals = mvals = None
    if q:
        nvals = [[int(h[i, j]) for i in rows] for j, rows in enumerate(nlist)]
        mvals = [[int(h[i, j]) for j in cols] for i, cols in enumerate(mlist)]
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist, q=q, nvals=nvals, mvals=mvals)
