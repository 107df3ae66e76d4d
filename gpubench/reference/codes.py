"""The parity-check matrix of a quasi-cyclic code from its frozen table.

A table (``codes/<name>.json``) holds the base matrix of circulant shifts
(−1 for a zero block) and the circulant size ``z``.  Check ``bi·z + r`` and
column ``bj·z + (r + s) mod z`` share an edge for every block ``(bi, bj)``
of shift ``s ≥ 0``.  Two optional keys generalize it, as real standards
need (DVB-S2 in its QC form):

* ``extra``: further circulants ``[bi, bj, s]`` of a block pair that
  ``base`` already gives one;
* ``minus``: single absent edges ``[bi, bj, s, r]``: the edge at row
  offset ``r`` of circulant ``(bi, bj, s)`` is not there.

Each column's edges are listed in the order of their checks, which is the
order in which the decoders add a column's messages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

TABLES = Path(__file__).resolve().parent.parent / "codes"


@dataclasses.dataclass(frozen=True)
class Graph:
    """n columns, m checks and e edges; ``check_edges [m, dc_max]`` and
    ``col_edges [n, dv_max]`` name the edges (0 … e − 1) of each check and
    of each column, the latter by ascending check, and the spare edge ``e``
    past a row's degree; ``check_cols [m, dc_max]`` gives the column of each
    check edge (``n`` for the spare), ``col_checks [n, dv_max]`` the check
    of each column edge (``m`` for the spare)."""

    n: int
    m: int
    e: int
    check_edges: torch.Tensor
    col_edges: torch.Tensor
    check_cols: torch.Tensor
    col_checks: torch.Tensor

    @property
    def k(self) -> int:
        return self.n - self.m

    def to(self, device) -> "Graph":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def load_table(name: str) -> dict:
    """The frozen table ``codes/<name>.json``."""
    return json.loads((TABLES / f"{name}.json").read_text())


def circulants(table: dict) -> tuple:
    """(the circulants ``(bi, bj, s)``: ``base``'s row by row, then
    ``extra``'s in their order; the absent edges ``(bi, bj, s, r)``) of a
    table, shifts taken mod z."""
    z, base = table["z"], table["base"]
    edges = [(bi, bj, s % z) for bi, row in enumerate(base)
             for bj, s in enumerate(row) if s >= 0]
    edges += [(bi, bj, s % z) for bi, bj, s in table.get("extra", [])]
    minus = [(bi, bj, s % z, r % z)
             for bi, bj, s, r in table.get("minus", [])]
    return edges, minus


def graph(table: dict) -> Graph:
    """The :class:`Graph` of a QC table (full rank assumed: k = n − m)."""
    z, base = table["z"], table["base"]
    mb, nb = len(base), len(base[0])
    n, m = nb * z, mb * z
    edges, minus = circulants(table)
    r = np.arange(z)
    col = np.concatenate([bj * z + (r + s) % z for _, bj, s in edges])
    chk = np.concatenate([bi * z + r for bi, _, _ in edges])
    if minus:
        gone = [(bi * z + at) * n + bj * z + (at + s) % z
                for bi, bj, s, at in minus]
        keep = ~np.isin(chk * n + col, gone)
        col, chk = col[keep], chk[keep]
    order = np.lexsort((chk, col))  # by column, then by check
    e = len(order)
    col = torch.from_numpy(np.append(col[order], n).astype(np.int64))
    chk = torch.from_numpy(np.append(chk[order], m).astype(np.int64))
    col_edges = _rows(col[:-1], n, e)
    check_edges = _rows(chk[:-1], m, e)
    return Graph(n=n, m=m, e=e, check_edges=check_edges,
                 col_edges=col_edges, check_cols=col[check_edges],
                 col_checks=chk[col_edges])


def _rows(owner: torch.Tensor, rows: int, spare: int) -> torch.Tensor:
    """[rows, degree_max] edge ids of each row in edge order (``owner[i]``
    the row of edge i), ``spare`` past a row's degree."""
    order = torch.argsort(owner, stable=True)
    deg = torch.bincount(owner, minlength=rows)
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(len(owner)) - start[owner[order]]
    out = torch.full((rows, int(deg.max())), spare, dtype=torch.int64)
    out[owner[order], slot] = order
    return out
