"""The parity-check matrix of a quasi-cyclic code from its frozen table.

A table (``codes/<name>.json``) holds the base matrix of circulant shifts
(−1 for a zero block) and the circulant size ``z``.  Check ``bi·z + r`` and
column ``bj·z + (r + s) mod z`` share an edge for every block ``(bi, bj)``
of shift ``s ≥ 0``.  Each column's edges are listed in the order of their
checks, which is the order in which the decoders add a column's messages.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

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


def graph(table: dict) -> Graph:
    """The :class:`Graph` of a QC table (full rank assumed: k = n − m)."""
    z, base = table["z"], table["base"]
    mb, nb = len(base), len(base[0])
    edges = []  # (column, check)
    for bi in range(mb):
        for bj in range(nb):
            s = base[bi][bj]
            if s >= 0:
                edges += [(bj * z + (r + s) % z, bi * z + r)
                          for r in range(z)]
    edges.sort()  # by column, then by check
    n, m, e = nb * z, mb * z, len(edges)
    col = torch.tensor([c for c, _ in edges] + [n])
    chk = torch.tensor([h for _, h in edges] + [m])
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
