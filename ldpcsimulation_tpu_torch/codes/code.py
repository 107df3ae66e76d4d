"""`Code`: the Tanner graph as padded slot arrays (torch tensors).

Same layout as ``ldpcsimulation_tpu.codes.code`` (which documents it in
full):

  * **VN-slot layout** — slot ``(v, s)`` is flat index ``v * dv_max + s``,
    in the alist's per-column file order.
  * **CN-slot layout** — slot ``(c, t)`` is flat index ``c * dc_max + t``,
    in per-row file order.
  * ``cn_from_vn[c, t]`` / ``vn_from_cn[v, s]`` are the static gather
    permutations between the two layouts.

Padding slots are masked (``*_mask``); their gather indices point at slot 0
and must be neutralized by the consumer.  Index arrays are int32 and masks
bool, on the device given to :func:`build_code`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .alist import Alist, from_dense

__all__ = ["Code", "build_code", "code_to_alist"]

_META_FIELDS = ("n", "m", "dv_max", "dc_max", "num_edges", "q")
_ARRAY_FIELDS = (
    "vn_cn", "vn_mask", "vn_deg", "cn_vn", "cn_mask", "cn_deg",
    "cn_from_vn", "vn_from_cn", "vn_coef", "cn_coef",
)


@dataclasses.dataclass(frozen=True, eq=False)
class Code:
    """Immutable Tanner graph in padded slot form."""

    n: int  # variables (columns)
    m: int  # checks (rows)
    dv_max: int
    dc_max: int
    num_edges: int
    q: int  # 0 or 2 => binary; >2 => GF(q)

    vn_cn: torch.Tensor  # [N, dv_max] int32: check index per VN slot (0 if pad)
    vn_mask: torch.Tensor  # [N, dv_max] bool
    vn_deg: torch.Tensor  # [N] int32
    cn_vn: torch.Tensor  # [M, dc_max] int32: variable index per CN slot
    cn_mask: torch.Tensor  # [M, dc_max] bool
    cn_deg: torch.Tensor  # [M] int32
    cn_from_vn: torch.Tensor  # [M, dc_max] int32: flat VN-slot feeding CN slot
    vn_from_cn: torch.Tensor  # [N, dv_max] int32: flat CN-slot feeding VN slot
    vn_coef: torch.Tensor  # [N, dv_max] GF coefficients (all-ones if binary)
    cn_coef: torch.Tensor  # [M, dc_max]

    @property
    def k(self) -> int:
        """Nominal information length (assumes full-rank H)."""
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    def true_k(self) -> int:
        """Rank-aware information length n − rank(H), by GF(2) elimination
        on first use, cached on the instance (a redundant H, such as the
        802.3an matrix of 384 rows and rank 325, has more than n − m)."""
        cached = self.__dict__.get("_true_k")
        if cached is None:
            from .encode import gf2_rref

            h = np.zeros((self.m, self.n), np.uint8)
            cn_vn = self.cn_vn.cpu().numpy().reshape(-1)
            keep = self.cn_mask.cpu().numpy().reshape(-1)
            rows = np.repeat(np.arange(self.m), self.dc_max)
            h[rows[keep], cn_vn[keep]] = 1
            _, pivots, _ = gf2_rref(h)
            cached = self.n - len(pivots)
            object.__setattr__(self, "_true_k", cached)
        return cached

    def true_rate(self) -> float:
        """Rank-aware code rate ``true_k() / n`` (see :meth:`true_k`)."""
        return self.true_k() / self.n

    @classmethod
    def from_arrays(cls, device="cpu", **fields) -> "Code":
        """Build from the JAX ``Code``'s fields given as numpy arrays (and
        ints for the metadata) — carries a code built by the JAX package
        across without importing it."""
        meta = {f: int(fields[f]) for f in _META_FIELDS}
        arrays = {
            f: torch.as_tensor(np.array(fields[f]), device=device)
            for f in _ARRAY_FIELDS
        }
        return cls(**meta, **arrays)

    def to(self, device) -> "Code":
        """The same code with its tables on ``device`` (self if they are
        there already)."""
        device = torch.device(device)
        if self.cn_vn.device == device:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _ARRAY_FIELDS
        })

    def __repr__(self) -> str:  # keep reprs short in logs
        base = (
            f"Code(n={self.n}, m={self.m}, dv_max={self.dv_max}, "
            f"dc_max={self.dc_max}, E={self.num_edges}"
        )
        if self.q > 2:
            base += f", q={self.q}"
        return base + ")"


def build_code(a: Alist, device="cpu") -> Code:
    """Build the padded slot representation from a parsed alist.

    Slot order within each node follows the alist file order exactly — the
    min-sum tie-break (last minimum wins the 2nd-min slot) is
    order-sensitive.
    """
    n, m = a.n, a.m
    dv_max, dc_max = a.dv_max, a.dc_max

    vn_cn = np.zeros((n, dv_max), dtype=np.int32)
    vn_mask = np.zeros((n, dv_max), dtype=bool)
    cn_vn = np.zeros((m, dc_max), dtype=np.int32)
    cn_mask = np.zeros((m, dc_max), dtype=bool)
    vn_coef = np.ones((n, dv_max), dtype=np.int32)
    cn_coef = np.ones((m, dc_max), dtype=np.int32)

    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            vn_cn[v, s] = c
            vn_mask[v, s] = True
            if a.nvals is not None:
                vn_coef[v, s] = a.nvals[v][s]
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            cn_vn[c, t] = v
            cn_mask[c, t] = True
            if a.mvals is not None:
                cn_coef[c, t] = a.mvals[c][t]

    # Reverse maps: for edge (v, c), which slot index does the other side
    # use?  Duplicate entries would silently overwrite, so guard.
    vn_slot_of = {}
    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            if (v, c) in vn_slot_of:
                raise ValueError(f"parallel edge ({v},{c}) in alist")
            vn_slot_of[(v, c)] = s
    cn_slot_of = {}
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            if (v, c) in cn_slot_of:
                raise ValueError(f"parallel edge ({v},{c}) in alist")
            cn_slot_of[(v, c)] = t

    cn_from_vn = np.zeros((m, dc_max), dtype=np.int32)
    for c, cols in enumerate(a.mlist):
        for t, v in enumerate(cols):
            cn_from_vn[c, t] = v * dv_max + vn_slot_of[(v, c)]
    vn_from_cn = np.zeros((n, dv_max), dtype=np.int32)
    for v, rows in enumerate(a.nlist):
        for s, c in enumerate(rows):
            vn_from_cn[v, s] = c * dc_max + cn_slot_of[(v, c)]

    return Code.from_arrays(
        device=device,
        n=n,
        m=m,
        dv_max=dv_max,
        dc_max=dc_max,
        num_edges=a.num_edges,
        q=a.q,
        vn_cn=vn_cn,
        vn_mask=vn_mask,
        vn_deg=np.array(a.dv, dtype=np.int32),
        cn_vn=cn_vn,
        cn_mask=cn_mask,
        cn_deg=np.array(a.dc, dtype=np.int32),
        cn_from_vn=cn_from_vn,
        vn_from_cn=vn_from_cn,
        vn_coef=vn_coef,
        cn_coef=cn_coef,
    )


def code_from_dense(h: np.ndarray, q: int = 0, device="cpu") -> Code:
    """A dense H (rows = checks) as a :class:`Code` on ``device``."""
    return build_code(from_dense(h, q=q), device)


def code_to_alist(code: Code) -> Alist:
    """Inverse of :func:`build_code` (for serialization)."""
    vn_cn = code.vn_cn.cpu().numpy()
    vn_mask = code.vn_mask.cpu().numpy()
    cn_vn = code.cn_vn.cpu().numpy()
    cn_mask = code.cn_mask.cpu().numpy()
    nlist: List[List[int]] = [
        [int(vn_cn[v, s]) for s in range(code.dv_max) if vn_mask[v, s]]
        for v in range(code.n)
    ]
    mlist: List[List[int]] = [
        [int(cn_vn[c, t]) for t in range(code.dc_max) if cn_mask[c, t]]
        for c in range(code.m)
    ]
    nvals = mvals = None
    if code.q > 2:
        vn_coef = code.vn_coef.cpu().numpy()
        cn_coef = code.cn_coef.cpu().numpy()
        nvals = [
            [int(vn_coef[v, s]) for s in range(code.dv_max) if vn_mask[v, s]]
            for v in range(code.n)
        ]
        mvals = [
            [int(cn_coef[c, t]) for t in range(code.dc_max) if cn_mask[c, t]]
            for c in range(code.m)
        ]
    return Alist(
        n=code.n, m=code.m, nlist=nlist, mlist=mlist,
        q=code.q if code.q > 2 else 0, nvals=nvals, mvals=mvals,
    )
