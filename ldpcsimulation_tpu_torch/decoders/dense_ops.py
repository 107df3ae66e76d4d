"""Dense-matrix graph operations of the bit-flip family.

Port of ``ldpcsimulation_tpu.decoders.dense_ops``.  The GDBF/NGDBF decoders
touch the Tanner graph in two places, the syndrome per check and the
per-variable sum of neighbouring syndromes, and both are linear in the
incidence matrix H:

  * syndrome parity = (H @ bits) mod 2            (bits ∈ {0, 1})
  * neighbour sums  = Hᵀ @ syn                    (syn per check)

A code with no QC structure otherwise takes one row gather per slot
(:func:`.qc_ops.slot_graph`); here each operation is one matrix product
(``torch.matmul``: cuBLAS on the card).  The sweep takes this route for the
bit-flip decoders on such codes where :func:`dense_worthwhile` holds, as the
JAX CLI does.

Exactness.  The operands are 0/1 and ±1, so every partial sum of a product
is an integer of magnitude at most ``dc_max`` (H @ x) or ``dv_max`` (Hᵀ @ s).
On the card the operands are f16, which holds every integer up to 2048
exactly: the product is exact whether cuBLAS accumulates in f32 or, as
PyTorch's default ``allow_fp16_reduced_precision_reduction`` lets it, in
f16, and the f16 result holds the count.  (bf16 holds integers only up to
256.)  On the CPU the product runs in f32 (exact up to 2²⁴).  A graph whose
degrees pass its dtype's bound is refused when it is made.  Each operation
returns what the port's slot-gather route returns, in value and in dtype:
:func:`.qc_ops.syndrome_bipolar` and :func:`.qc_ops.syndrome_sum_per_vn`
(the input's dtype) and :func:`.ngdbf_hw.hw_graph_ops` (uint8 parity, int16
counts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..codes.code import Code

__all__ = [
    "DENSE_MAX_ENTRIES",
    "DenseGraph",
    "dense_worthwhile",
    "graphs_by_device",
    "dense_syndrome_bipolar",
    "dense_syndrome_sum_per_vn",
    "dense_syndrome01",
    "dense_sat_sum_per_vn",
]

#: m·n above this many entries, the dense route is not taken (the JAX
#: package's threshold: the matrix's traffic and the product's operations
#: grow with m·n, the gathers' with the edges).  64 M entries = 128 MB f16.
DENSE_MAX_ENTRIES = 64 * 1024 * 1024

#: the largest integer each product dtype holds exactly
_EXACT = {torch.float16: 2048, torch.float32: 1 << 24}


def _product_dtype(device: torch.device) -> torch.dtype:
    """f16 tensor-core operands on the card, f32 on the CPU."""
    return torch.float16 if device.type == "cuda" else torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class DenseGraph:
    """The dense incidence matrix of a :class:`Code` (the same H) on one
    device.

    h:      [M, N] 0/1 in the product dtype of its device (f16 on the card,
            f32 on the CPU).
    vn_deg: [N] int16 variable degrees (the satisfied-count complement).
    """

    m: int
    n: int
    dc_max: int
    dv_max: int
    h: torch.Tensor
    vn_deg: torch.Tensor

    def __post_init__(self):
        bound = _EXACT[self.h.dtype]
        if max(self.dc_max, self.dv_max) > bound:
            raise ValueError(
                f"dense graph: degrees up to {max(self.dc_max, self.dv_max)}"
                f" pass {self.h.dtype}'s exact integers ({bound}); take the "
                "gather route (qc_ops.slot_graph) for this code"
            )

    @classmethod
    def from_code(cls, code: Code, device=None) -> "DenseGraph":
        """H of ``code`` on ``device`` (default: the card)."""
        device = torch.device("cuda" if device is None else device)
        cn_vn = code.cn_vn.cpu().numpy()
        keep = code.cn_mask.cpu().numpy().reshape(-1)
        h = np.zeros((code.m, code.n), np.float32)
        rows = np.repeat(np.arange(code.m), code.dc_max)
        h[rows[keep], cn_vn.reshape(-1)[keep]] = 1.0
        return cls(
            m=code.m, n=code.n, dc_max=code.dc_max, dv_max=code.dv_max,
            h=torch.from_numpy(h).to(device, _product_dtype(device)),
            vn_deg=code.vn_deg.to(device, torch.int16),
        )


def graphs_by_device(dg: Optional[DenseGraph], code: Code):
    """``device -> DenseGraph`` of ``code`` for the slots of a mesh: ``dg``
    on its own device, a graph built from ``code`` once on any other; None
    throughout when ``dg`` is None.  The four operations take the graph on
    their operand's device."""
    graphs = {} if dg is None else {dg.h.device: dg}

    def on(device) -> Optional[DenseGraph]:
        if dg is None:
            return None
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in graphs:
            graphs[device] = DenseGraph.from_code(code, device)
        return graphs[device]

    return on


def dense_worthwhile(code: Code) -> bool:
    """Whether the sweep takes the dense route for this code (m·n within
    :data:`DENSE_MAX_ENTRIES`)."""
    return code.m * code.n <= DENSE_MAX_ENTRIES


def _parity(cnt: torch.Tensor) -> torch.Tensor:
    """The low bit of integer-valued counts (≤ 2048: int16 holds them)."""
    return cnt.to(torch.int16) & 1


def dense_syndrome_bipolar(dg: DenseGraph, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] ±1 -> bipolar syndrome [M, B] (+1 satisfied), d's dtype:
    the parity of each check's count of negative decisions."""
    cnt = dg.h @ (d < 0).to(dg.h.dtype)
    return (1 - 2 * _parity(cnt)).to(d.dtype)


def dense_syndrome_sum_per_vn(dg: DenseGraph,
                              syn: torch.Tensor) -> torch.Tensor:
    """syn: [M, B] small integers (±1 bipolar) -> per-variable neighbour
    sums [N, B], syn's dtype."""
    return (dg.h.t() @ syn.to(dg.h.dtype)).to(syn.dtype)


def dense_syndrome01(dg: DenseGraph, d01: torch.Tensor) -> torch.Tensor:
    """d01: [N, B] {0, 1} -> [M, B] uint8 {0, 1}, 0 = satisfied."""
    return _parity(dg.h @ d01.to(dg.h.dtype)).to(torch.uint8)


def dense_sat_sum_per_vn(dg: DenseGraph, syn01: torch.Tensor) -> torch.Tensor:
    """syn01: [M, B] {0, 1} -> [N, B] int16, the count of satisfied
    neighbour checks of each variable (NGDBFhw's ``Σ_j (1 − s_j)``)."""
    unsat = dg.h.t() @ syn01.to(dg.h.dtype)
    return dg.vn_deg[:, None] - unsat.to(torch.int16)
