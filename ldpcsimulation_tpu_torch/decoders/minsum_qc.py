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
(r + shift_t) % z``.  The VN update (messages left-folded in slot order,
channel term added last), the saturating storage cast and the syndrome
check are plain torch.

Not here yet: codes with multi-edge blocks or absent edges (``extra_edges``,
``minus_edges``) raise ``NotImplementedError`` — they need
``codes/standards.py`` (ROADMAP S1, with A3's DVB-S2 case).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ..codes.qc import QCCode
from ..kernels.minsum import VARIANTS, minsum_cn_scan
from .base import DecodeResult, run_flooding_soft, storage_cast

__all__ = [
    "QCPlan",
    "qc_plan",
    "qc_check_satisfied",
    "qc_minsum_step",
    "qc_ragged_init",
    "decode_minsum_qc",
]


@dataclasses.dataclass(frozen=True, eq=False)
class QCPlan:
    """Static row tables of one QC code on one device.

    cn_rows:     [M, dc_max] int32 — message row of check (bi, r), slot t
                 (−1 for an absent slot); the kernel's routing table.
    check_cols:  [M, dc_max] int64 — column of that edge (N for an absent
                 slot, a sentinel row); the syndrome check's table.
    plane_block: [P] int64 — VN block of each plane.
    vn_slots:    per VN slot s, (blocks with a slot s, their s-th plane) as
                 int64 tensors — the VN fold's order.
    """

    z: int
    nb: int
    num_planes: int
    cn_rows: torch.Tensor
    check_cols: torch.Tensor
    plane_block: torch.Tensor
    vn_slots: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


@functools.lru_cache(maxsize=None)
def qc_plan(qc: QCCode, device) -> QCPlan:
    """Row tables of ``qc`` on ``device`` (built once, cached)."""
    if qc.extra_edges or qc.minus_edges:
        raise NotImplementedError(
            "QC codes with multi-edge blocks or absent edges need "
            "codes/standards.py, which is not ported yet (ROADMAP S1)"
        )
    if any(len(blocks) == 0 for blocks in qc.vn_blocks):
        raise ValueError("every VN block needs at least one circulant")
    z, nb = qc.z, qc.nb
    plane_of = {}
    plane_block = []
    for bj in range(nb):
        for s, (bi, shift) in enumerate(qc.vn_blocks[bj]):
            plane_of[(bj, bi, shift)] = len(plane_block)
            plane_block.append(bj)

    r = np.arange(z)
    cn_rows = np.full((qc.m, qc.dc_max), -1, np.int64)
    check_cols = np.full((qc.m, qc.dc_max), qc.n, np.int64)
    for bi in range(qc.mb):
        for t, (bj, shift) in enumerate(qc.cn_blocks[bi]):
            off = (r + shift) % z
            cn_rows[bi * z:(bi + 1) * z, t] = plane_of[(bj, bi, shift)] * z + off
            check_cols[bi * z:(bi + 1) * z, t] = bj * z + off

    vn_slots = []
    for s in range(qc.dv_max):
        blocks = [bj for bj in range(nb) if len(qc.vn_blocks[bj]) > s]
        planes = [plane_of[(bj,) + qc.vn_blocks[bj][s]] for bj in blocks]
        vn_slots.append(tuple(
            torch.tensor(v, dtype=torch.int64, device=device)
            for v in (blocks, planes)
        ))
    return QCPlan(
        z=z,
        nb=nb,
        num_planes=len(plane_block),
        cn_rows=torch.tensor(cn_rows, dtype=torch.int32, device=device),
        check_cols=torch.tensor(check_cols, dtype=torch.int64, device=device),
        plane_block=torch.tensor(plane_block, dtype=torch.int64,
                                 device=device),
        vn_slots=tuple(vn_slots),
    )


def qc_check_satisfied(qc: QCCode, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] (or [Nb, z, B]) ±1 decisions -> [B] all checks satisfied."""
    d = d.reshape(qc.n, -1)
    plan = qc_plan(qc, d.device)
    neg = torch.cat([d < 0, d.new_zeros((1, d.shape[1]), dtype=torch.bool)])
    cols = plan.check_cols
    odd = neg[cols[:, 0]]
    for t in range(1, cols.shape[1]):
        odd = odd ^ neg[cols[:, t]]
    return ~odd.any(dim=0)


def qc_minsum_step(qc: QCCode, variant: str = "plain", alpha: float = 1.0,
                   delta: float = 0.0, storage_dtype=None):
    """One flooding iteration as a function of (messages, channel term):
    ``step(v2c, yb) -> (v2c', total)`` with ``v2c`` the ``[P*z, B]`` planes
    and ``yb``/``total`` the ``[N, B]`` channel samples and posterior.

    The same operations as the JAX ``qc_minsum_step``: c2v from the CN
    update (f32), total = y + ((c₀ + c₁) + c₂ …) in VN slot order, then
    v2c' = storage_cast(total − c_s).
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")

    def step(v2c, yb):
        plan = qc_plan(qc, v2c.device)
        sdt = storage_dtype if storage_dtype is not None else yb.dtype
        b = v2c.shape[1]
        c2v = minsum_cn_scan(v2c, plan.cn_rows, variant, alpha, delta)
        planes = c2v.view(plan.num_planes, plan.z, b)
        _, idx = plan.vn_slots[0]  # every block has a slot 0
        acc = planes[idx]
        for blocks, idx in plan.vn_slots[1:]:
            if len(blocks) == plan.nb:
                acc = acc + planes[idx]
            else:
                acc[blocks] = acc[blocks] + planes[idx]
        total = yb.reshape(plan.nb, plan.z, b) + acc
        v2c_new = storage_cast(total[plan.plane_block] - planes, sdt)
        return v2c_new.view(-1, b), total.view(-1, b)

    return step


def qc_ragged_init(qc: QCCode, yb: torch.Tensor, sdt) -> torch.Tensor:
    """Initial v2c planes ``[P*z, B]``: every slot starts at its column's
    channel sample."""
    b = yb.shape[-1]
    plan = qc_plan(qc, yb.device)
    planes = yb.reshape(plan.nb, plan.z, b)[plan.plane_block]
    return planes.to(sdt).view(-1, b)


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
    v2c0 = qc_ragged_init(qc, y_t, sdt)
    step_y = qc_minsum_step(qc, variant, alpha, delta, storage_dtype)
    d, iters, done = run_flooding_soft(
        y_t, v2c0, lambda v2c: step_y(v2c, y_t),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
