"""DD-BMP: differential decoding with binary message passing, on slot
arrays, QC row tables and stratified slot grids.

Port of ``ldpcsimulation_tpu.decoders.ddbmp`` (behavioral reference:
``decodeDDBMP.cpp``), bit for bit:
  * The channel samples are quantized with the no-zero-level quantizer by
    the caller.
  * Init: every VN slot's accumulator memory starts at the channel sample;
    the outgoing binary message is its sign (sgn(0) = +1).
  * Check update: the row's sign product times the slot's own sign (signs
    are ±1, so exclusion is multiplication by self).
  * Variable update: ``memory[v][s] += (total − c2v[s])`` with
    ``total = y[v] + Σ c2v`` folded LEFT FROM y, and the grouping
    ``mem + (total − msg)``: both are pinned, since the other groupings
    differ at the ulp on quantized samples that f32 does not represent, and
    the memories accumulate the difference until a message sign flips.
    Decision: majority of ``sign(y[v]) + Σ outgoing``, ties to −1; padding
    and absent slots vote 0.
  * Stopping: the syndrome is checked AFTER each update round, so at least
    one round runs; ``iterations`` is the 0-based index of the round that
    satisfied it, or T if none did.

The decoders carry only the memories (``outgoing = sgn(memory)``).  Only the
latched decision is masked for finished frames; their memories keep
evolving, which nothing reads.
"""

from __future__ import annotations

import torch

from ..codes.code import Code
from ..codes.qc import QCCode
from ..codes.stratified import StratifiedCode
from .base import (
    DecodeResult,
    gather_cn,
    gather_vn,
    sgn_pos,
    xor_satisfied,
)
from .minsum import minsum_plan
from .minsum_qc import qc_fold, qc_plan
from .minsum_stratified import (
    stratified_check_satisfied,
    stratified_grid,
    stratified_hard,
    stratified_init,
    stratified_plan,
    stratified_to_cn,
    stratified_to_vn,
    stratified_zero_pad,
)

__all__ = ["ddbmp_round", "decode_ddbmp", "qc_ddbmp_round",
           "decode_ddbmp_qc", "decode_ddbmp_stratified"]


def _run_rounds(one_round, mem, d, satisfied_of, num_iterations, batch):
    """The DD-BMP loop: rounds until every frame's syndrome checks out or
    T.  Returns (d, iterations [B] int32, done [B] bool)."""
    device = d.device
    iters = torch.full((batch,), num_iterations, dtype=torch.int32,
                       device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    t = 0
    while t < num_iterations and not bool(done.all()):
        mem, d_new = one_round(mem)
        act = ~done
        d = torch.where(act, d_new, d)
        sat = satisfied_of(d)
        iters = torch.where(act & sat, t, iters)  # break index, it = t
        done = done | sat
        t += 1
    return d, iters, done


def ddbmp_round(code: Code, mem: torch.Tensor, y_t: torch.Tensor,
                fresh=None):
    """One DD-BMP update round on the slot-array graph -> (mem', d).

    mem: ``[N*dv_max, B]`` accumulator memories in VN-slot layout; y_t:
    ``[N, B]`` channel samples; d: ``[N, B]`` int32 ±1 decisions.  The
    code's tables are taken to the device (once, cached).  ``fresh``:
    optional [B] bool — lanes whose memories read as freshly initialized
    (every slot at its channel sample), as in :func:`qc_ddbmp_round`.
    """
    code = minsum_plan(code, y_t.device).code
    n, b = y_t.shape
    dv, dc = code.dv_max, code.dc_max
    vn_mask = code.vn_mask[:, :, None]
    if fresh is not None:
        mem = torch.where(fresh, y_t.repeat_interleave(dv, dim=0), mem)
    g = gather_cn(code, sgn_pos(mem))  # [M, dc_max, B] ±1
    g = torch.where(code.cn_mask[:, :, None], g, torch.ones_like(g))
    prod = g[:, 0]
    for t in range(1, dc):
        prod = prod * g[:, t]
    c2v = (prod[:, None, :] * g).reshape(code.m * dc, b)
    gv = gather_vn(code, c2v)  # [N, dv_max, B]
    gv = torch.where(vn_mask, gv, torch.zeros_like(gv))
    total = y_t  # left fold FROM y (decodeDDBMP.cpp:399-407)
    for s in range(dv):
        total = total + gv[:, s]
    # mem + (sum − msg), NOT (mem + sum) − msg (decodeDDBMP.cpp:413)
    mem_new = mem.view(n, dv, b) + (total[:, None, :] - gv)
    out_signs = torch.where(vn_mask, sgn_pos(mem_new),
                            torch.zeros_like(mem_new))
    dsum = sgn_pos(y_t) + out_signs.sum(dim=1)
    d = torch.where(dsum > 0, 1, -1).to(torch.int32)
    return mem_new.reshape(n * dv, b), d


def decode_ddbmp(code: Code, yq: torch.Tensor,
                 num_iterations: int) -> DecodeResult:
    """Batched DD-BMP decode on the slot-array graph.  yq: [B, N]
    (quantized) channel samples.  The code's tables are taken to yq's
    device (once, cached)."""
    y_t = yq.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != code.n:
        raise ValueError(f"yq has {n} columns, the code {code.n}")
    plan = minsum_plan(code, y_t.device)
    d, iters, done = _run_rounds(
        lambda mem: ddbmp_round(code, mem, y_t),
        y_t.repeat_interleave(code.dv_max, dim=0),
        torch.where(y_t > 0, 1, -1).to(torch.int32),
        lambda d: xor_satisfied(plan.check_cols, d),
        num_iterations, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)


def qc_ddbmp_round(qc: QCCode, mem: torch.Tensor, yb: torch.Tensor,
                   fresh=None):
    """One DD-BMP update round on a QC code -> (mem', d).

    mem: ``[P*z, B]`` accumulator memories in the message-plane layout of
    :mod:`.minsum_qc`; yb: ``[N, B]`` channel samples; d: ``[N, B]`` int8
    decisions (±1, so the narrow type is exact).  An absent edge counts +1
    in the row product and 0 in the sum and in the vote.

    ``fresh``: optional [B] bool — lanes whose memories read as freshly
    initialized (every slot at the channel sample), for a caller that
    refills lanes between rounds; the same values as merging the fresh
    lanes into ``mem`` first.
    """
    plan = qc_plan(qc, mem.device)
    if fresh is not None:
        mem = torch.where(fresh, yb[plan.row_col], mem)
    s2c = sgn_pos(mem)
    # CN: the row's sign product (values ±1, so the order is free), then
    # exclusion by self-multiplication at each message row
    prod = None
    for rows, gone, _ in plan.slots:
        v = s2c[rows]
        if gone is not None:
            v = torch.where(gone, 1.0, v)
        prod = v if prod is None else prod * v
    c2v = prod[plan.row_check] * s2c
    if plan.absent_rows is not None:
        c2v.index_fill_(0, plan.absent_rows, 0.0)
    # left fold FROM y in the physical slot order (decodeDDBMP.cpp:399-407)
    total = qc_fold(plan.fold_phys, c2v, yb)
    mem_new = mem + (total[plan.row_col] - c2v)
    votes = sgn_pos(mem_new)
    if plan.absent_rows is not None:
        votes.index_fill_(0, plan.absent_rows, 0.0)
    dsum = qc_fold(plan.fold_phys, votes, sgn_pos(yb))
    d = torch.where(dsum > 0, 1, -1).to(torch.int8)
    return mem_new, d


def decode_ddbmp_qc(qc: QCCode, yq: torch.Tensor,
                    num_iterations: int) -> DecodeResult:
    """DD-BMP on a QC code through its row tables (the semantics of
    :func:`decode_ddbmp`).  yq: [B, N] (quantized) channel samples."""
    y_t = yq.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != qc.n:
        raise ValueError(f"yq has {n} columns, the code {qc.n}")
    plan = qc_plan(qc, y_t.device)
    d, iters, done = _run_rounds(
        lambda mem: qc_ddbmp_round(qc, mem, y_t),
        y_t[plan.row_col],
        torch.where(y_t > 0, 1, -1).to(torch.int8),
        lambda d: xor_satisfied(plan.check_cols, d),
        num_iterations, b,
    )
    return DecodeResult(hard=d.t().to(torch.int32), iterations=iters,
                        satisfied=done)


def decode_ddbmp_stratified(sc: StratifiedCode, yq: torch.Tensor,
                            num_iterations: int) -> DecodeResult:
    """DD-BMP on a stratified code (:mod:`..codes.stratified`), with the
    semantics of :func:`decode_ddbmp`; the messages move between the VN and
    CN slot grids by row gathers.  Equal to the slot-array decoder for any
    slot order, by the QC form's argument: messages are ±1 and the sums add
    small exact f32 values, so there is no rounding order to keep.
    yq: [B, N] (quantized) channel samples."""
    y_t = yq.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != sc.n:
        raise ValueError(f"yq has {n} columns, the code {sc.n}")
    cn_pad = ~stratified_plan(sc, y_t.device).sc.cn_valid[..., None]
    yg = stratified_grid(sc, y_t)
    sign_y = sgn_pos(yg)

    def one_round(mem):
        g = stratified_to_cn(sc, sgn_pos(mem))  # [mb, h, kg, B]
        g = torch.where(cn_pad, 1.0, g)
        # the row's sign product (±1, order-free), exclusion by self
        prod = torch.prod(g, dim=2, keepdim=True)
        c2v = stratified_to_vn(sc, torch.where(cn_pad, 0.0, prod * g))
        total = yg  # left fold FROM y (decodeDDBMP.cpp:399-407)
        for s in range(sc.mb):
            total = total + c2v[s]
        # mem + (sum − msg), NOT (mem + sum) − msg (decodeDDBMP.cpp:413)
        mem_new = stratified_zero_pad(sc, mem + (total[None] - c2v))
        dsum = sign_y + stratified_zero_pad(sc, sgn_pos(mem_new)).sum(dim=0)
        return mem_new, torch.where(dsum > 0, 1, -1).to(torch.int32)

    d, iters, done = _run_rounds(
        one_round,
        stratified_init(sc, yg, y_t.dtype),
        torch.where(yg > 0, 1, -1).to(torch.int32),
        lambda d: stratified_check_satisfied(sc, d),
        num_iterations, b,
    )
    return DecodeResult(hard=stratified_hard(sc, d).t(), iterations=iters,
                        satisfied=done)
