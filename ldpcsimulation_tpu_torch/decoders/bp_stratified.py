"""Flooding sum-product BP on the stratified slot grids of a code without
QC structure (:mod:`..codes.stratified`).

Port of ``ldpcsimulation_tpu.decoders.bp_stratified``: the hyperbolic-pair
check update of :mod:`.bp` with exact extrinsic exclusion, the ±MAXLLR
clamp on the stored messages and on the input (``decodeBP.cpp:353-409``).
The check update is :func:`.bp._bp_check` on ``StratifiedPlan.cn_rows``:
it reads and writes the VN-slot rows, where the JAX package moves the
messages between the slot grids by one-hot einsums on the TPU's MXU.

The pair fold runs over the ``kg`` column groups in group order, not in the
row's alist order, as the JAX decoder's does: the same arithmetic
reassociated, so decisions agree with the slot-array decoder except on
ulp-level posterior near-ties.  Against the JAX decoder the port agrees by
tolerance (XLA contracts the pair fold into fused multiply-adds), as its
other BP decoders do.
"""

from __future__ import annotations

import torch

from ..codes.stratified import StratifiedCode
from .base import DecodeResult, run_flooding_soft, storage_cast
from .bp import MAXLLR, _bp_check
from .minsum_stratified import (
    stratified_check_satisfied,
    stratified_grid,
    stratified_hard,
    stratified_init,
    stratified_plan,
    stratified_zero_pad,
)

__all__ = ["decode_bp_stratified", "stratified_bp_step"]


def stratified_bp_step(sc: StratifiedCode, max_llr: float = MAXLLR,
                       storage_dtype=None):
    """The :func:`decode_bp_stratified` iteration as a function of
    (messages, channel grid): ``step(v2c, yg) -> (v2c', total)``; the total
    and the c2v messages are f32, the stored messages clamped to
    ±max_llr."""

    def step(v2c, yg):
        p = stratified_plan(sc, v2c.device)
        b = v2c.shape[-1]
        sdt = storage_dtype if storage_dtype is not None else yg.dtype
        c2v = _bp_check(v2c.reshape(-1, b).contiguous(), p.cn_rows,
                        p.vn_absent).view(sc.mb, sc.kg, sc.w, b)
        # messages (strata) left-fold first, channel term last
        acc = c2v[0]
        for s in range(1, sc.mb):
            acc = acc + c2v[s]
        total = yg.to(c2v.dtype) + acc
        v2c_new = storage_cast(
            torch.clamp(total[None] - c2v, -max_llr, max_llr), sdt)
        return stratified_zero_pad(sc, v2c_new), total

    return step


def decode_bp_stratified(
    sc: StratifiedCode,
    llr: torch.Tensor,
    num_iterations: int,
    max_llr: float = MAXLLR,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding sum-product on a stratified code.  llr: [B, N].

    Same flags as :func:`.bp.decode_bp` (input clamp, optional f16 message
    storage with f32 arithmetic).  The structure's tables are taken to
    llr's device (once, cached).  On the card, B8 takes ``kg`` ≤ 64 column
    groups and raises beyond.
    """
    llr_t = torch.clamp(llr.t(), -max_llr, max_llr).contiguous()  # [N, B]
    n, b = llr_t.shape
    if n != sc.n:
        raise ValueError(f"llr has {n} columns, the code {sc.n}")
    sdt = storage_dtype if storage_dtype is not None else llr_t.dtype
    yg = stratified_grid(sc, llr_t)
    v2c0 = stratified_init(sc, yg, sdt)
    step_y = stratified_bp_step(sc, max_llr, storage_dtype)
    d, iters, done = run_flooding_soft(
        yg, v2c0, lambda v2c: step_y(v2c, yg),
        lambda d: stratified_check_satisfied(sc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=stratified_hard(sc, d).t(), iterations=iters,
                        satisfied=done)
