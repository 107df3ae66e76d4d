"""Flooding sum-product BP for quasi-cyclic codes.

Port of ``ldpcsimulation_tpu.decoders.bp_qc``: the arithmetic of :mod:`.bp`
(hyperbolic-pair check update with exact prefix/suffix exclusion, ±MAXLLR
clamp on the outgoing messages) on the flat ``[P * z, B]`` message planes of
:mod:`.minsum_qc`, the check update routed by ``QCPlan.cn_rows`` inside
kernel B8 (one row gather per slot in its plain twin), the VN side in
kernel B9 on ``QCPlan.vn_rows``.  ``cn_rows`` is in
the generic slot order (a pair's entries exchanged row by row), the order
the JAX decoder folds in: the f32 fold is not associative, so the order is
part of the result.  An absent slot is u = 0 with sign +1 — the fold's
neutral element, which leaves ``s + d·0 == s`` untouched.
"""

from __future__ import annotations

import torch

from .. import spans
from ..codes.qc import QCCode
from ..kernels.bp import bp_vn_update
from .base import DecodeResult, run_flooding_soft
from .bp import MAXLLR, _bp_check
from .minsum_qc import qc_check_satisfied, qc_plan, qc_ragged_init

__all__ = ["qc_cn_bp", "qc_bp_step", "decode_bp_qc"]


def qc_cn_bp(qc: QCCode, v2c: torch.Tensor) -> torch.Tensor:
    """Sum-product check update on the ``[P*z, B]`` planes (f16 or f32):
    c2v ``[P*z, B]`` f32 in the same rows, zeros in the rows of absent
    edges (:func:`.bp._bp_check` on ``QCPlan.cn_rows``)."""
    plan = qc_plan(qc, v2c.device)
    return _bp_check(v2c, plan.cn_rows, plan.absent_rows)


def qc_bp_step(qc: QCCode, max_llr: float = MAXLLR, storage_dtype=None):
    """The :func:`decode_bp_qc` iteration as a function of (messages,
    channel term): ``step(v2c, yb) -> (v2c', total)`` with ``v2c`` the
    ``[P*z, B]`` planes and ``yb``/``total`` the clamped ``[N, B]`` LLRs and
    the posterior (f32).  The VN side is kernel B9
    (:func:`..kernels.bp.bp_vn_update` on ``QCPlan.vn_rows``): total = y +
    ((c₀ + c₁) + c₂ …) in the generic slot order, then v2c' =
    storage_cast(clip(total − c_s, ±max_llr)) in a new plane; while a
    profiler runs, the span ``ldpc.decode.bp_vn``."""

    def step(v2c, yb):
        plan = qc_plan(qc, v2c.device)
        sdt = storage_dtype if storage_dtype is not None else yb.dtype
        c2v = qc_cn_bp(qc, v2c)
        yb = yb.contiguous()
        with spans.span(spans.BP_VN):
            return bp_vn_update(c2v, yb, plan.vn_rows, max_llr, sdt)

    return step


def decode_bp_qc(
    qc: QCCode,
    llr: torch.Tensor,
    num_iterations: int,
    max_llr: float = MAXLLR,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding sum-product on a QC code.  llr: [B, N] LLRs.

    storage_dtype: optional narrower type (e.g. torch.float16) of the v2c
    planes; the arithmetic stays float32 (see :func:`.bp.decode_bp`).
    """
    # input clamp, as decode_bp: |llr| ≳ 89 would underflow u to 0 and the
    # log(s/0) = inf would poison the frame with NaN
    llr_t = torch.clamp(llr.t(), -max_llr, max_llr).contiguous()  # [N, B]
    n, b = llr_t.shape
    if n != qc.n:
        raise ValueError(f"llr has {n} columns, the code {qc.n}")
    sdt = storage_dtype if storage_dtype is not None else llr_t.dtype
    v2c0 = qc_ragged_init(qc, llr_t, sdt)
    step_y = qc_bp_step(qc, max_llr, storage_dtype)
    d, iters, done = run_flooding_soft(
        llr_t, v2c0, lambda v2c: step_y(v2c, llr_t),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
