"""Row-layered sum-product BP for QC codes.

Port of ``ldpcsimulation_tpu.decoders.bp_layered``: the layered schedule of
:mod:`.minsum_layered` with the hyperbolic-pair check update of :mod:`.bp`
(exact prefix/suffix exclusion), which completes {flooding, layered} ×
{min-sum, BP}.

Clamping: the ±MAXLLR clamp applies only to the CHECK-NODE INPUT copy of the
extrinsic (the analogue of flooding BP's outgoing-message clamp); the
posterior is rebuilt from the UNclamped extrinsic.  Clamping the rebuilt
posterior bleeds belief on every layer visit and was measured by the JAX
package to collapse about 1 % of frames at 2.5 dB.

The check update is :func:`.bp._bp_check` once per layer on
``LayerPlan.scan_rows``, whose slots walk the layer's circulants in their
physical order (the JAX decoder's; the f32 fold is not associative, so the
order is part of the result).  An absent edge is a −1 slot, read as +inf
after the clip (``u = e^-inf`` is exactly 0, the sign +1: the fold's
neutral element); it stores a zero and leaves its column's posterior
untouched.  The state stays in the input type: there is no storage type.
"""

from __future__ import annotations

import torch

from ..codes.qc import QCCode
from .base import DecodeResult, run_flooding
from .bp import MAXLLR, _bp_check
from .minsum_layered import layered_l0, layered_scatter
from .minsum_qc import (
    assert_layered_compatible,
    qc_check_satisfied,
    qc_plan,
)

__all__ = ["qc_bp_layered_step", "decode_bp_layered_qc"]


def qc_bp_layered_step(qc: QCCode, max_llr: float = MAXLLR):
    """The :func:`decode_bp_layered_qc` iteration as a function of the
    layered state: ``step((q, L)) -> ((q', L'), total)`` with ``q`` the
    ``[N, B]`` posterior, ``L`` the per-layer ``[dc_bi * z, B]`` stored check
    messages and ``total`` the new posterior.  One call is one pass over all
    Mb layers; the state given is left unchanged."""
    assert_layered_compatible(qc)

    def step(qL):
        q, L = qL
        plan = qc_plan(qc, q.device)
        q = q.clone()
        L_new = []
        for lp, l_old in zip(plan.layers, L):
            qv = q[lp.cols]
            qext = qv - l_old
            qin = torch.clamp(qext, -max_llr, max_llr)
            out = _bp_check(qin, lp.scan_rows, lp.absent).to(q.dtype)
            layered_scatter(q, lp, qv, qext, out)
            L_new.append(out)
        return (q, tuple(L_new)), q

    return step


def decode_bp_layered_qc(
    qc: QCCode,
    llr: torch.Tensor,
    num_iterations: int,
    max_llr: float = MAXLLR,
    early_termination: bool = False,
) -> DecodeResult:
    """Batched row-layered sum-product on a QC code.  llr: [B, N] LLRs.

    Generalized QC structures follow :mod:`.minsum_layered`'s rules: an
    absent edge contributes the fold's neutral element and leaves its column
    untouched; a two-circulant pair accumulates ``(a1 − q) + a2``.
    """
    llr_t = llr.t().contiguous()  # [N, B]
    n, b = llr_t.shape
    if n != qc.n:
        raise ValueError(f"llr has {n} columns, the code {qc.n}")
    step = qc_bp_layered_step(qc, max_llr)
    d, iters, done = run_flooding(
        (llr_t, layered_l0(qc, b, llr_t.dtype, llr_t.device)),
        lambda st: step(st)[0],
        lambda st: torch.where(st[0] > 0, 1, -1).to(torch.int32),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
