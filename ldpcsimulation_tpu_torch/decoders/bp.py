"""Flooding sum-product belief propagation (LLR domain) on the slot-array
Tanner graph of any binary code.

Port of ``ldpcsimulation_tpu.decoders.bp`` (behavioral reference:
``decodeBP.cpp``): exact extrinsic exclusion in the check update, the total
sum with outgoing messages clamped to ±MAXLLR in the variable update, inputs
clamped to ±MAXLLR.  The reference runs all T iterations;
``early_termination=True`` is the framework's extension.

The tanh product is evaluated in the **hyperbolic-pair domain**, operation
for operation as the JAX package does.  With ``u_j = exp(-|m_j|)`` each edge
contributes ``tanh(|m_j|/2) = (1-u_j)/(1+u_j)``; the pair
``(s, d) = (Π(1+u_j) + Π(1-u_j), Π(1+u_j) − Π(1-u_j)) / 2`` combines as
``(s,d)·(s',d') = (ss'+dd', sd'+ds')`` with every term positive, and the
product magnitude is ``|out| = log(s/d)``: one ``exp`` per input edge and
one ``log`` per output edge.  With messages clamped to ±MAXLLR,
``u ∈ [e^-20, 1]`` and every pair term stays normal in float32; a zero input
message (u = 1) forces the other outputs of its check to exactly 0.

The folds are written as separate multiplies and adds (``s + d * u``), which
eager PyTorch never contracts into a fused multiply-add on either device, so
the argument of every ``log`` equals the JAX function's bit for bit when
that runs op by op.  Compiled by XLA for the CPU, the JAX fold is contracted
into fused multiply-adds and differs by ulps; the ``exp`` and ``log``
themselves differ from XLA's by ulps too, so the whole decoder agrees with
the JAX one by tolerance, not by bits.

Every BP decoder's check update is :func:`_bp_check`: kernel B8 on the
decoder's routing table, here B1's ``MinSumPlan.cn_rows``, so c2v lands in
VN-slot layout and the variable update needs no gather.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import spans
from ..codes.code import Code
from ..kernels.bp import (  # noqa: F401  (the fold's names, re-exported)
    bp_cn_pair,
    excl_sign_products,
    pair_excl_logmags,
    pair_excl_sums,
)
from .base import DecodeResult, run_flooding_soft, storage_cast, xor_satisfied
from .minsum import minsum_plan, vn_update

__all__ = ["MAXLLR", "pair_excl_logmags", "excl_sign_products",
           "bp_cn_update", "bp_step", "decode_bp"]

MAXLLR = 20.0  # decodeBP.cpp:58


def _bp_check(v2c: torch.Tensor, cn_rows: torch.Tensor,
              unwritten: Optional[torch.Tensor]) -> torch.Tensor:
    """The sum-product check update of every BP decoder: c2v ``[R, B]`` f32
    in the rows of ``v2c [R, B]`` (f16 or f32) that ``cn_rows`` names
    (:func:`..kernels.bp.bp_cn_pair`: kernel B8 on CUDA tensors, which
    refuses a table wider than 64 slots, its plain twin on CPU tensors),
    exact zeros in the int64 rows ``unwritten`` that no check names.
    While a profiler runs, the update is the span ``ldpc.decode.bp_check``.
    """
    with spans.span(spans.BP_CHECK):
        c2v = bp_cn_pair(v2c, cn_rows)
        if unwritten is not None:
            c2v.index_fill_(0, unwritten, 0.0)
        return c2v


def bp_cn_update(code: Code, v2c_flat: torch.Tensor) -> torch.Tensor:
    """Sum-product check update with exact extrinsic exclusion (kernel B8
    on ``MinSumPlan.cn_rows``).

    v2c_flat: [N*dv_max, B] variable→check messages (VN-slot layout, f16 or
    f32).  Returns c2v [N*dv_max, B] f32 in VN-slot layout — unlike the JAX
    function, whose output is in CN-slot layout — with exact zeros in the
    padding slots.  While a profiler runs, the update is the span
    ``ldpc.decode.bp_check``.
    """
    plan = minsum_plan(code, v2c_flat.device)
    return _bp_check(v2c_flat.contiguous(), plan.cn_rows, plan.vn_pad)


def bp_step(code: Code, max_llr: float = MAXLLR, storage_dtype=None):
    """The :func:`decode_bp` iteration as a function of (messages, channel
    term): ``step(v2c, llr_t) -> (v2c', total)`` with ``llr_t`` the clamped
    ``[N, B]`` LLRs.  The code's tables are taken to the messages' device
    (once, cached)."""

    def step(v2c, llr_t):
        plan = minsum_plan(code, v2c.device)
        sdt = storage_dtype if storage_dtype is not None else llr_t.dtype
        c2v = _bp_check(v2c.contiguous(), plan.cn_rows, plan.vn_pad)
        v2c, total, _ = vn_update(plan.code, llr_t, c2v, clamp=max_llr)
        return storage_cast(v2c, sdt), total

    return step


def decode_bp(
    code: Code,
    llr: torch.Tensor,
    num_iterations: int,
    max_llr: float = MAXLLR,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding sum-product decode.  llr: [B, N] channel LLRs.

    storage_dtype: optional narrower type (e.g. torch.float16) of the v2c
    messages; the arithmetic stays float32, so the only loss is the rounding
    of the stored extrinsics (messages are clamped to ±MAXLLR).  The code's
    tables are taken to llr's device (once, cached).
    """
    # Input clamp (decodeBP.cpp:188-191): without it |llr| ≳ 89 underflows
    # u = e^-|m| to exactly 0 in f32, a later log(s/0) = inf appears in the
    # exclusion, and total − self gives inf − inf = NaN.
    llr_t = torch.clamp(llr.t(), -max_llr, max_llr).contiguous()  # [N, B]
    n, b = llr_t.shape
    if n != code.n:
        raise ValueError(f"llr has {n} columns, the code {code.n}")
    plan = minsum_plan(code, llr_t.device)
    sdt = storage_dtype if storage_dtype is not None else llr_t.dtype
    v2c0 = llr_t.repeat_interleave(code.dv_max, dim=0).to(sdt)
    step_y = bp_step(code, max_llr, storage_dtype)
    d, iters, done = run_flooding_soft(
        llr_t, v2c0, lambda v2c: step_y(v2c, llr_t),
        lambda d: xor_satisfied(plan.check_cols, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
