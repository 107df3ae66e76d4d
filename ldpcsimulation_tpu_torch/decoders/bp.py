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
"""

from __future__ import annotations

import torch

from .. import spans
from ..codes.code import Code
from .base import (
    DecodeResult,
    gather_cn,
    gather_vn,
    run_flooding_soft,
    sgn_pos,
    storage_cast,
    xor_satisfied,
)
from .minsum import minsum_plan, vn_update

__all__ = ["MAXLLR", "pair_excl_logmags", "excl_sign_products",
           "bp_cn_update", "bp_step", "decode_bp"]

MAXLLR = 20.0  # decodeBP.cpp:58


def pair_excl_sums(us):
    """Per output t the (numerator, denominator) of the exclusive product's
    ``(1+P_t)/(1-P_t)``: multiplies and adds only, in a fixed order.  The
    (s, d) pairs fold from the neutral (1, 0): ``pre[t]`` over u_0..u_{t-1}
    left to right, ``suf[t]`` over u_{k-1}..u_{t+1} right to left."""
    k = len(us)
    one = torch.ones_like(us[0])
    zero = torch.zeros_like(us[0])
    pre = [(one, zero)]
    for t in range(k - 1):
        s, d = pre[-1]
        u = us[t]
        pre.append((s + d * u, d + s * u))
    suf = [(one, zero)]
    for t in range(k - 1, 0, -1):
        s, d = suf[-1]
        u = us[t]
        suf.append((s + d * u, d + s * u))
    suf.reverse()
    return [
        (sp * ss + dp * ds, sp * ds + dp * ss)
        for (sp, dp), (ss, ds) in zip(pre, suf)
    ]


def pair_excl_logmags(us):
    """Exclusive tanh-product magnitudes from ``u = e^-|m|``.

    us: list of per-edge u tensors of one shape.  Returns the list of
    ``|out|_t = log((1+P_t)/(1-P_t))`` with ``P_t = Π_{k≠t} tanh(|m_k|/2)``.
    The neutral element is (1, 0): an absent edge must present u = 0 (a
    message of +inf), which leaves the fold untouched bit for bit
    (``s + d·0 == s``).
    """
    return [torch.log(num / den) for num, den in pair_excl_sums(us)]


def excl_sign_products(signs):
    """Per output t the product of the other slots' ±1 signs (exclusive
    prefix times exclusive suffix)."""
    k = len(signs)
    ones = torch.ones_like(signs[0])
    pre = [ones]
    for t in range(k - 1):
        pre.append(pre[-1] * signs[t])
    suf = [ones]
    for t in range(k - 1, 0, -1):
        suf.append(suf[-1] * signs[t])
    suf.reverse()
    return [p * s for p, s in zip(pre, suf)]


def bp_cn_update(code: Code, v2c_flat: torch.Tensor) -> torch.Tensor:
    """Sum-product check update with exact extrinsic exclusion.

    v2c_flat: [N*dv_max, B] (VN-slot layout) -> c2v [M*dc_max, B] in CN-slot
    layout, zeros in the padding slots.  Arithmetic runs in (at least)
    float32 whatever the storage type.  While a profiler runs, the update
    is the span ``ldpc.decode.bp_check``.
    """
    with spans.span(spans.BP_CHECK):
        msgs = gather_cn(code, v2c_flat)  # [M, dc_max, B]
        cdt = torch.promote_types(msgs.dtype, torch.float32)
        m, dc_max, b = msgs.shape
        mask = code.cn_mask[:, :, None]

        msgs_c = msgs.to(cdt)
        u = torch.exp(-msgs_c.abs())
        sign = sgn_pos(msgs_c)
        # neutral elements in the padding slots: u = 0, sign +1
        u = torch.where(mask, u, torch.zeros_like(u))
        sign = torch.where(mask, sign, torch.ones_like(sign))

        mags = pair_excl_logmags([u[:, j] for j in range(dc_max)])
        sprods = excl_sign_products([sign[:, j] for j in range(dc_max)])
        c2v = torch.stack([sp * mg for sp, mg in zip(sprods, mags)], dim=1)
        c2v = torch.where(mask, c2v, torch.zeros_like(c2v))
        return c2v.reshape(m * dc_max, b)


def bp_step(code: Code, max_llr: float = MAXLLR, storage_dtype=None):
    """The :func:`decode_bp` iteration as a function of (messages, channel
    term): ``step(v2c, llr_t) -> (v2c', total)`` with ``llr_t`` the clamped
    ``[N, B]`` LLRs.  ``code`` must have its tables on the messages'
    device."""
    vn_mask = code.vn_mask[:, :, None]

    def step(v2c, llr_t):
        sdt = storage_dtype if storage_dtype is not None else llr_t.dtype
        c2v = bp_cn_update(code, v2c)
        msgs = gather_vn(code, c2v)  # [N, dv_max, B]
        msgs = torch.where(vn_mask, msgs, torch.zeros_like(msgs))
        v2c, total, _ = vn_update(code, llr_t, msgs.reshape(-1, msgs.shape[-1]),
                                  clamp=max_llr)
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
    step_y = bp_step(plan.code, max_llr, storage_dtype)
    d, iters, done = run_flooding_soft(
        llr_t, v2c0, lambda v2c: step_y(v2c, llr_t),
        lambda d: xor_satisfied(plan.check_cols, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
