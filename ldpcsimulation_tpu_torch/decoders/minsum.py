"""Flooding min-sum decoder on the slot-array Tanner graph of any binary
code: plain, normalized and offset variants.

Port of ``ldpcsimulation_tpu.decoders.minsum`` with the same arithmetic,
slot order and tie-breaking, so its decisions equal the JAX decoder's bit
for bit on the same samples.  Messages live in VN-slot layout
``[N * dv_max, B]`` (batch last).

The CN update is kernel B1 in its TPU kernel's own generic form: the
routing table is ``where(cn_mask, cn_from_vn, −1)``, so check c's slot t
reads VN slot ``cn_from_vn[c, t]`` of v2c and writes that slot of c2v.
The c2v messages therefore land in VN-slot layout (in the storage type:
exact) and the VN update needs no gather: kernel B5
(:func:`..kernels.minsum.minsum_vn_update`) folds each column's dv_max
slots left to right, adds the channel term last and stores v2c' over
c2v, in one pass on the table ``MinSumPlan.vn_rows``.  B1 does not write
the padding slots; the table names them as +0.0 terms, which the fold
adds as the JAX decoder does.  The variant post-op (``/ alpha``,
``|·| − delta``) runs inside B1 in the storage precision, as the JAX
decoder's weakly typed scalars do.

The reference min-sum (``decodeMinSum.cpp``) always runs all T iterations;
``early_termination=True`` is the framework's extension.  Min-sum works on
the (optionally quantized) channel samples, not on LLRs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..codes.code import Code
from ..kernels.minsum import (
    VARIANTS,
    minsum_cn_scan,
    zero_term,
)
from .base import (
    DecodeResult,
    check_columns,
    minsum_iteration,
    run_flooding_soft,
    sgn_pos,
    xor_satisfied,
)

__all__ = ["MinSumPlan", "minsum_plan", "minsum_cn_update", "vn_update",
           "apply_normalization", "apply_offset", "minsum_step",
           "decode_minsum"]


@dataclasses.dataclass(frozen=True, eq=False)
class MinSumPlan:
    """Tables of one code on one device.

    code:       the code with its tables on the plan's device.
    cn_rows:    [M, dc_max] int32 — ``cn_from_vn`` with −1 in padding
                slots; B1's and B8's routing table.
    check_cols: [M, dc_max] int64 — ``cn_vn`` with the sentinel column N
                in padding slots; the syndrome check's table.
    vn_pad:     int64 rows of the VN padding slots, which no check names
                (None for a code without any).
    vn_rows:    [N, dv_max] int32 — kernel B5's table: slot ``v * dv_max +
                s`` at column v, position s; padding slots as +0.0 terms.
    """

    code: Code
    cn_rows: torch.Tensor
    check_cols: torch.Tensor
    vn_pad: Optional[torch.Tensor]
    vn_rows: torch.Tensor


@functools.lru_cache(maxsize=None)
def minsum_plan(code: Code, device) -> MinSumPlan:
    """B1's routing table of ``code`` on ``device`` (built once, cached)."""
    code = code.to(device)
    cn_rows = torch.where(code.cn_mask, code.cn_from_vn,
                          torch.full_like(code.cn_from_vn, -1))
    pad = (~code.vn_mask.reshape(-1)).nonzero()[:, 0]
    slots = torch.arange(code.n * code.dv_max, device=code.vn_mask.device)
    vn_rows = torch.where(code.vn_mask.reshape(-1), slots, zero_term(slots))
    return MinSumPlan(
        code=code,
        cn_rows=cn_rows.to(torch.int32).contiguous(),
        check_cols=check_columns(code),
        vn_pad=pad if pad.numel() else None,
        vn_rows=vn_rows.view(code.n, code.dv_max).to(torch.int32),
    )


def minsum_cn_update(code: Code, v2c_flat: torch.Tensor,
                     variant: str = "plain", alpha: float = 1.0,
                     delta: float = 0.0) -> torch.Tensor:
    """Check-node min-sum update with the variant post-op (kernel B1).

    v2c_flat: [N*dv_max, B] variable→check messages (VN-slot layout, f16 or
    f32).  Returns c2v [N*dv_max, B] f32 in VN-slot layout — unlike the JAX
    function, whose output is in CN-slot layout and whose post-op is
    separate — with exact zeros in the padding slots.
    """
    plan = minsum_plan(code, v2c_flat.device)
    c2v = minsum_cn_scan(v2c_flat.contiguous(), plan.cn_rows, variant,
                         alpha, delta)
    if plan.vn_pad is not None:  # slots B1 does not write
        c2v.index_fill_(0, plan.vn_pad, 0.0)
    return c2v


def vn_update(code: Code, y_t: torch.Tensor, c2v_flat: torch.Tensor,
              clamp: Optional[float] = None):
    """Variable-node total-sum update (decodeMinSum.cpp:452-476).

    y_t: [N, B] channel samples; c2v_flat: [N*dv_max, B] in VN-slot layout
    with zeros in the padding slots (as :func:`minsum_cn_update` gives).
    Returns (v2c_flat [N*dv_max, B], total [N, B], d [N, B] ±1 int32).
    The fold is pinned: messages left to right over all dv_max slots,
    padding zeros included, then the channel term — y + ((m₀ + m₁) + m₂ …).
    ``clamp`` bounds the outgoing messages to ±clamp (BP,
    decodeBP.cpp:399-401).
    """
    msgs = c2v_flat.view(code.n, code.dv_max, -1)
    acc = msgs[:, 0]
    for j in range(1, code.dv_max):
        acc = acc + msgs[:, j]
    total = y_t + acc
    v2c = total[:, None, :] - msgs
    if clamp is not None:
        v2c = torch.clamp(v2c, -clamp, clamp)
    d = torch.where(total > 0, 1, -1).to(torch.int32)
    return v2c.reshape(code.n * code.dv_max, -1), total, d


def _scalar(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a 0-dim tensor of x's dtype on x's device (a fill, not a
    host copy): the JAX function's weakly typed scalar, rounded to the
    messages' dtype."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def apply_normalization(c2v_flat: torch.Tensor, alpha: float) -> torch.Tensor:
    """check_to_sym /= alpha (decodeMinSum.cpp:493-500 — a division).  The
    divisor is a 0-dim tensor: by a Python scalar, the CUDA division would
    run as a multiply by its reciprocal."""
    return c2v_flat / _scalar(c2v_flat, alpha)


def apply_offset(c2v_flat: torch.Tensor, delta: float) -> torch.Tensor:
    """|msg| -= delta, clamped at 0, sign kept (decodeMinSum.cpp:502-516)."""
    mag = c2v_flat.abs() - _scalar(c2v_flat, delta)
    return torch.where(mag > 0, sgn_pos(c2v_flat) * mag,
                       torch.zeros_like(c2v_flat))


def minsum_step(code: Code, variant: str = "plain", alpha: float = 1.0,
                delta: float = 0.0, storage_dtype=None):
    """The :func:`decode_minsum` iteration as a function of (messages,
    channel term): ``step(v2c, y_t) -> (v2c', total)`` with ``y_t`` the
    ``[N, B]`` channel samples and v2c' in the storage dtype.  Kernel B1
    stores c2v in the storage dtype; kernel B5 folds it in the channel's
    dtype (an f16 channel folds in f16, as the JAX step casts c2v to it)
    and writes v2c' over it (``v2c`` itself is not written).  Messages in
    another dtype take :func:`.base.minsum_iteration`'s f32 route."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")

    def step(v2c, y_t):
        plan = minsum_plan(code, v2c.device)
        return minsum_iteration(v2c.contiguous(), y_t.contiguous(),
                                plan.cn_rows, plan.vn_rows, variant, alpha,
                                delta, storage_dtype)

    return step


def decode_minsum(
    code: Code,
    y: torch.Tensor,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding min-sum decode.  y: [B, N] channel samples
    (pre-quantized by the caller for the fixed-point variants — the
    reference quantizes the channel, not the messages).

    variant: "plain" | "normalized" | "offset".  storage_dtype: optional
    narrower message dtype (e.g. torch.float16); arithmetic stays f32 and
    each v2c store saturates at the storage range.  The code's tables are
    taken to y's device (once, cached).
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")
    y_t = y.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != code.n:
        raise ValueError(f"y has {n} columns, the code {code.n}")
    plan = minsum_plan(code, y_t.device)
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype
    step_y = minsum_step(plan.code, variant, alpha, delta, storage_dtype)
    # initializeSymMessages: every VN slot starts at the channel sample (no
    # name of its own: the flooding loop lets it go after the first step)
    d, iters, done = run_flooding_soft(
        y_t, y_t.to(sdt).repeat_interleave(code.dv_max, dim=0),
        lambda v2c: step_y(v2c, y_t),
        lambda d: xor_satisfied(plan.check_cols, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
