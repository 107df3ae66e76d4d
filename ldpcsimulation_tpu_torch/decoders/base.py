"""Shared decoder machinery: results, sign conventions, storage casts, the
flooding driver.

Port of the soft-decoder parts of ``ldpcsimulation_tpu.decoders.base``.
Decoders take channel samples as ``[B, N]`` and keep the batch on the LAST
axis inside (``[rows, B]``), so the kernels' loads coalesce along B.

Sign conventions (a bit-exactness trap):
  * BP / min-sum / DDBMP: ``sgn(0) = +1``
  * GDBF family / NGDBFhw: ``sgn(0) = -1``
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "DecodeResult",
    "sgn_pos",
    "sgn_neg",
    "storage_cast",
    "run_flooding_soft",
]


@dataclasses.dataclass
class DecodeResult:
    """Outcome of a batched decode.

    hard:       [B, N] int32, bipolar ±1 decisions.
    iterations: [B] int32 — with early termination, the update rounds each
                frame used (0 when the channel decisions already check out);
                for fixed-trip decodes, T.
    satisfied:  [B] bool — all parity checks satisfied at exit.
    """

    hard: torch.Tensor
    iterations: torch.Tensor
    satisfied: torch.Tensor


def storage_cast(x: torch.Tensor, sdt: torch.dtype) -> torch.Tensor:
    """Cast messages to the storage dtype, SATURATING at its finite range.

    min-sum magnitudes grow roughly ×(dv+1) per iteration, so deep runs on
    high-degree codes pass float16's 65504, and a plain cast gives inf.
    No-op for f32.
    """
    if sdt.is_floating_point and torch.finfo(sdt).bits < 32:
        m = torch.finfo(sdt).max
        x = torch.clamp(x, -m, m)
    return x.to(sdt)


def sgn_pos(x: torch.Tensor) -> torch.Tensor:
    """sgn(0) = +1 convention (BP/min-sum/DDBMP); -0.0 counts as +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def sgn_neg(x: torch.Tensor) -> torch.Tensor:
    """sgn(0) = -1 convention (GDBF family)."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


def _decide(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.where(total > 0, 1, -1).to(dtype)


def run_flooding_soft(
    total0,
    msgs0,
    step,
    satisfied_of,
    num_iterations: int,
    early_termination: bool,
    batch: int,
):
    """Flooding driver for soft decoders whose hard decisions are the sign
    of a posterior total that ``step`` computes anyway.

    step(msgs) -> (msgs', total)  — one full iteration.
    total0: the pre-iteration posterior (the channel term), in the layout
    of step's total (batch last); gives the decisions when T == 0 and the
    early-termination initial state.
    satisfied_of(d) -> [B] bool, with d in total's layout.

    Fixed-trip: T−1 message-only iterations, then one whose total feeds the
    decisions.  Early termination: the loop stops when every frame checks
    out or at T; only the int8 decision carry is masked (a satisfied
    frame's messages may keep evolving — its latched decision is what the
    decoder returns), and ``iterations`` counts the update rounds each frame
    used.  The host reads the all-done flag once per iteration.

    Returns (d int32 in total's layout, iterations [B] int32, done [B] bool).
    """
    device = total0.device
    if not early_termination:
        if num_iterations <= 0:
            d = _decide(total0, torch.int32)
        else:
            msgs = msgs0
            for _ in range(num_iterations - 1):
                msgs, _ = step(msgs)
            _, total = step(msgs)
            d = _decide(total, torch.int32)
        iters = torch.full((batch,), num_iterations, dtype=torch.int32,
                           device=device)
        return d, iters, satisfied_of(d)

    d = _decide(total0, torch.int8)
    done = satisfied_of(d)
    iters = torch.zeros((batch,), dtype=torch.int32, device=device)
    msgs = msgs0
    t = 0
    while t < num_iterations and not bool(done.all()):
        msgs, total = step(msgs)
        act = ~done
        d = torch.where(act, _decide(total, torch.int8), d)
        iters = torch.where(act, t + 1, iters)
        done = done | satisfied_of(d)
        t += 1
    return d.to(torch.int32), iters, done
