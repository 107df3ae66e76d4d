"""Erroneous-message tracing for the soft decoders.

Port of ``ldpcsimulation_tpu.tools.msg_trace``.  Reference counterpart:
``writeErroneousMessagesToFile`` (``decodeBP.cpp:462-548``, compile-gated
by ``-DerroneousMessageFile``): per-frame, per-iteration dumps of which
symbol→check messages carry the wrong sign relative to the transmitted
codeword, and which checks received erroneous messages — the debugging
view used to study decoder failures.

This version steps the port's flooding iterations on one frame
(:func:`..decoders.minsum.minsum_step`, whose check update is kernel B1,
or :func:`..decoders.bp.bp_step`) in f32, and reports the same quantities
as arrays.  The per-check counts come from one table gather per iteration
(each check slot reads the first VN slot of its variable that points back
at the check, as the JAX function's loop does).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..codes.code import Code
from ..decoders.bp import MAXLLR, bp_step
from ..decoders.minsum import minsum_step

__all__ = ["MessageTrace", "trace_soft_decoder"]


@dataclasses.dataclass
class MessageTrace:
    """Per-iteration message-error view of a single frame.

    v2c_sign_errors[it][N, dv_max]: True where an outgoing VN message's
    sign disagrees with the transmitted bipolar symbol (masked slots False).
    checks_with_errors[it][M]: count of erroneous incoming messages per
    check (the reference's per-check view).
    decisions[it][N]: hard decisions after the iteration.
    """

    v2c_sign_errors: List[np.ndarray]
    checks_with_errors: List[np.ndarray]
    decisions: List[np.ndarray]


def _check_slots(code: Code) -> torch.Tensor:
    """[M, dc_max] VN-slot index (v·dv_max + s) that each check slot reads:
    s is the first slot of variable v whose check is this one."""
    rows = torch.arange(code.m, device=code.cn_vn.device)[:, None, None]
    cols = code.cn_vn.long()
    hit = code.vn_cn[cols].long() == rows  # [M, dc_max, dv_max]
    first = hit.to(torch.int32).argmax(dim=2)
    return cols * code.dv_max + first


def trace_soft_decoder(
    code: Code,
    samples,
    truth_bipolar,
    num_iterations: int,
    algorithm: str = "minsum",
    device="cuda",
) -> MessageTrace:
    """Step a flooding decoder on ONE frame, recording message errors.

    samples: [N] decoder-domain inputs (LLRs for "bp", channel samples for
    "minsum"), taken to f32.  truth_bipolar: [N] transmitted ±1 symbols.
    ``device`` defaults to the card; ``device="cpu"`` runs the plain twins.
    """
    if algorithm not in ("bp", "minsum"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    code = code.to(device)
    step = bp_step(code, MAXLLR) if algorithm == "bp" else minsum_step(code)
    y_t = torch.as_tensor(samples, dtype=torch.float32, device=device)[:, None]
    truth = torch.as_tensor(np.asarray(truth_bipolar), device=device)
    v2c = y_t.repeat_interleave(code.dv_max, dim=0)
    slots = _check_slots(code)
    errs_all, per_check_all, d_all = [], [], []
    for _ in range(num_iterations):
        v2c, total = step(v2c, y_t)
        msgs = v2c.view(code.n, code.dv_max)
        # a message is erroneous when its sign (sgn(0) = +1) disagrees with
        # the transmitted symbol (decodeBP.cpp:486-497)
        sign = torch.where(msgs >= 0, 1, -1)
        errs = (sign != truth[:, None]) & code.vn_mask
        per_check = (errs.reshape(-1)[slots] & code.cn_mask).sum(dim=1)
        errs_all.append(errs)
        per_check_all.append(per_check)
        d_all.append(torch.where(total[:, 0] > 0, 1, -1).to(torch.int32))
    out = MessageTrace([], [], [])
    if num_iterations:
        out.v2c_sign_errors = list(torch.stack(errs_all).cpu().numpy())
        out.checks_with_errors = list(torch.stack(per_check_all).cpu().numpy())
        out.decisions = list(torch.stack(d_all).cpu().numpy())
    return out
