"""NGDBFhw bit-level iteration traces (the reference's LOG_PROCESSING
records).

Port of ``ldpcsimulation_tpu.tools.hw_trace``: decodes ONE frame with a
plain-Python integer loop (the semantics of :mod:`..decoders.ngdbf_hw`,
held against it in the tests) while writing the same records: the
quantized channel word, the noise ring, and per iteration and node the
incoming syndromes, the syndrome sum, the ring sample, the flip metric E,
theta and the flip decision, with the sign-magnitude NQ-bit pattern of
each sample.  Used to diff the software model against an RTL or ASIC
simulation bit by bit.

    from ldpcsimulation_tpu_torch.tools.hw_trace import trace_ngdbf_hw
    with open("trace.txt", "w") as out:
        d, iters, sat, qptr = trace_ngdbf_hw(code, y, sigma, cfg, ring, out)
"""

from __future__ import annotations

import math
from typing import Optional, TextIO

import numpy as np

from ..codes.code import Code
from ..decoders.ngdbf_hw import NGDBFHwConfig

__all__ = ["trace_ngdbf_hw"]


def _quant_int(x: float, nl: int, lmax: float) -> int:
    mag = math.floor(abs(x) * nl / (2.0 * lmax))
    return (1 if x > 0 else -1) * (2 * mag + 1)


def _pack_bits(value: int, nq: int) -> str:
    """Sign-magnitude NQ-bit pattern of an unpacked sample
    (|value| = 2·mag + 1)."""
    mag = (abs(value) - 1) // 2
    return ("1" if value < 0 else "0") + format(mag, f"0{nq - 1}b")


def trace_ngdbf_hw(
    code: Code,
    y: Optional[np.ndarray],
    sigma: float,
    cfg: NGDBFHwConfig,
    ring_noise: Optional[np.ndarray],
    out: TextIO,
    max_iterations: Optional[int] = None,
    yint_override: Optional[np.ndarray] = None,
    qint_override: Optional[np.ndarray] = None,
    qpointer0: int = 0,
):
    """Decode one frame, writing LOG_PROCESSING-style records to ``out``.

    y: [N] raw channel samples; ring_noise: [ring_len] raw σ'·n draws.
    yint_override / qint_override: already-quantized unpacked integers
    (the ±(2·mag+1) domain), for replaying a captured trace bit for bit.
    qpointer0: the starting ring offset (the reference's pointer outlives a
    frame, so a multi-frame replay chains each returned pointer into the
    next call).  Returns (d_bits, iterations, satisfied, final_qpointer).
    """
    n, m = code.n, code.m
    lmax, nl, nq = cfg.lmax, cfg.nl, cfg.nq
    theta = cfg.theta_int
    smult = cfg.smult
    T = max_iterations or cfg.num_iterations

    vn_cn = code.vn_cn.cpu().numpy()
    vn_mask = code.vn_mask.cpu().numpy()
    cn_vn = code.cn_vn.cpu().numpy()
    cn_mask = code.cn_mask.cpu().numpy()

    if yint_override is not None:
        yint = [int(v) for v in yint_override]
    else:
        y = np.asarray(y)
        yc = np.where(np.abs(y) > cfg.ymax, np.sign(y) * cfg.ymax, y)
        yint = [_quant_int(v / (2.0 * cfg.w), nl, lmax) for v in yc]
    r = np.where(np.asarray(yint) > 0, 1, -1)
    d = ((1 - r) // 2).astype(int)
    if qint_override is not None:
        qint = [int(v) for v in qint_override]
    else:
        qint = []
        for q in np.asarray(ring_noise):
            qm = (float(q) - cfg.theta0) / (2.0 * cfg.w) - 1.0
            qm = max(-lmax, min(lmax, qm))
            qint.append(_quant_int(qm, nl, lmax))
    ring_mod = len(qint) - n

    out.write(f"GLOBALS:\n\ttheta = {theta}\n\tSmult = {smult}\n")
    out.write("CHANIN:\n")
    for v in yint:
        out.write(f"\t{_pack_bits(v, nq)}\n")
    out.write("NOISE:\n")
    for v in qint:
        out.write(f"\t{_pack_bits(v, nq)}\n")

    qptr = qpointer0 % ring_mod
    satisfied = False
    it = 0
    while it < T:
        syn = np.ones(m, int)
        satisfied = True
        for c in range(m):
            prod = 1
            for t in range(cn_mask.shape[1]):
                if cn_mask[c, t]:
                    prod *= 1 - 2 * d[cn_vn[c, t]]
            if prod < 0:
                satisfied = False
            syn[c] = (1 - prod) // 2
        if satisfied:
            break
        out.write(f"IT {it}\n")
        for i in range(n):
            ssum = 0
            msgs = []
            for s in range(vn_mask.shape[1]):
                if vn_mask[i, s]:
                    msg = syn[vn_cn[i, s]]
                    msgs.append(str(msg))
                    ssum += 1 - msg
            qv = qint[i + qptr]
            e = (1 - 2 * d[i]) * yint[i] + ssum * smult + qv
            flip = int(e <= theta)
            out.write(
                f"S{i}:\n\tchan: {yint[i]} ({_pack_bits(yint[i], nq)}), "
                f"{d[i]}\n\tin_messages: {' '.join(msgs)}\n"
                f"\tS: {ssum} ({ssum * smult})\n"
                f"\tq: {qv} ({_pack_bits(qv, nq)})\n"
                f"\tE: {e}\n\ttheta: {theta}\n\tflip: {flip}\n"
            )
            if flip:
                d[i] = 1 - d[i]
        qptr += 1
        if qptr >= ring_mod:
            qptr = 0
        it += 1
    return d, it, satisfied, qptr
