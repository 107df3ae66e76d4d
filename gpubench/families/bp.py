"""The sum-product BP family: the program's decoder and the plain reference.

The sweep CLI's ``bp`` route (``ldpcsimulation_tpu_torch.tools.sweep``)
decodes the LLRs ``llr_from_channel(y, N0)`` of a QC code with
``decode_bp_qc`` on the QC plan; the cell follows it, with N0 = 2σ².  The
code is built from the frozen table, which both sides take.
"""

from __future__ import annotations

import torch

from ..reference import bp as ref_bp
from ..reference import philox, precision
from ._qc import qc_code


def n0_of(sigma: float) -> float:
    """The channel's N0 = 2σ², as both sides compute it."""
    return 2.0 * sigma * sigma


class Port:
    """The program's side of one configuration on one device."""

    def __init__(self, cfg: dict, table: dict, device):
        dec = cfg["decoder"]
        if not dec["early_termination"]:
            raise NotImplementedError("the BP cells terminate early")
        self.device = torch.device(device)
        self.qc = qc_code(table)
        self.code = self.qc.to_code(self.device)
        self.T, self.max_llr = dec["iterations"], dec["max_llr"]
        self.sdt = precision(cfg["precision"]).storage

    def batch_decoder(self, sigma: float):
        """``(decode(llr, key), preprocess)`` for ``harness.simulate``: the
        QC decoder on the LLRs, as the sweep's single-device route takes
        them."""
        from ldpcsimulation_tpu_torch.channel.awgn import llr_from_channel
        from ldpcsimulation_tpu_torch.decoders.bp_qc import decode_bp_qc

        qc, T, top, sdt = self.qc, self.T, self.max_llr, self.sdt
        n0 = n0_of(sigma)
        return ((lambda llr, key: decode_bp_qc(
            qc, llr, T, max_llr=top, early_termination=True,
            storage_dtype=sdt)),
            lambda y: llr_from_channel(y, n0, top))

    def grid_decoder(self):
        raise NotImplementedError("no grid cell runs BP")


def reference(cfg: dict, graph, seed: int, frames: torch.Tensor,
              sigma: float, prec):
    """(decoder input [F, n] f32: the clamped LLRs, hard [F, n] ±1,
    iterations [F], satisfied [F]) of the frames ``frames`` in the
    precision ``prec`` (the LLRs computed in its channel type)."""
    dec = cfg["decoder"]
    top = dec["max_llr"]
    y = philox.channel(seed, frames, graph.n, sigma).to(prec.channel)
    llr = torch.clamp(4.0 * y / n0_of(sigma), -top, top).to(torch.float32)
    hard, its, sat = ref_bp.decode(graph, llr, dec["iterations"], prec, top)
    return llr, hard, its, sat
