"""The row-layered min-sum family: the program's decoder and the plain
reference.

The sweep CLI's min-sum routes under ``--schedule layered``
(``ldpcsimulation_tpu_torch.tools.sweep``) decode a QC code with
``decode_minsum_layered_qc``, one layer a base row, with or without early
termination; its ``normalizedminsum`` route decodes ``quantize_no_zero``
samples.  The cell follows it.  The code is built from the frozen table,
which both sides take.
"""

from __future__ import annotations

import torch

from ..reference import codes, philox
from ..reference import minsum_layered as ref_layered
from ._qc import qc_code
from .minsum import _STORAGE


class Port:
    """The program's side of one configuration on one device."""

    def __init__(self, cfg: dict, table: dict, device):
        dec = cfg["decoder"]
        self.device = torch.device(device)
        self.qc = qc_code(table)
        self.code = self.qc.to_code(self.device)
        self.T = dec["iterations"]
        self.quantizer = cfg["quantizer"]
        self.kw = dict(variant=dec["variant"], alpha=dec.get("alpha", 1.0),
                       early_termination=dec.get("early_termination", False),
                       storage_dtype=_STORAGE[cfg["precision"]["storage"]])

    def batch_decoder(self, sigma: float):
        """``(decode(y, key), preprocess)`` for ``harness.simulate``: the
        layered QC decoder on the quantized samples, as the sweep's
        ``normalizedminsum --schedule layered`` route takes them (``sigma``
        unused: min-sum takes the samples alone)."""
        from ldpcsimulation_tpu_torch.channel.quantize import (
            quantize_no_zero,
        )
        from ldpcsimulation_tpu_torch.decoders.minsum_layered import (
            decode_minsum_layered_qc,
        )

        qc, T, kw = self.qc, self.T, self.kw
        ymax, levels = self.quantizer["ymax"], self.quantizer["levels"]
        return ((lambda y, key: decode_minsum_layered_qc(qc, y, T, **kw)),
                lambda y: quantize_no_zero(y, ymax, levels))

    def grid_decoder(self):
        raise NotImplementedError(
            "no grid cell runs the layered schedule: its cell is one card")


def reference(cfg: dict, graph, seed: int, frames: torch.Tensor,
              sigma: float, prec):
    """(decoder input [F, n] f32: the quantized samples, hard [F, n] ±1,
    iterations [F], satisfied [F]) of the frames ``frames`` in the
    precision ``prec`` (the samples rounded to its channel type before the
    quantizer)."""
    dec = cfg["decoder"]
    if dec["variant"] != "normalized":
        raise NotImplementedError(
            f"the layered reference writes out normalized min-sum, not "
            f"{dec['variant']!r}")
    y = philox.channel(seed, frames, graph.n, sigma)
    y = ref_layered.quantize(y.to(prec.channel).to(torch.float32),
                             cfg["quantizer"]["ymax"],
                             cfg["quantizer"]["levels"])
    hard, its, sat = ref_layered.decode(
        graph, codes.load_table(cfg["code"]), y, dec["iterations"],
        dec["alpha"], prec, dec.get("early_termination", False))
    return y, hard, its, sat
