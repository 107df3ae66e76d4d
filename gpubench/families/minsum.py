"""The min-sum family: the program's decoders and the plain reference.

The sweep CLI's ``minsum`` route (``ldpcsimulation_tpu_torch.tools.sweep``)
decodes a QC code with ``decode_minsum_qc`` on the QC plan, and under
``--distributed`` with the slot-array ``decode_minsum``; the cells follow
it.  The code is built from the frozen table, which both sides take.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import minsum as ref_minsum
from ..reference import philox

_STORAGE = {"float16": torch.float16, "float32": None}


def _kw(cfg: dict) -> dict:
    dec = cfg["decoder"]
    if dec.get("early_termination"):
        raise NotImplementedError("the min-sum cells run a fixed T")
    return dict(variant=dec["variant"],
                storage_dtype=_STORAGE[cfg["precision"]["storage"]])


class Port:
    """The program's side of one configuration on one device."""

    def __init__(self, cfg: dict, table: dict, device):
        from ldpcsimulation_tpu_torch.codes.qc import build_qc_code

        self.cfg, self.device = cfg, torch.device(device)
        self.qc = build_qc_code(np.array(table["base"]), table["z"])
        self.code = self.qc.to_code(self.device)
        self.T = cfg["decoder"]["iterations"]
        self.kw = _kw(cfg)

    def batch_decoder(self, sigma: float):
        """``(decode(y, key), preprocess)`` for ``harness.simulate``: the
        QC decoder, as the sweep's single-device route takes it (``sigma``
        unused: min-sum takes the samples alone)."""
        from ldpcsimulation_tpu_torch.decoders.minsum_qc import (
            decode_minsum_qc,
        )

        qc, T, kw = self.qc, self.T, self.kw
        return (lambda y, key: decode_minsum_qc(qc, y, T, **kw)), None

    def grid_decoder(self):
        """``(decode(y, sigma, key, point), preprocess)`` for
        ``parallel.montecarlo.simulate_grid``: the slot-array decoder, as
        the sweep's ``--distributed`` route takes it."""
        from ldpcsimulation_tpu_torch.decoders.minsum import decode_minsum

        code, T, kw = self.code, self.T, self.kw
        return (lambda y, sigma, key, point: decode_minsum(code, y, T, **kw),
                None)


def reference(cfg: dict, graph, seed: int, frames: torch.Tensor,
              sigma: float, prec):
    """(decoder input [F, n] f32, hard [F, n] ±1, iterations [F], satisfied
    [F]) of the frames ``frames`` in the precision ``prec``."""
    y = philox.channel(seed, frames, graph.n, sigma)
    y = y.to(prec.channel).to(torch.float32)
    hard, its, sat = ref_minsum.decode(graph, y, cfg["decoder"]["iterations"],
                                       prec)
    return y, hard, its, sat
