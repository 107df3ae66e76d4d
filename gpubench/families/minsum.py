"""The min-sum family: the program's decoders and the plain reference.

The sweep CLI's ``minsum`` route (``ldpcsimulation_tpu_torch.tools.sweep``)
decodes a QC code with ``decode_minsum_qc`` on the QC plan, and under
``--distributed`` with the slot-array ``decode_minsum``, with or without
early termination; the cells follow it.  The code is built from the frozen
table, which both sides take.
"""

from __future__ import annotations

import torch

from ..reference import minsum as ref_minsum
from ..reference import philox
from ._qc import qc_code

_STORAGE = {"float16": torch.float16, "float32": None}

#: the device bytes one block of the reference may take, at most
#: ``_EDGE_FRAME_BYTES`` an edge and frame: a kept batch of a wide code
#: (DVB-S2, 226799 edges) is decoded in blocks of frames
_BLOCK_BYTES = 8 * 2 ** 30
_EDGE_FRAME_BYTES = 64


def _kw(cfg: dict) -> dict:
    dec = cfg["decoder"]
    return dict(variant=dec["variant"],
                early_termination=dec.get("early_termination", False),
                storage_dtype=_STORAGE[cfg["precision"]["storage"]])


class Port:
    """The program's side of one configuration on one device."""

    def __init__(self, cfg: dict, table: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.qc = qc_code(table)
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


def frames_per_block(graph) -> int:
    """How many frames one block of the reference decodes: the byte budget
    over the code's edges."""
    return max(1, _BLOCK_BYTES // (_EDGE_FRAME_BYTES * graph.e))


def reference(cfg: dict, graph, seed: int, frames: torch.Tensor,
              sigma: float, prec):
    """(decoder input [F, n] f32, hard [F, n] ±1, iterations [F], satisfied
    [F]) of the frames ``frames`` in the precision ``prec``, decoded
    :func:`frames_per_block` frames at a time: every frame's channel and
    decoding are its own, so the blocks' results are the whole batch's."""
    step = frames_per_block(graph)
    parts = [_reference_block(cfg, graph, seed, frames[i:i + step], sigma,
                              prec)
             for i in range(0, len(frames), step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _reference_block(cfg: dict, graph, seed: int, frames: torch.Tensor,
                     sigma: float, prec):
    dec = cfg["decoder"]
    y = philox.channel(seed, frames, graph.n, sigma)
    y = y.to(prec.channel).to(torch.float32)
    hard, its, sat = ref_minsum.decode(graph, y, dec["iterations"], prec,
                                       dec.get("early_termination", False))
    return y, hard, its, sat
