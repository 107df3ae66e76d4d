"""The GDBF/NGDBF bit-flip family: the program's decoder and the plain
reference.

The sweep CLI's ``gdbf`` route (``ldpcsimulation_tpu_torch.tools.sweep``)
saturates the samples at ±Ymax and decodes them with ``decode_gdbf`` on the
QC structure; the cells follow it.  The code is built from the frozen
table, which both sides take.
"""

from __future__ import annotations

import torch

from ..reference import ngdbf as ref_ngdbf
from ..reference import philox
from ._qc import qc_code

#: the presets the plain reference writes out
_REFERENCE_PRESETS = ("SMNGDBF",)


class Port:
    """The program's side of one configuration on one device."""

    def __init__(self, cfg: dict, table: dict, device):
        from ldpcsimulation_tpu_torch.decoders.gdbf import preset

        self.device = torch.device(device)
        self.qc = qc_code(table)
        self.code = self.qc.to_code(self.device)
        dec = cfg["decoder"]
        self.gcfg = preset(dec["preset"], num_iterations=dec["iterations"],
                           theta=dec["theta"], noise_scale=dec["noise_scale"],
                           lam=dec["lam"], alpha=dec["alpha"],
                           window_size=dec["window"])
        self.ymax = dec["ymax"]

    def _pre(self):
        from ldpcsimulation_tpu_torch.channel.quantize import saturate

        ymax = self.ymax
        return lambda y: saturate(y, ymax)

    def batch_decoder(self, sigma: float):
        """``(decode(y, key), preprocess)`` for ``harness.simulate``."""
        from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf

        code, qc, g = self.code, self.qc, self.gcfg
        return (lambda y, key: decode_gdbf(code, y, sigma, g, key=key,
                                           qc=qc)), self._pre()

    def grid_decoder(self):
        """``(decode(y, sigma, key, point), preprocess(y, point))`` for
        ``parallel.montecarlo.simulate_grid``."""
        from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf

        code, qc, g, pre = self.code, self.qc, self.gcfg, self._pre()
        return ((lambda y, sigma, key, point: decode_gdbf(
            code, y, sigma, g, key=key, qc=qc)),
            lambda y, point: pre(y))


def reference(cfg: dict, graph, seed: int, frames: torch.Tensor,
              sigma: float, prec):
    """(decoder input [F, n] f32, hard [F, n] ±1, iterations [F], satisfied
    [F]) of the frames ``frames`` in the precision ``prec``."""
    dec = cfg["decoder"]
    if dec["preset"] not in _REFERENCE_PRESETS:
        raise NotImplementedError(f"no plain reference of {dec['preset']}")
    y = philox.channel(seed, frames, graph.n, sigma)
    top = ref_ngdbf.f32(dec["ymax"])
    y = torch.clamp(y, -top, top).to(prec.channel).to(torch.float32)
    hard, its, sat = ref_ngdbf.decode(graph, y, dec, sigma, seed, frames,
                                      prec)
    return y, hard, its, sat
