"""Plain PyTorch reference of the benchmark's configurations.

It imports ``torch`` and ``numpy`` only, never the program: the channel, the
decoders' noise and the decoders are written out here from their published
definitions, and the code's parity-check matrix comes from the frozen table
under ``codes/``.  ``Precision`` names the dtypes a run computes in, so the
same functions give the reference and its control (one precision step
lower).
"""

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    """channel: the dtype of the channel samples; storage: of the stored
    messages (min-sum); arith: of the decoders' arithmetic."""

    channel: torch.dtype = torch.float32
    storage: torch.dtype = torch.float16
    arith: torch.dtype = torch.float32


DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}


def precision(spec: dict) -> Precision:
    """A :class:`Precision` from a configuration's ``{"channel": "float32",
    ...}`` names."""
    return Precision(**{k: DTYPES[v] for k, v in spec.items()})


def sigma_of(snr_db: float, rate: float) -> float:
    """The channel's deviation at Eb/N0 ``snr_db``: N0 = 10^(−SNR/10)/R,
    σ = √(N0/2)."""
    return math.sqrt((10.0 ** (-snr_db / 10.0) / rate) / 2.0)
