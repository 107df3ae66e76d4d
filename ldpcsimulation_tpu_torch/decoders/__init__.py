"""Decoders: the flooding QC min-sum decoder, the GDBF/NGDBF bit-flip
family, and their shared machinery."""

from .base import (
    DecodeResult,
    NoiseKey,
    run_flooding_soft,
    sgn_neg,
    sgn_pos,
    storage_cast,
    syndrome_from_hard,
)
from .gdbf import (
    PRESETS,
    GDBFConfig,
    GDBFResult,
    decode_gdbf,
    keyed_draws,
    preset,
)
from .minsum_qc import (
    decode_minsum_qc,
    qc_check_satisfied,
    qc_minsum_step,
    qc_plan,
    qc_ragged_init,
)

__all__ = [
    "DecodeResult",
    "NoiseKey",
    "run_flooding_soft",
    "sgn_neg",
    "sgn_pos",
    "storage_cast",
    "syndrome_from_hard",
    "PRESETS",
    "GDBFConfig",
    "GDBFResult",
    "decode_gdbf",
    "keyed_draws",
    "preset",
    "decode_minsum_qc",
    "qc_check_satisfied",
    "qc_minsum_step",
    "qc_plan",
    "qc_ragged_init",
]
