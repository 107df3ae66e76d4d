"""Decoders: the flooding QC min-sum decoder and its shared machinery."""

from .base import DecodeResult, run_flooding_soft, sgn_neg, sgn_pos, storage_cast
from .minsum_qc import (
    decode_minsum_qc,
    qc_check_satisfied,
    qc_minsum_step,
    qc_plan,
    qc_ragged_init,
)

__all__ = [
    "DecodeResult",
    "run_flooding_soft",
    "sgn_neg",
    "sgn_pos",
    "storage_cast",
    "decode_minsum_qc",
    "qc_check_satisfied",
    "qc_minsum_step",
    "qc_plan",
    "qc_ragged_init",
]
