"""Decoders: the flooding min-sum decoders (slot-array and QC), the
GDBF/NGDBF bit-flip family, and their shared machinery."""

from .base import (
    DecodeResult,
    NoiseKey,
    check_satisfied,
    gather_cn,
    gather_vn,
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
from .minsum import (
    MinSumPlan,
    decode_minsum,
    minsum_cn_update,
    minsum_plan,
    minsum_step,
    vn_update,
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
    "check_satisfied",
    "gather_cn",
    "gather_vn",
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
    "MinSumPlan",
    "decode_minsum",
    "minsum_cn_update",
    "minsum_plan",
    "minsum_step",
    "vn_update",
    "decode_minsum_qc",
    "qc_check_satisfied",
    "qc_minsum_step",
    "qc_plan",
    "qc_ragged_init",
]
