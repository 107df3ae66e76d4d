"""Decoders: min-sum (slot-array, QC, row-layered), sum-product BP (slot-array,
QC, row-layered), DD-BMP, the GDBF/NGDBF bit-flip family, the hardware-model
bit-flip decoders (fixed-point NGDBFhw, the SystemC-model NGDBF), the
non-binary FFT-QSPA and NB min-sum/min-max, and their shared machinery
(the bit-flip graph operations as row gathers, ``qc_ops``, or as dense
matrix products, ``dense_ops``)."""

from .base import (
    DecodeResult,
    NoiseKey,
    check_satisfied,
    gather_cn,
    gather_vn,
    run_flooding,
    run_flooding_soft,
    sgn_neg,
    sgn_pos,
    storage_cast,
    syndrome_from_hard,
)
from .bp import MAXLLR, bp_cn_update, bp_step, decode_bp, pair_excl_logmags
from .bp_layered import decode_bp_layered_qc, qc_bp_layered_step
from .bp_qc import decode_bp_qc, qc_bp_step, qc_cn_bp
from .dense_ops import (
    DENSE_MAX_ENTRIES,
    DenseGraph,
    dense_sat_sum_per_vn,
    dense_syndrome01,
    dense_syndrome_bipolar,
    dense_syndrome_sum_per_vn,
    dense_worthwhile,
)
from .ddbmp import (
    ddbmp_round,
    decode_ddbmp,
    decode_ddbmp_qc,
    qc_ddbmp_round,
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
from .minsum_layered import (
    decode_minsum_layered_qc,
    layered_l0,
    qc_minsum_layered_step,
)
from .minsum_qc import (
    LayerPlan,
    QCPlan,
    assert_layered_compatible,
    decode_minsum_qc,
    qc_check_satisfied,
    qc_minsum_step,
    qc_plan,
    qc_ragged_init,
)
from .nb_minsum import decode_nb_minsum, decode_nb_minsum_nll, nb_nll
from .nb_qspa import NBDecodeResult, decode_nb_qspa, nb_qspa_machine, wht
from .ngdbf_hw import (
    RING_LANE_STEP,
    NGDBFHwConfig,
    NGDBFHwResult,
    decode_ngdbf_hw,
    hw_graph_ops,
    hw_quantize_int,
    keyed_ring,
    lane_rings,
)
from .ngdbf_systemc import (
    SystemCNGDBFConfig,
    decode_ngdbf_systemc,
    keyed_source,
)

__all__ = [
    "DecodeResult",
    "NoiseKey",
    "check_satisfied",
    "gather_cn",
    "gather_vn",
    "run_flooding",
    "run_flooding_soft",
    "sgn_neg",
    "sgn_pos",
    "storage_cast",
    "syndrome_from_hard",
    "MAXLLR",
    "bp_cn_update",
    "bp_step",
    "decode_bp",
    "pair_excl_logmags",
    "decode_bp_layered_qc",
    "qc_bp_layered_step",
    "decode_bp_qc",
    "qc_bp_step",
    "qc_cn_bp",
    "ddbmp_round",
    "decode_ddbmp",
    "decode_ddbmp_qc",
    "qc_ddbmp_round",
    "DENSE_MAX_ENTRIES",
    "DenseGraph",
    "dense_sat_sum_per_vn",
    "dense_syndrome01",
    "dense_syndrome_bipolar",
    "dense_syndrome_sum_per_vn",
    "dense_worthwhile",
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
    "decode_minsum_layered_qc",
    "layered_l0",
    "qc_minsum_layered_step",
    "LayerPlan",
    "QCPlan",
    "assert_layered_compatible",
    "decode_minsum_qc",
    "qc_check_satisfied",
    "qc_minsum_step",
    "qc_plan",
    "qc_ragged_init",
    "decode_nb_minsum",
    "decode_nb_minsum_nll",
    "nb_nll",
    "NBDecodeResult",
    "decode_nb_qspa",
    "nb_qspa_machine",
    "wht",
    "RING_LANE_STEP",
    "NGDBFHwConfig",
    "NGDBFHwResult",
    "decode_ngdbf_hw",
    "hw_graph_ops",
    "hw_quantize_int",
    "keyed_ring",
    "lane_rings",
    "SystemCNGDBFConfig",
    "decode_ngdbf_systemc",
    "keyed_source",
]
