"""Channel layer: BPSK, AWGN (generator-drawn and keyed), LLR conversion,
saturation, the reference's quantizers, and the non-binary symbol priors."""

from .awgn import (
    MAXLLR,
    awgn,
    awgn_all_zero,
    bpsk,
    llr_from_channel,
    n0_to_sigma,
    snr_to_n0,
    snr_to_sigma,
)
from .nb import bits_to_symbols, symbol_priors, symbols_to_bits
from .quantize import (
    quantize_no_zero,
    quantize_round,
    quantize_threshold_table,
    saturate,
)

__all__ = [
    "MAXLLR",
    "awgn",
    "awgn_all_zero",
    "bpsk",
    "llr_from_channel",
    "n0_to_sigma",
    "snr_to_n0",
    "snr_to_sigma",
    "bits_to_symbols",
    "symbol_priors",
    "symbols_to_bits",
    "quantize_no_zero",
    "quantize_round",
    "quantize_threshold_table",
    "saturate",
]
