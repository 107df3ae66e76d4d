"""Channel layer: BPSK, AWGN (generator-drawn and keyed), LLR conversion."""

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

__all__ = [
    "MAXLLR",
    "awgn",
    "awgn_all_zero",
    "bpsk",
    "llr_from_channel",
    "n0_to_sigma",
    "snr_to_n0",
    "snr_to_sigma",
]
