"""BPSK + AWGN channel, in the reference's conventions.

Port of ``ldpcsimulation_tpu.channel.awgn`` (which cites the reference):

  * bit '0' -> +1, '1' -> -1;
  * ``N0 = 10^(-SNR/10) / R``, ``sigma = sqrt(N0/2)`` (SNR is Eb/N0 in dB);
  * multiplicative AWGN ``y = x * (1 + sigma * n)`` (the C simulators) or
    additive ``y = x + sigma * n`` (the SystemC testbench);
  * LLR ``4*y/N0`` clamped to ±MAXLLR (BP only).

Randomness: :func:`awgn` draws from a ``torch.Generator``;
:func:`awgn_all_zero` is the keyed channel of the Monte-Carlo harness — a
frame's samples are a pure function of (seed, frame index), drawn by kernel
B2 on the card.
"""

from __future__ import annotations

import math

import torch

from ..kernels.channel import awgn_philox

__all__ = [
    "MAXLLR",
    "snr_to_n0",
    "n0_to_sigma",
    "snr_to_sigma",
    "bpsk",
    "awgn",
    "awgn_all_zero",
    "llr_from_channel",
]

MAXLLR = 20.0


def snr_to_n0(snr_db, rate):
    """N0 = 10^(-SNR/10)/R (a float, or a tensor for a tensor SNR)."""
    return 10.0 ** (-snr_db / 10.0) / rate


def n0_to_sigma(n0):
    if isinstance(n0, torch.Tensor):
        return torch.sqrt(n0 / 2.0)
    return math.sqrt(n0 / 2.0)


def snr_to_sigma(snr_db, rate):
    return n0_to_sigma(snr_to_n0(snr_db, rate))


def bpsk(bits) -> torch.Tensor:
    """Bits {0,1} -> bipolar {+1,-1} int32.

    Bits are widened to int32 first (uint8 input would wrap 1-2*1 to 255).
    """
    return 1 - 2 * torch.as_tensor(bits).to(torch.int32)


def awgn(x, sigma, form: str = "multiplicative", generator=None):
    """Apply AWGN to bipolar symbols ``x`` (any shape, on x's device); f32.

    form="multiplicative": y = x*(1 + sigma*n)
    form="additive":       y = x + sigma*n
    """
    x = torch.as_tensor(x).to(torch.float32)
    n = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                    device=x.device)
    if form == "multiplicative":
        return x * (1.0 + sigma * n)
    if form == "additive":
        return x + sigma * n
    raise ValueError(f"unknown AWGN form {form!r}")


def awgn_all_zero(seed: int, frame0: int, batch: int, n: int, sigma: float,
                  device) -> torch.Tensor:
    """[batch, n] f32 channel samples of the all-(+1) word, y = 1 + σ·n,
    for frames frame0 … frame0+batch−1 (kernel B2 on CUDA, its plain twin
    on the CPU).  For a codeword x ∈ {±1}, x·y is its multiplicative
    channel output exactly."""
    return awgn_philox(seed, frame0, batch, n, sigma, device)


def llr_from_channel(y, n0, max_llr: float = MAXLLR):
    """LLR = 4*y/N0, clamped to ±max_llr."""
    return torch.clamp(4.0 * y / n0, -max_llr, max_llr)
