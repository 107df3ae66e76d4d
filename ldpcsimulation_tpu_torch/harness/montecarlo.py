"""Batched Monte-Carlo BER/FER harness.

Port of ``ldpcsimulation_tpu.harness.montecarlo`` (which cites the
reference's per-frame ``main()`` loops): frame generation, AWGN, decode,
error counting, adaptive stopping, statistics, incremental reports.

  * Frames run in batches; the stopping rule (``errors >= min_bit_errors
    AND word_errors >= min_word_errors``, or ``max_frames``) is checked
    between batches.
  * Frame ``f`` (global index) draws its noise from (seed, f) through
    :func:`..channel.awgn.awgn_all_zero`, so any frame replays from its
    coordinates, whatever the batch size.
  * Codeword fixtures are cycled by index; with codeword x ∈ {±1} the
    channel output is x · y₊₁ (exact), so one keyed channel serves both.

The decoder-state carry (``decode_carry0``) and the bit-flip extras of the
JAX ``simulate`` are not here: they come with their decoders (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, bpsk, n0_to_sigma, snr_to_n0
from ..codes.code import Code
from ..decoders.base import DecodeResult
from .fixtures import cycle_indices

__all__ = [
    "StopRule",
    "default_min_word_errors",
    "MCStats",
    "itdist_biased_sequence",
    "simulate",
]


def default_min_word_errors(n: int) -> int:
    """N-dependent schedule from decodeGDBF.cpp:221-226: 20 / 10 / 5."""
    if n > 50000:
        return 5
    if n > 10000:
        return 10
    return 20


@dataclasses.dataclass
class StopRule:
    """Run until (errors >= min_bit_errors AND word_errors >= min_word_errors)
    or total frames reach ``max_frames`` (if set)."""

    min_bit_errors: int = 200
    min_word_errors: int = 20
    max_frames: Optional[int] = None

    @classmethod
    def fixed_frames(cls, nf: int) -> "StopRule":
        return cls(min_bit_errors=0, min_word_errors=0, max_frames=nf)

    def done(self, errors: int, word_errors: int, total_words: int) -> bool:
        if self.max_frames is not None and total_words >= self.max_frames:
            return True
        if self.min_bit_errors == 0 and self.min_word_errors == 0:
            # fixed-frame-count mode: only max_frames stops the run
            return False
        return (
            errors >= self.min_bit_errors
            and word_errors >= self.min_word_errors
        )


@dataclasses.dataclass
class MCStats:
    """Accumulated statistics, mirroring the reference's counters."""

    n: int
    errors: int = 0
    uncoded_errors: int = 0
    total_bits: int = 0
    total_words: int = 0
    word_errors: int = 0
    total_iterations: int = 0
    error_weight_hist: Optional[np.ndarray] = None  # [N] counts, weight w at [w-1]
    iteration_hist: Optional[np.ndarray] = None  # counts by iterations used
    satisfied_words: int = 0
    wall_seconds: float = 0.0
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.error_weight_hist is None:
            self.error_weight_hist = np.zeros(self.n, dtype=np.int64)

    @property
    def ber(self) -> float:
        return self.errors / self.total_bits if self.total_bits else 0.0

    @property
    def fer(self) -> float:
        return self.word_errors / self.total_words if self.total_words else 0.0

    @property
    def uncoded_ber(self) -> float:
        return self.uncoded_errors / self.total_bits if self.total_bits else 0.0

    @property
    def avg_iterations(self) -> float:
        return (
            self.total_iterations / self.total_words if self.total_words else 0.0
        )

    def iteration_cdf(self) -> np.ndarray:
        """itdist[idx] = fraction of frames whose decode used >= idx
        iterations (NGDBFhw.cpp:419-421, 464-469)."""
        if self.iteration_hist is None or self.total_words == 0:
            return np.zeros(0)
        tail = self.iteration_hist[::-1].cumsum()[::-1]
        return tail / self.total_words

    def iteration_cdf_biased(self, seed: int = 0) -> np.ndarray:
        """The reference's own running-mean itdist estimator, bias included
        (``NGDBFhw.cpp:419-421``), replayed over a deterministic shuffle
        (``seed``) of this run's per-frame iteration counts — see the JAX
        package's docstring for the derivation."""
        if self.iteration_hist is None or self.total_words == 0:
            return np.zeros(0)
        counts = np.asarray(self.iteration_hist, np.int64)
        ls = np.repeat(np.arange(len(counts)), counts)
        ls = np.random.default_rng(seed).permutation(ls)
        return itdist_biased_sequence(ls, len(counts))

    def incremental_report(self) -> str:
        """Reference-style console line (decodeMinSum.cpp:291-297)."""
        lines = [
            f"Incremental result: {self.errors} bit errs in {self.total_words}"
            f" words, BER={self.ber:.6g}. Average iterations = "
            f"{self.avg_iterations:.6g}. Word error={self.word_errors}."
            f" Uncoded errors = {self.uncoded_errors},"
            f" uncBER={self.uncoded_ber:.6g}",
            "Error weights:",
        ]
        for w in np.flatnonzero(self.error_weight_hist):
            lines.append(f"{w + 1}:\t{self.error_weight_hist[w]}")
        return "\n".join(lines)


def itdist_biased_sequence(ls, length: int) -> np.ndarray:
    """The reference's itdist recurrence over an explicit frame sequence
    (``NGDBFhw.cpp:419-421``): after the ``w``-th frame with completion
    time ``L``, ``itdist[idx] = ((w-1)/w)·itdist[idx] + 1/w`` for
    ``idx <= L`` only."""
    itdist = np.zeros(length, np.float64)
    for w, l in enumerate(ls, 1):
        itdist[: l + 1] = ((w - 1.0) / w) * itdist[: l + 1] + 1.0 / w
    return itdist


def simulate(
    code: Code,
    decode_fn: Callable[[torch.Tensor], DecodeResult],
    snr_db: float,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_size: int = 512,
    seed: int = 0,
    codewords: Optional[np.ndarray] = None,
    device="cpu",
    verbose: bool = False,
    max_batches: int = 100000,
) -> MCStats:
    """Run the Monte-Carlo loop for one operating point.

    decode_fn(samples [B, N] f32 on ``device``) -> DecodeResult.
    ``codewords``: optional [L, N] bit matrix cycled frame by frame, else
    all-zero codewords.  ``rate`` defaults to the design rate k/n.
    Counting happens on the device; each batch brings four [B] vectors to
    the host.
    """
    device = torch.device(device)
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    sigma = n0_to_sigma(snr_to_n0(snr_db, rate))

    if codewords is not None:
        codewords = np.asarray(codewords, np.uint8)
        if codewords.ndim != 2 or codewords.shape[1] != code.n:
            raise ValueError(f"codewords must be [L, {code.n}]")

    stats = MCStats(n=code.n)
    t0 = time.perf_counter()
    batch_idx = 0
    frame_offset = 0
    while not stop.done(stats.errors, stats.word_errors, stats.total_words):
        if batch_idx >= max_batches:
            break
        b = batch_size
        if stop.max_frames is not None:
            b = min(b, stop.max_frames - stats.total_words)
            if b <= 0:
                break
        y = awgn_all_zero(seed, frame_offset, b, code.n, sigma, device)
        if codewords is not None:
            idx = cycle_indices(frame_offset, b, codewords.shape[0])
            c = bpsk(codewords[idx]).to(device)  # [B, N] ±1
            y = c * y
        else:
            c = 1
        res = decode_fn(y)
        frame_errs = (res.hard != c).sum(dim=1)
        uncoded = ((y > 0) != (c > 0)).sum(dim=1)
        frame_errs, uncoded, iters, satisfied = (
            t.cpu().numpy()
            for t in (frame_errs, uncoded, res.iterations, res.satisfied)
        )

        stats.total_words += b
        stats.total_bits += b * code.n
        stats.errors += int(frame_errs.sum())
        stats.uncoded_errors += int(uncoded.sum())
        stats.word_errors += int((frame_errs > 0).sum())
        stats.total_iterations += int(iters.sum())
        stats.satisfied_words += int(satisfied.sum())
        werr = frame_errs[frame_errs > 0]
        if werr.size:
            np.add.at(stats.error_weight_hist, werr - 1, 1)
        if stats.iteration_hist is None:
            stats.iteration_hist = np.zeros(int(iters.max()) + 1, np.int64)
        elif int(iters.max()) >= stats.iteration_hist.size:
            grown = np.zeros(int(iters.max()) + 1, np.int64)
            grown[: stats.iteration_hist.size] = stats.iteration_hist
            stats.iteration_hist = grown
        np.add.at(stats.iteration_hist, iters, 1)

        batch_idx += 1
        frame_offset += b
        if verbose:
            print(stats.incremental_report())

    stats.wall_seconds = time.perf_counter() - t0
    if verbose:
        print(
            f"Final result: {stats.errors} bit errs in {stats.total_words} "
            f"words, BER={stats.ber:.6g}. Average iterations = "
            f"{stats.avg_iterations:.6g}. Uncoded errors = "
            f"{stats.uncoded_errors}, uncBER={stats.uncoded_ber:.6g}"
        )
    return stats
