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
  * The decoder gets the batch's noise coordinates
    (:class:`..decoders.base.NoiseKey`: the run seed and the batch's first
    frame), so a decoder that draws noise keys it per (seed, frame, step)
    and any frame's decode replays too.
  * The additive channel form (``awgn_form="additive"``, y = x + σn) is
    ``y₊₁ + (x − 1)`` from the same keyed draw: for the all-(+1) word the
    two forms are the same samples.
  * The bit-flip extras of the JAX ``simulate`` are surfaced when the
    result has them: the totals of ``smoothing_used`` and ``least_errors``
    and the ``phase_hist`` of the redecode phases, in ``MCStats.extra``.
  * A decoder with state across frames (NGDBFhw's ring pointer) takes a
    carry: ``decode_carry0`` is its initial value, one entry per batch
    lane, kept on the device between batches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import spans
from ..channel.awgn import awgn_all_zero, bpsk, n0_to_sigma, snr_to_n0
from ..codes.code import Code
from ..decoders.base import DecodeResult, NoiseKey
from .fixtures import cycle_indices

__all__ = [
    "AWGN_FORMS",
    "StopRule",
    "default_min_word_errors",
    "MCStats",
    "itdist_biased_sequence",
    "simulate",
]


#: decoder-family fields surfaced per frame when the result has them
_EXTRA_FIELDS = ("smoothing_used", "phases", "least_errors")
#: channel forms: y = x·(1 + σn) (the reference's C decoders) and
#: y = x + σn (the SystemC model)
AWGN_FORMS = ("multiplicative", "additive")


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
    decode_fn: Callable[[torch.Tensor, NoiseKey], DecodeResult],
    snr_db: float,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_size: int = 512,
    seed: int = 0,
    preprocess: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    codewords: Optional[np.ndarray] = None,
    awgn_form: str = "multiplicative",
    device="cuda",
    verbose: bool = False,
    report_every_batches: int = 1,
    max_batches: int = 100000,
    decode_carry0: Optional[torch.Tensor] = None,
) -> MCStats:
    """Run the Monte-Carlo loop for one operating point.

    decode_fn(inp [B, N] on ``device``, key) -> DecodeResult, with ``inp``
    the channel samples mapped by ``preprocess`` (a quantizer and/or LLR;
    identity if None) and ``key`` the batch's :class:`NoiseKey`.
    ``codewords``: optional [L, N] bit matrix cycled frame by frame (copied
    to the device once), else all-zero codewords.  ``rate`` defaults to the
    design rate k/n.  ``awgn_form``: one of :data:`AWGN_FORMS`.
    ``decode_carry0``: optional initial decoder state, a tensor with one
    entry per batch lane ([batch_size, ...]); the decoder is then
    ``decode_fn(inp, key, carry) -> (DecodeResult, carry')`` and the carry
    stays on the device from batch to batch (a short final batch takes
    ``carry[:b]`` and writes it back).
    Counting happens on the device; each batch brings four [B] vectors to
    the host (more with the bit-flip extras).  ``device`` defaults to the
    card; ``device="cpu"`` runs the kernels' plain twins.  With
    ``verbose``, an incremental report every ``report_every_batches``.
    While a profiler runs, each batch and its phases are :mod:`..spans`
    ranges.
    """
    if awgn_form not in AWGN_FORMS:
        raise ValueError(f"awgn_form {awgn_form!r} not in {AWGN_FORMS}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simulate: device 'cuda', but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    sigma = n0_to_sigma(snr_to_n0(snr_db, rate))

    if codewords is not None:
        codewords = np.asarray(codewords, np.uint8)
        if codewords.ndim != 2 or codewords.shape[1] != code.n:
            raise ValueError(f"codewords must be [L, {code.n}]")
        num_words = codewords.shape[0]
        codewords = torch.tensor(codewords, device=device)  # once

    stats = MCStats(n=code.n)
    t0 = time.perf_counter()
    batch_idx = 0
    frame_offset = 0
    carry = decode_carry0
    while not stop.done(stats.errors, stats.word_errors, stats.total_words):
        with spans.span(spans.BATCH):
            if batch_idx >= max_batches:
                break
            b = batch_size
            if stop.max_frames is not None:
                b = min(b, stop.max_frames - stats.total_words)
                if b <= 0:
                    break
            with spans.span(spans.CHANNEL):
                y = awgn_all_zero(seed, frame_offset, b, code.n, sigma,
                                  device)
                if codewords is not None:
                    idx = cycle_indices(frame_offset, b, num_words)
                    c = bpsk(codewords[torch.as_tensor(idx, device=device)])
                    y = (c * y if awgn_form == "multiplicative"
                         else y + (c - 1.0))
                else:
                    c = 1
                inp = preprocess(y) if preprocess is not None else y
            key = NoiseKey(seed, frame_offset)
            with spans.span(spans.DECODE):
                if carry is None:
                    res = decode_fn(inp, key)
                elif b == batch_size:
                    res, carry = decode_fn(inp, key, carry)
                else:
                    res, tail = decode_fn(inp, key, carry[:b])
                    carry = torch.cat([tail, carry[b:]])
            with spans.span(spans.COUNT):
                frame_errs = (res.hard != c).sum(dim=1)
                uncoded = ((y > 0) != (c > 0)).sum(dim=1)
            with spans.span(spans.TO_HOST):
                frame_errs, uncoded, iters, satisfied = (
                    t.cpu().numpy() for t in
                    (frame_errs, uncoded, res.iterations, res.satisfied)
                )
                extras = {
                    k: getattr(res, k).cpu().numpy()
                    for k in _EXTRA_FIELDS if hasattr(res, k)
                }
            with spans.span(spans.TALLY):
                _tally(stats, b, code.n, frame_errs, uncoded, iters,
                       satisfied, extras)
                batch_idx += 1
                frame_offset += b
                if verbose and batch_idx % report_every_batches == 0:
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


def _tally(stats: MCStats, b: int, n: int, frame_errs, uncoded, iters,
           satisfied, extras: dict) -> None:
    """Fold one batch's host vectors (per frame: bit errors, uncoded
    errors, iterations, satisfied flag, and the bit-flip extras) into
    ``stats``."""
    stats.total_words += b
    stats.total_bits += b * n
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

    # bit-flip extras: totals + phase histogram (RNGDBF phase_hist)
    if "smoothing_used" in extras:
        stats.extra["smoothing_used"] = stats.extra.get(
            "smoothing_used", 0
        ) + int(extras["smoothing_used"].sum())
    if "phases" in extras:
        ph = extras["phases"]
        hist = stats.extra.get("phase_hist")
        width = max(int(ph.max()), len(hist) if hist is not None else 0)
        grown = np.zeros(width, np.int64)
        if hist is not None:
            grown[: len(hist)] += hist
        np.add.at(grown, ph - 1, 1)
        stats.extra["phase_hist"] = grown
    if "least_errors" in extras:
        stats.extra["least_errors_sum"] = stats.extra.get(
            "least_errors_sum", 0
        ) + int(extras["least_errors"].sum())
