"""Monte-Carlo harness for non-binary GF(2^m) simulations.

Port of ``ldpcsimulation_tpu.harness.montecarlo_nb``: each all-zero symbol
is sent as its m bits over BPSK and AWGN, the symbol priors
(:func:`..channel.nb.symbol_priors`) go through FFT-QSPA
(:func:`..decoders.nb_qspa.decode_nb_qspa`), and the run counts symbol,
bit, uncoded-symbol and word errors and iterations, under the stop rule of
:mod:`.montecarlo` with its threshold on *bit* errors.

The channel follows the port's rule that a frame is a pure function of
(seed, frame index): a batch's samples are kernel B2's rows
``awgn_philox(seed, frame0, B, N·m, σ)`` reshaped to [B, N, m], where the
JAX package draws threefry ``jax.random.normal`` per batch; the two
packages agree statistically.  The port also keeps per-frame histograms
(iterations, bit and symbol errors), from which the standard errors of
its rates follow.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_n0
from ..channel.nb import symbol_priors, symbols_to_bits
from ..codes.code import Code
from ..decoders.nb_qspa import decode_nb_qspa
from .montecarlo import StopRule, default_min_word_errors
from .stream import _card_or_raise

__all__ = ["NBMCStats", "simulate_nb"]


@dataclasses.dataclass
class NBMCStats:
    """The JAX ``NBMCStats``'s counters, with the port's per-frame
    histograms: ``iteration_hist`` (frames by iterations),
    ``bit_weight_hist`` and ``symbol_weight_hist`` (erroneous frames by
    their error count w, at index w − 1)."""

    n: int
    q: int
    symbol_errors: int = 0
    bit_errors: int = 0
    uncoded_symbol_errors: int = 0
    total_symbols: int = 0
    total_bits: int = 0
    total_words: int = 0
    word_errors: int = 0
    total_iterations: int = 0
    wall_seconds: float = 0.0
    iteration_hist: Optional[np.ndarray] = None
    bit_weight_hist: Optional[np.ndarray] = None
    symbol_weight_hist: Optional[np.ndarray] = None

    def __post_init__(self):
        m = self.q.bit_length() - 1
        if self.bit_weight_hist is None:
            self.bit_weight_hist = np.zeros(self.n * m, np.int64)
        if self.symbol_weight_hist is None:
            self.symbol_weight_hist = np.zeros(self.n, np.int64)

    @property
    def ser(self) -> float:
        return (self.symbol_errors / self.total_symbols
                if self.total_symbols else 0.0)

    @property
    def ber(self) -> float:
        return self.bit_errors / self.total_bits if self.total_bits else 0.0

    @property
    def fer(self) -> float:
        return self.word_errors / self.total_words if self.total_words else 0.0

    @property
    def avg_iterations(self) -> float:
        return (self.total_iterations / self.total_words
                if self.total_words else 0.0)

    def add_frames(self, sym_errs, bit_errs, uncoded, iters) -> None:
        """Fold per-frame host arrays of one batch into the counters."""
        b = len(sym_errs)
        self.total_words += b
        self.total_symbols += b * self.n
        self.total_bits += b * self.n * (self.q.bit_length() - 1)
        self.symbol_errors += int(sym_errs.sum())
        self.bit_errors += int(bit_errs.sum())
        self.uncoded_symbol_errors += int(uncoded.sum())
        self.word_errors += int((sym_errs > 0).sum())
        self.total_iterations += int(iters.sum())
        np.add.at(self.bit_weight_hist, bit_errs[bit_errs > 0] - 1, 1)
        np.add.at(self.symbol_weight_hist, sym_errs[sym_errs > 0] - 1, 1)
        top = int(iters.max()) + 1 if b else 0
        if self.iteration_hist is None:
            self.iteration_hist = np.zeros(top, np.int64)
        elif top > len(self.iteration_hist):
            grown = np.zeros(top, np.int64)
            grown[:len(self.iteration_hist)] = self.iteration_hist
            self.iteration_hist = grown
        np.add.at(self.iteration_hist, iters, 1)


def simulate_nb(
    code: Code,
    snr_db: float,
    num_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_size: int = 128,
    seed: int = 0,
    early_termination: bool = True,
    max_batches: int = 100000,
    storage_dtype=None,
    device="cuda",
) -> NBMCStats:
    """All-zero-codeword NB Monte-Carlo at one operating point.

    The stop rule's bit-error threshold counts *bit* errors (symbol bits),
    as in the JAX package.  ``rate`` defaults to k/n; Eb/N0 counts m coded
    bits per symbol and rate·m information bits.  ``device`` defaults to
    the card; ``device="cpu"`` runs kernel B2's plain twin.  Each batch
    brings four [B] vectors to the host.
    """
    device = _card_or_raise(device, "simulate_nb")
    q = code.q
    if q < 4:
        raise ValueError("simulate_nb expects a GF(q>2) code")
    m = q.bit_length() - 1
    rate = rate if rate is not None else code.rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    n0 = float(snr_to_n0(snr_db, rate))
    sigma = float(np.sqrt(n0 / 2.0))
    code_d = code.to(device)

    stats = NBMCStats(n=code.n, q=q)
    t0 = time.perf_counter()
    batch_idx = 0
    frame0 = 0
    while not stop.done(stats.bit_errors, stats.word_errors,
                        stats.total_words):
        if batch_idx >= max_batches:
            break
        b = batch_size
        if stop.max_frames is not None:
            b = min(b, stop.max_frames - stats.total_words)
            if b <= 0:
                break
        # all-zero symbols -> all-zero bits -> +1 BPSK per bit
        y = awgn_all_zero(seed, frame0, b, code.n * m, sigma, device)
        pri = symbol_priors(y.reshape(b, code.n, m), n0, q)
        res = decode_nb_qspa(code_d, pri, num_iterations,
                             early_termination=early_termination,
                             storage_dtype=storage_dtype)
        sym_errs = (res.symbols != 0).sum(dim=1)
        bit_errs = (symbols_to_bits(res.symbols, q) != 0).sum(dim=(1, 2))
        uncoded = (torch.argmax(pri, dim=-1) != 0).sum(dim=1)
        stats.add_frames(*(t.cpu().numpy() for t in (
            sym_errs, bit_errs, uncoded, res.iterations)))
        batch_idx += 1
        frame0 += b
    stats.wall_seconds = time.perf_counter() - t0
    return stats
