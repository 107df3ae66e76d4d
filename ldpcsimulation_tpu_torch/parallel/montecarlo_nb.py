"""Mesh-parallel Monte-Carlo for non-binary GF(q) codes.

Port of ``ldpcsimulation_tpu.parallel.montecarlo_nb``: the (snr × data)
mesh of :mod:`.mesh` runs FFT-QSPA decoding of all-zero codewords and sums
symbol, bit, uncoded-symbol and word errors, words and iterations over the
slots and the ranks.  A slot's channel rows are kernel B2's, as
:func:`..harness.montecarlo_nb.simulate_nb` draws them: frame f of the
point is ``awgn_philox(seed, f, ·, N·m, σ)`` reshaped to [N, m], and data
slot di of round r decodes frames ``r·B_global + di·bpd`` onwards, so a
point's counters equal ``simulate_nb(batch_size=B_global)``'s over the same
frames (σ and N0 in double, as ``simulate_nb`` takes them).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_n0
from ..channel.nb import symbol_priors, symbols_to_bits
from ..codes.code import Code
from ..decoders.nb_qspa import decode_nb_qspa
from ..harness.montecarlo import StopRule, default_min_word_errors
from ..harness.montecarlo_nb import NBMCStats
from .mesh import all_reduce_sum

__all__ = ["make_nb_counters_step", "simulate_nb_distributed"]

#: the step's counters, in their column order
_KEYS = ("symbol_errors", "bit_errors", "uncoded_symbol_errors",
         "word_errors", "words", "iteration_sum")


def make_nb_counters_step(
    code: Code,
    mesh,
    sigmas: Sequence[float],
    n0s: Sequence[float],
    num_iterations: int,
    batch_per_device: int,
    early_termination: bool = True,
    storage_dtype=None,
):
    """The distributed NB Monte-Carlo step.

    Returns step(seed, round_idx=0) -> dict of [n_snr] int64 counters
    summed over the data slots and the ranks (one all-reduce, one host
    copy)."""
    n_snr, n_data = mesh.n_snr, mesh.n_data
    if len(sigmas) != n_snr:
        raise ValueError(f"need {n_snr} sigmas for the snr axis")
    q = code.q
    m_bits = q.bit_length() - 1
    b = batch_per_device
    local = mesh.local()
    codes = {}
    for _, _, dev in local:  # the code's tables once per device
        if dev not in codes:
            codes[dev] = code.to(dev)

    def run_slot(seed, f0, sigma, n0, device):
        y = awgn_all_zero(seed, f0, b, code.n * m_bits, sigma, device)
        pri = symbol_priors(y.reshape(b, code.n, m_bits), n0, q)
        res = decode_nb_qspa(codes[device], pri, num_iterations,
                             early_termination=early_termination,
                             storage_dtype=storage_dtype)
        sym_errs = (res.symbols != 0).sum(dim=1)
        parts = [
            sym_errs.sum(),
            (symbols_to_bits(res.symbols, q) != 0).sum(),
            (torch.argmax(pri, dim=-1) != 0).sum(),
            (sym_errs > 0).sum(),
            torch.full((), b, device=device),
            res.iterations.sum(),
        ]
        return torch.stack([p.to(torch.int64) for p in parts])

    def step(seed: int, round_idx: int = 0) -> dict:
        f0 = round_idx * b * n_data
        rows = [(si, run_slot(seed, f0 + di * b, sigmas[si], n0s[si], dev))
                for si, di, dev in local]
        total = torch.zeros((n_snr, len(_KEYS)), dtype=torch.int64,
                            device=mesh.home)
        for si, v in rows:
            total[si] += v.to(mesh.home)
        flat = all_reduce_sum(total).cpu().numpy()
        return {k: flat[:, i] for i, k in enumerate(_KEYS)}

    step.batch_global = b * n_data
    step.n_snr = n_snr
    return step


def simulate_nb_distributed(
    code: Code,
    snrs_db: Sequence[float],
    mesh,
    num_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_per_device: int = 64,
    seed: int = 0,
    early_termination: bool = True,
    max_batches: int = 100000,
    storage_dtype=None,
) -> List[NBMCStats]:
    """All SNR points of an NB sweep at once on the mesh (len(snrs_db) =
    the mesh "snr" axis size); the stop rule's bit-error threshold counts
    bit errors, as in :func:`..harness.montecarlo_nb.simulate_nb`."""
    q = code.q
    if q < 4:
        raise ValueError("simulate_nb_distributed expects a GF(q>2) code")
    m_bits = q.bit_length() - 1
    rate = rate if rate is not None else code.rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    n0s = [float(snr_to_n0(s, rate)) for s in snrs_db]
    sigmas = [float(np.sqrt(v / 2.0)) for v in n0s]
    step = make_nb_counters_step(
        code, mesh, sigmas=sigmas, n0s=n0s, num_iterations=num_iterations,
        batch_per_device=batch_per_device,
        early_termination=early_termination, storage_dtype=storage_dtype,
    )
    stats = [NBMCStats(n=code.n, q=q) for _ in snrs_db]
    t0 = time.perf_counter()
    for batch_idx in range(max_batches):
        if all(stop.done(s.bit_errors, s.word_errors, s.total_words)
               for s in stats):
            break
        out = step(seed, batch_idx)
        for i, s in enumerate(stats):
            words = int(out["words"][i])
            s.symbol_errors += int(out["symbol_errors"][i])
            s.bit_errors += int(out["bit_errors"][i])
            s.uncoded_symbol_errors += int(out["uncoded_symbol_errors"][i])
            s.word_errors += int(out["word_errors"][i])
            s.total_words += words
            s.total_symbols += words * code.n
            s.total_bits += words * code.n * m_bits
            s.total_iterations += int(out["iteration_sum"][i])
    dt = time.perf_counter() - t0
    for s in stats:
        s.wall_seconds = dt
    return stats
