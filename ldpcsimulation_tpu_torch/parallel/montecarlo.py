"""Mesh-parallel Monte-Carlo drivers: many operating points, many slots.

Port of ``ldpcsimulation_tpu.parallel.montecarlo``.  The drivers run the
steps of :mod:`.mesh` until every operating point satisfies the reference
stopping rule (errors >= A and word errors >= B, on the all-reduced global
counters), building one :class:`..harness.MCStats` per point.  Every rank
holds the same all-reduced totals, so every rank makes the same stop
decision with no broadcast.

Each point numbers its own frames 0, 1, 2, … (:mod:`.mesh`'s frame
keying): a slot that serves point p in a round takes p's next B_global
frames, so points share frames across SNRs, as the single-device sweep
does, and a point's counters equal ``simulate``'s over the same frames.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import spans
from ..channel.awgn import snr_to_sigma
from ..codes.code import Code
from ..harness.montecarlo import MCStats, StopRule, default_min_word_errors
from .mesh import (
    local_cuda_devices,
    make_counters_step,
    make_grid_step,
    make_mesh,
)

__all__ = [
    "simulate_distributed",
    "simulate_grid",
    "measure_scaling_efficiency",
]


def _accumulate(s: MCStats, out: dict, i: int, batch_global: int,
                bits_global: int) -> None:
    """Fold slot ``i`` of one step's all-reduced counters into ``s``."""
    s.errors += int(out["errors"][i])
    s.uncoded_errors += int(out["uncoded_errors"][i])
    s.word_errors += int(out["word_errors"][i])
    # frame and bit totals are the step's, summed on the host
    s.total_words += batch_global
    s.total_bits += bits_global
    s.total_iterations += int(out["iteration_sum"][i])
    s.satisfied_words += int(out["satisfied_words"][i])
    # hist[0] of the step's error-weight histogram counts error-free frames;
    # the MCStats histogram indexes weight w at w − 1
    s.error_weight_hist += out["error_weight_hist"][i][1:]
    s.iteration_hist += out["iteration_hist"][i]
    if "smoothing_used" in out:
        s.extra["smoothing_used"] = s.extra.get("smoothing_used", 0) + int(
            out["smoothing_used"][i]
        )


def _new_stats(code: Code, count: int, max_iterations: int) -> list:
    stats = [MCStats(n=code.n) for _ in range(count)]
    for s in stats:
        s.iteration_hist = np.zeros(max_iterations + 1, np.int64)
    return stats


def simulate_grid(
    code: Code,
    decode_fn: Callable,
    points: Sequence[dict],
    mesh,
    max_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_per_device: int = 512,
    seed: int = 0,
    preprocess: Optional[Callable] = None,
    param_names: Sequence[str] = (),
    max_rounds: int = 100000,
    verbose: bool = False,
    codewords=None,
) -> List[MCStats]:
    """Run an operating-point grid over the mesh's snr slots.

    The replacement for the reference's one-process-per-parameter bash
    fan-out (``mngdbf_example_PEGReg504x1008.sh:44-59``): the cartesian
    grid is scheduled in rounds of S points (S = the mesh "snr" axis size)
    with per-point stopping.

    points: dicts with key "snr" plus every name in ``param_names``.
    decode_fn(y [b, N], sigma, key, point) with ``point`` a dict of f32
    floats; preprocess(y, point) if given.

    Scheduling: each round fills the S slots by cycling the unfinished
    points (a point may take several slots, each with its next B_global
    frames).  Points leave the rotation when the stop rule passes on their
    own totals.  Returns one MCStats per point (wall_seconds is the shared
    grid time).  While a profiler runs, each round (before its stop checks)
    and its tally are :mod:`..spans` ranges.
    """
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    if max_iterations <= 0:
        raise ValueError("max_iterations must bound the decoder's T")
    param_names = tuple(param_names)
    for p in points:
        missing = {"snr", *param_names} - set(p)
        if missing:
            raise ValueError(f"grid point {p} missing {sorted(missing)}")
    step = make_grid_step(
        code, decode_fn, mesh, batch_per_device=batch_per_device,
        max_iterations=max_iterations, param_names=param_names,
        preprocess=preprocess, codewords=codewords,
    )
    n_slots = mesh.n_snr
    sigma_of = [snr_to_sigma(p["snr"], rate) for p in points]
    stats = _new_stats(code, len(points), max_iterations)
    next_frame = [0] * len(points)
    pending = list(range(len(points)))
    t0 = time.perf_counter()
    for round_idx in range(max_rounds):
        if not pending:
            break
        with spans.span(spans.GRID_ROUND):
            # fill the S slots by cycling the unfinished points
            slots = [pending[i % len(pending)] for i in range(n_slots)]
            frame0s = []
            for pi in slots:
                frame0s.append(next_frame[pi])
                next_frame[pi] += step.batch_global
            out = step(
                seed, [sigma_of[i] for i in slots],
                {nm: [points[i][nm] for i in slots] for nm in param_names},
                frame0s,
            )
            with spans.span(spans.GRID_TALLY):
                for slot, pi in enumerate(slots):
                    _accumulate(stats[pi], out, slot, step.batch_global,
                                step.bits_global)
        pending = [
            i for i in pending
            if not stop.done(stats[i].errors, stats[i].word_errors,
                             stats[i].total_words)
        ]
        if verbose:
            print(
                f"round {round_idx}: {len(points) - len(pending)}/"
                f"{len(points)} points done"
            )
    dt = time.perf_counter() - t0
    for s in stats:
        s.wall_seconds = dt
    return stats


def simulate_distributed(
    code: Code,
    decode_fn: Callable,
    snrs_db: Sequence[float],
    mesh,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    batch_per_device: int = 512,
    max_iterations: int = 0,
    seed: int = 0,
    preprocess: Optional[Callable] = None,
    max_batches: int = 100000,
    verbose: bool = False,
    codewords=None,
) -> List[MCStats]:
    """Run all SNR points of a sweep at once on the mesh.

    decode_fn(samples [b, N], sigma, key) -> DecodeResult-like.
    len(snrs_db) must equal the mesh "snr" axis size.  Round r decodes
    frames r·B_global … (r+1)·B_global − 1 of every point; converged points
    keep decoding until the last one finishes.  Returns one MCStats per SNR
    point (wall_seconds is the shared sweep time).  ``codewords``: an
    optional [L, N] bit fixture, cycled by frame index.
    """
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    if max_iterations <= 0:
        raise ValueError("max_iterations must bound the decoder's T")
    step = make_counters_step(
        code, decode_fn, mesh,
        sigmas=[snr_to_sigma(s, rate) for s in snrs_db],
        batch_per_device=batch_per_device, max_iterations=max_iterations,
        preprocess=preprocess, codewords=codewords,
    )
    stats = _new_stats(code, len(snrs_db), max_iterations)
    t0 = time.perf_counter()
    for batch_idx in range(max_batches):
        if all(stop.done(s.errors, s.word_errors, s.total_words)
               for s in stats):
            break
        out = step(seed, batch_idx)
        for i, s in enumerate(stats):
            _accumulate(s, out, i, step.batch_global, step.bits_global)
        if verbose:
            line = " ".join(
                f"{snrs_db[i]}dB:{stats[i].ber:.3g}"
                for i in range(len(stats))
            )
            print(f"batch {batch_idx}: BER {line}")
    dt = time.perf_counter() - t0
    for s in stats:
        s.wall_seconds = dt
    return stats


def measure_scaling_efficiency(
    code: Code,
    decode_fn: Callable,
    snr_db: float,
    device_counts: Sequence[int],
    batch_per_device: int = 512,
    max_iterations: int = 10,
    rate: Optional[float] = None,
    repeats: int = 5,
) -> dict:
    """Decoded info bits/s against the number of devices.

    Each count takes the first ``nd`` of this rank's CUDA devices, one slot
    each — slots that share a card are not devices, so one H100 measures
    ``device_counts=[1]``.  Returns {devices: bits_per_second}; the
    efficiency at n is (T_n / n) / T_1.
    """
    rate = code.rate if rate is None else rate
    sigma = snr_to_sigma(snr_db, rate)
    pool = local_cuda_devices()
    results = {}
    for nd in device_counts:
        if nd > len(pool):
            raise ValueError(f"{nd} devices asked, {len(pool)} distinct "
                             "devices available")
        mesh = make_mesh(n_snr=1, devices=pool[:nd])
        step = make_counters_step(
            code, decode_fn, mesh, sigmas=[sigma],
            batch_per_device=batch_per_device,
            max_iterations=max_iterations,
        )
        step(0)  # warm-up
        t0 = time.perf_counter()
        for i in range(repeats):
            step(0, i)  # each step ends in its host copy
        dt = (time.perf_counter() - t0) / repeats
        results[nd] = step.batch_global * code.k / dt
    return results
