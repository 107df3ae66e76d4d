"""Tab-delimited result-log rows, column-compatible with the reference.

Every reference simulator appends one row per run to a shared log file; sweep
scripts across processes merge by appending to the same file.  Column layouts
(verified against the sources):

  * BP   (``decodeBP.cpp:264-272``):
        SNR  BER  avgIters  WER  T  alistfile
  * MinSum (``decodeMinSum.cpp:313-329``):
        SNR  BER  avgIters  WER  T  [Ymax]  [alpha]  [delta]  alistfile
    (Ymax present for the quantized variants; alpha for normalized;
    delta for offset.)
  * GDBF family (``decodeGDBF.cpp:425-452``):
        SNR  BER  avgIters  WER  totalBits  totalWords  T  theta
        [noiseScale]  [NQ]  [lambda]  [alpha]
        [smoothingUsed  smoothingRatio  windowsize]  [Ymax]  alistfile
    (bracketed fields present iff the corresponding feature is enabled,
    in this order — matching the reference's #ifdef emission order.)
  * NGDBFhw (``NGDBFhw.cpp:452-462``):
        SNR  errors  wordErrors  BER  avgIters  WER  totalBits  totalWords
        T  theta0  noiseScale  w  Ymax  NQ  maxPhases  seed

Numbers are formatted like C++ ``cout << double`` (6 significant digits) so
existing plotting pipelines parse identically.
"""

from __future__ import annotations

from typing import List, Optional

from .montecarlo import MCStats

__all__ = [
    "fmt",
    "bp_log_row",
    "minsum_log_row",
    "gdbf_log_row",
    "ngdbfhw_log_row",
    "append_row",
]


def fmt(x) -> str:
    """C++ default ostream formatting: 6 significant digits."""
    if isinstance(x, bool):
        return str(int(x))
    if isinstance(x, int):
        return str(x)
    return f"{x:.6g}"


def _join(parts: List) -> str:
    return "\t".join(fmt(p) for p in parts)


def bp_log_row(snr_db, stats: MCStats, num_iterations: int, alist_name: str) -> str:
    return _join(
        [snr_db, stats.ber, stats.avg_iterations, stats.fer, num_iterations]
    ) + f"\t{alist_name}"


def minsum_log_row(
    snr_db,
    stats: MCStats,
    num_iterations: int,
    alist_name: str,
    ymax: Optional[float] = None,
    alpha: Optional[float] = None,
    delta: Optional[float] = None,
) -> str:
    parts = [snr_db, stats.ber, stats.avg_iterations, stats.fer, num_iterations]
    if ymax is not None:
        parts.append(ymax)
    if alpha is not None:
        parts.append(alpha)
    if delta is not None:
        parts.append(delta)
    return _join(parts) + f"\t{alist_name}"


def gdbf_log_row(
    snr_db,
    stats: MCStats,
    num_iterations: int,
    theta: float,
    alist_name: str,
    noise_scale: Optional[float] = None,
    nq: Optional[int] = None,
    lam: Optional[float] = None,
    alpha: Optional[float] = None,
    smoothing_used: Optional[int] = None,
    window_size: Optional[int] = None,
    ymax: Optional[float] = None,
) -> str:
    parts = [
        snr_db,
        stats.ber,
        stats.avg_iterations,
        stats.fer,
        stats.total_bits,
        stats.total_words,
        num_iterations,
        theta,
    ]
    if noise_scale is not None:
        parts.append(noise_scale)
    if nq is not None:
        parts.append(nq)
    if lam is not None:
        parts.append(lam)
    if alpha is not None:
        parts.append(alpha)
    if smoothing_used is not None:
        parts += [
            smoothing_used,
            smoothing_used / stats.total_words if stats.total_words else 0.0,
            window_size,
        ]
    if ymax is not None:
        parts.append(ymax)
    return _join(parts) + f"\t{alist_name}"


def ngdbfhw_log_row(
    snr_db,
    stats: MCStats,
    num_iterations: int,
    theta0: float,
    noise_scale: float,
    w: float,
    ymax: float,
    nq: int,
    max_phases: int,
    seed: int,
) -> str:
    return _join(
        [
            snr_db,
            stats.errors,
            stats.word_errors,
            stats.ber,
            stats.avg_iterations,
            stats.fer,
            stats.total_bits,
            stats.total_words,
            num_iterations,
            theta0,
            noise_scale,
            w,
            ymax,
            nq,
            max_phases,
            seed,
        ]
    )


def append_row(path: str, row: str) -> None:
    """Append-only shared log semantics (ios::app), one row per run."""
    with open(path, "a") as f:
        f.write(row + "\n")
