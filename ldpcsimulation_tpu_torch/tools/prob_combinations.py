"""Enumerate flip probabilities realizable from combined Bernoulli streams.

A copy of ``ldpcsimulation_tpu.tools.prob_combinations`` (pure Python).
Reference counterpart: ``C_implementations/prob_combinations.m`` — the
offline MATLAB tool that enumerated which probabilities are realizable by
AND/OR-combining independent Bernoulli(1/2^k) hardware bit streams; its
output is the 8-level ``pr_levels`` table hard-coded in the stochastic
NGDBF decoder (``decodeGDBF.cpp:564-575``), and
:data:`..decoders.gdbf.PR_LEVELS` here.

Streams: each primitive stream ANDs k fair bits → p = 1/2^k.  Combining:
AND of streams multiplies probabilities; OR gives p1+p2−p1·p2.
"""

from __future__ import annotations

import itertools
from typing import List, Set, Tuple

__all__ = ["enumerate_probabilities", "nearest_levels"]


def enumerate_probabilities(
    max_bits: int = 4, max_ops: int = 2
) -> List[float]:
    """All probabilities reachable with AND/OR over primitive 1/2^k streams
    (k <= max_bits), up to ``max_ops`` combining operations.  Sorted."""
    prims: Set[float] = {1.0 / 2 ** k for k in range(0, max_bits + 1)}
    levels: Set[float] = set(prims) | {0.0}
    frontier = set(prims)
    for _ in range(max_ops):
        new: Set[float] = set()
        for a, b in itertools.product(frontier | prims, prims):
            new.add(a * b)  # AND
            new.add(a + b - a * b)  # OR
        frontier = new - levels
        levels |= new
    return sorted(round(p, 6) for p in levels)


def nearest_levels(
    targets: List[float], levels: List[float]
) -> List[Tuple[float, float]]:
    """Snap each target to the nearest realizable level (squared distance,
    first minimum wins — the decoder's rule, decodeGDBF.cpp:576-589)."""
    out = []
    for t in targets:
        best = levels[0]
        bestd = 1.0
        for lv in levels:
            d = (lv - t) ** 2
            if d < bestd:
                bestd = d
                best = lv
        out.append((t, best))
    return out
