"""The measured window: a stop rule that stamps the host clock between
batches, and the batches kept for the output check.

The program's loop (``harness.montecarlo.simulate``, or the grid engine's
``parallel.montecarlo.simulate_grid``) calls ``stop.done(...)`` between
batches, after each batch's counts have reached the host.  :class:`Window`
is that stop rule: it records the time and the running totals at every
call, ends the run once its length has passed (or after a fixed number of
frames, where every rank must decide alike), and starts and stops the
profiler of a traced run at given batch indices and marks each traced
batch.  :class:`Keeper` wraps
the decoder and copies the outputs of the batches drawn for the check to
the host.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ldpcsimulation_tpu_torch.harness.montecarlo import StopRule


class Window(StopRule):
    """Stop rule of the measured window.

    ``seconds``: end at the first call at or past that length (measured
    from the window's start); or ``frames``: end once a point has that many
    frames (the grid's fixed round count, which every rank decides alike).
    ``points``: how many ``done`` calls one batch makes (the grid engine
    calls once per operating point; ``simulate`` once, and once more before
    its first batch).  ``trace``: optional ``(first, count, tracer)``:
    ``tracer.start()`` before batch ``first``, ``tracer.next()`` between
    the traced batches, ``tracer.stop()`` after batch ``first + count −
    1``; a timed window stays open until then, and until it has run
    ``min_batches`` batches (the batches drawn for the check).
    """

    def __init__(self, seconds: Optional[float] = None,
                 frames: Optional[int] = None, points: int = 1, trace=None,
                 min_batches: int = 0):
        super().__init__(min_bit_errors=0, min_word_errors=0,
                         max_frames=None)
        self.seconds, self.frames = seconds, frames
        if trace is not None:
            min_batches = max(min_batches, trace[0] + trace[1])
        self.min_batches = min_batches
        self.points = points
        self.trace = trace
        self.stamps: list = []  # the host clock at every batch boundary
        self.totals: list = []  # (errors, word errors, frames) per call

    def start(self) -> None:
        """Mark the window's start, for a loop that makes no call before
        its first batch (the grid engine)."""
        self.totals += [(0, 0, 0)] * self.points
        self._boundary()

    def _boundary(self) -> None:
        self.stamps.append(time.perf_counter())
        if self.trace is not None:
            first, count, tracer = self.trace
            if self.batches == first:
                tracer.start()
            elif first < self.batches < first + count:
                tracer.next()
            elif self.batches == first + count:
                tracer.stop()

    def done(self, errors: int, word_errors: int, total_words: int) -> bool:
        if len(self.totals) % self.points == 0:
            self._boundary()
        self.totals.append((errors, word_errors, total_words))
        if self.frames is not None:
            return total_words >= self.frames
        return (self.batches >= self.min_batches and
                time.perf_counter() - self.stamps[0] >= self.seconds)

    # -- readings over the window --------------------------------------
    @property
    def batches(self) -> int:
        """Batches completed (boundaries after the start)."""
        return len(self.stamps) - 1

    @property
    def seconds_measured(self) -> float:
        return self.stamps[-1] - self.stamps[0]

    def batch_ms(self) -> np.ndarray:
        return np.diff(np.asarray(self.stamps)) * 1e3

    def counts_of(self, batch: int, point: int = 0):
        """(bit errors, word errors) the program reported for batch
        ``batch`` of point ``point``: the step of its running totals."""
        p = self.points
        after = self.totals[(batch + 1) * p + point]
        before = self.totals[batch * p + point]
        return after[0] - before[0], after[1] - before[1]


class Keeper:
    """Wraps a decoder: the outputs of the batches whose call index is in
    ``keep`` go to the host (the decoder's input, hard decisions,
    iterations, satisfied flags, and the first frame's index)."""

    def __init__(self, decode, keep, frame0_of):
        self.decode, self.keep = decode, set(keep)
        self.frame0_of = frame0_of
        self.calls = 0
        self.kept: dict = {}

    def __call__(self, inp, *args):
        res = self.decode(inp, *args)
        if self.calls in self.keep:
            self.kept[self.calls] = dict(
                inp=inp.cpu(), hard=res.hard.cpu(),
                iterations=res.iterations.cpu(),
                satisfied=res.satisfied.cpu(),
                frame0=self.frame0_of(*args))
        self.calls += 1
        return res


def draw_batches(seed: int, below: int, count: int) -> list:
    """``count`` batch indices drawn from the seed among batches 1 to
    ``below`` − 1 (batch 1 alone where there are none): never batch 0,
    whose frames a loop that failed to move on would decode again in
    every batch."""
    pool = range(1, max(2, below))
    rng = np.random.default_rng(seed)
    take = rng.choice(len(pool), size=min(count, len(pool)), replace=False)
    return sorted(pool[i] for i in take)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
