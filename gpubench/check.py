"""The output check that decides ``correct``.

The program's outputs for the batches drawn from the seed (the decoder's
input, every frame's hard decisions, iterations and satisfied flag, and the
bit and word errors the program counted for the batch) are held against
the plain reference of the same frames, computed afresh from the seed.
Three numbers, each with the limit the configuration states:

* ``chan_max_err``: the largest gap between the program's and the
  reference's decoder input (the channel, B2, and its preprocessing);
* ``frames_differ``: the share of the frames whose decisions, iterations
  or satisfied flag differ from the reference's;
* ``count_gap``: the largest relative gap, over the batches, between the
  program's counts of bit or word errors and the reference's.
"""

from __future__ import annotations

import json
import math
import sys

import torch

NAMES = ("chan_max_err", "frames_differ", "count_gap")


class Tally:
    """Accumulates the three numbers over checked batches."""

    def __init__(self):
        self.chan = 0.0
        self.differ = 0
        self.frames = 0
        self.gap = 0.0

    def add(self, prog: dict, ref, keyed: bool = True) -> tuple:
        """Compare a kept batch (:class:`..window.Keeper`) with the
        reference's (input, hard, iterations, satisfied) of the frames it
        was due to decode; returns the reference's (bit errors, word
        errors) of the batch.  ``keyed`` false (the program keyed the batch
        by other frames) counts every frame of it as differing."""
        r_inp, r_hard, r_its, r_sat = (t.cpu() for t in ref)
        gap = (prog["inp"].float() - r_inp.float()).abs()
        self.chan = max(self.chan, float(gap.max()) if gap.numel() else 0.0)
        if torch.isnan(gap).any():
            self.chan = float("inf")
        r_neg = r_hard < 0
        bad = (((prog["hard"] < 0) != r_neg).any(dim=1)
               | (prog["iterations"].to(torch.int64) != r_its.to(torch.int64))
               | (prog["satisfied"].bool() != r_sat.bool())
               | (not keyed))
        self.differ += int(bad.sum())
        self.frames += bad.numel()
        return int(r_neg.sum()), int(r_neg.any(dim=1).sum())

    def count(self, got, want) -> None:
        """Hold the (bit, word) errors the program counted for a batch
        against the reference's."""
        for g, w in zip(got, want):
            self.gap = max(self.gap, abs(g - w) / max(w, 1))

    def numbers(self) -> dict:
        differ = self.differ / self.frames if self.frames else float("inf")
        return {"chan_max_err": self.chan, "frames_differ": differ,
                "count_gap": self.gap}


def verdict(numbers: dict, limits: dict, checked: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and at least one frame checked."""
    finite = {k: numbers[k] if math.isfinite(numbers[k]) else 1e30
              for k in NAMES}  # JSON has no inf or nan
    table = {k: {"value": finite[k], "limit": limits[k]} for k in NAMES}
    ok = checked > 0 and all(numbers[k] <= limits[k] for k in NAMES)
    return ok, table


def print_checks(table: dict, checked: int) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    print(f"check: {checked} frames against the plain reference",
          file=sys.stderr)
    for k, v in table.items():
        print(f"check: {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()


def dumps(obj) -> str:
    return json.dumps(obj, allow_nan=False)
