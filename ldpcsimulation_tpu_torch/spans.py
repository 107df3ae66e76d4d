"""Named ranges of the port's phases, recorded through ``torch.profiler``.

While a profiler runs, :func:`span` opens a ``torch.profiler.record_function``
range, so the port's phases land in the same trace as the device's records,
on the same clock: a trace viewer, or a reader of the profiler's events,
names each stretch of the card's idle time by the innermost span open on the
host then.  With no profiler running, :func:`span` returns one shared null
context, so a span site costs one bool check.

Every name starts with ``ldpc.``.  The names under ``ldpc.decode.`` open
only inside ``ldpc.decode``, so a reader can tell the decoder's time from
the loop's by the name alone.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "span"]

#: one batch of ``harness.montecarlo.simulate``, between two stop checks
BATCH = "ldpc.batch"
#: the batch's channel draw, codeword cycle and preprocess
CHANNEL = "ldpc.channel"
#: the decoder's call (its carry included); in the grid, one slot's decode
DECODE = "ldpc.decode"
#: the frame-error and uncoded compares and sums on the device
COUNT = "ldpc.count"
#: the copies of the batch's ``[B]`` vectors to the host
TO_HOST = "ldpc.to_host"
#: the NumPy bookkeeping into ``MCStats`` and the verbose report
TALLY = "ldpc.tally"
#: a decoder's host read of its all-done flag
EXIT_CHECK = "ldpc.decode.exit_check"
#: one sum-product check-node update (every check, every lane; one layer's
#: checks in layered BP)
BP_CHECK = "ldpc.decode.bp_check"
#: one sum-product variable-node update of the flooding QC decoder (every
#: column, every lane)
BP_VN = "ldpc.decode.bp_vn"
#: one round's decision merge of the loops in ``decoders/base.py`` with
#: early termination, ``run_flooding_soft`` (kernel B10) and
#: ``run_flooding`` (the layered decoders, NB min-sum): the decisions, the
#: latch of those of frames not yet done and their round counts (every
#: column, every lane); not the step, the parity check or the exit check
ET_MERGE = "ldpc.decode.et_merge"
#: one layer of the row-layered min-sum step
#: (``decoders/minsum_layered.py::qc_minsum_layered_step``): the posterior's
#: gather, the extrinsic, the check update, the posterior's scatter and the
#: messages' store (Mb a round; not the step's copy of the posterior)
LAYER_STEP = "ldpc.decode.layer"
#: one round of ``parallel.montecarlo.simulate_grid``, before its stop checks
GRID_ROUND = "ldpc.grid.round"
#: one slot of a grid step: its channel, decode and counters
GRID_SLOT = "ldpc.grid.slot"
#: the step's gather of its slots onto one device and the all-reduce
GRID_ALLREDUCE = "ldpc.grid.allreduce"
#: the copy of the step's ``[S, W]`` counters to the host
GRID_TO_HOST = "ldpc.grid.to_host"
#: the grid's fold of a round's counters into each point's ``MCStats``
GRID_TALLY = "ldpc.grid.tally"

SPANS = (BATCH, CHANNEL, DECODE, COUNT, TO_HOST, TALLY, EXIT_CHECK,
         GRID_ROUND, GRID_SLOT, GRID_ALLREDUCE, GRID_TO_HOST, GRID_TALLY,
         BP_CHECK, BP_VN, ET_MERGE, LAYER_STEP)

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` as a range while a profiler
    runs, else the shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL
