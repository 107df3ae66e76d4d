"""The early-termination decision merge (``decoders/base.py::
run_flooding_soft``'s latch of a round's decisions and round counts, the
span ``ldpc.decode.et_merge``): share of its roofline, over the device
time of the kernels launched inside the span (:mod:`._launch_spans`),
whatever kernels do the work.  A round reads the posterior once in the
arithmetic type and writes the int8 decisions of the lanes not yet done,
reads the done flag and writes the int32 round counts of those lanes: the
least any implementation moves, a masked store in place reading neither
the old decisions nor the old counts.  Its operations: 3 a column-lane
(the sign's compare and the two selects)."""

from ..reference import precision
from ._kernels import roofline
from ._launch_spans import per_span

LAYER = "early-termination decision merge"
MOVES = "info_bits_per_s"
SPAN = "ldpc.decode.et_merge"


def call_bytes(n: int, batch: int, arith: int) -> int:
    return batch * (n * (arith + 1) + 5)


def call_ops(n: int, batch: int) -> int:
    return 3 * n * batch


def read(ctx):
    secs = per_span(ctx["summary"], SPAN)
    if not secs:
        return None
    n, b = ctx["graph"].n, ctx["batch"]
    arith = precision(ctx["cell"].config["precision"]).arith.itemsize
    nbytes, ops = call_bytes(n, b, arith), call_ops(n, b)
    return roofline(ctx, [(s, nbytes, ops) for s in secs])
