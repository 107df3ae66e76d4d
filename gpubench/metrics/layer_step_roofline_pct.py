"""The row-layered min-sum layer step (``decoders/minsum_layered.py::
qc_minsum_layered_step``'s work on one layer: the posterior's gather, the
extrinsic, the check update, the posterior's scatter and the messages'
store; the span ``ldpc.decode.layer``): share of its roofline, over the
device time of the kernels launched inside each range
(:mod:`._launch_spans`), whatever kernels do the work.  The sub-window
holds whole batches, each of whole rounds of Mb layers in base-row order,
so its i-th range is layer i mod Mb; a count of ranges that is no multiple
of Mb reads nothing.  Kernel launches outside every ``ldpc.batch`` range
of the program's loop (the profiler's own start-up before the first traced
batch, which the sub-window takes in where it widens to a device record
that starts before the batch's range) launch none of the summary's
kernels, and are left out of the pairing; a program that opens no
``ldpc.batch`` keeps them all.

Layer ``bi`` reads its distinct posterior columns once and writes them
once in the arithmetic type, and reads its stored messages once and writes
them once in the storage type: the least any implementation moves, every
extrinsic and check output staying on chip.  Its f32 operations: 6 an
edge-lane (the extrinsic's subtraction, two compares toward the two least
magnitudes, the sign's product, the division by α and the posterior's
add), far under the bytes' time."""

import bisect

from ..reference import codes, precision
from ..trace import LAUNCHES
from ._kernels import roofline
from ._launch_spans import per_span

LAYER = "row-layered min-sum layer step"
MOVES = "info_bits_per_s"
SPAN = "ldpc.decode.layer"
BATCH = "ldpc.batch"


def batch_launches(summary: dict) -> dict:
    """The summary without the kernel launches that lie outside every
    ``ldpc.batch`` range; unchanged where the program opened none."""
    batches = sorted((s, t) for n, s, t in summary["host"] if n == BATCH)
    if not batches:
        return summary
    starts = [s for s, _ in batches]

    def in_batch(at):
        i = bisect.bisect_right(starts, at) - 1
        return i >= 0 and at < batches[i][1]

    return dict(summary, host=[h for h in summary["host"]
                               if h[0] not in LAUNCHES or in_batch(h[1])])


def layer_sizes(graph, z: int) -> list:
    """[(distinct columns, edges)] of each layer, checks ``bi·z`` to
    ``bi·z + z − 1`` for layer ``bi``."""
    out = []
    for bi in range(graph.m // z):
        cols = graph.check_cols[bi * z:(bi + 1) * z]
        cols = cols[cols < graph.n]
        out.append((int(cols.unique().numel()), int(cols.numel())))
    return out


def call_bytes(cols: int, edges: int, batch: int, arith: int,
               storage: int) -> int:
    return batch * (cols * 2 * arith + edges * 2 * storage)


def call_ops(edges: int, batch: int) -> int:
    return 6 * edges * batch


def read(ctx):
    secs = per_span(batch_launches(ctx["summary"]), SPAN)
    if not secs:
        return None
    cfg = ctx["cell"].config
    sizes = layer_sizes(ctx["graph"], codes.load_table(cfg["code"])["z"])
    if len(secs) % len(sizes):
        return None
    p = precision(cfg["precision"])
    b = ctx["batch"]
    rows = []
    for i, s in enumerate(secs):
        cols, edges = sizes[i % len(sizes)]
        rows.append((s, call_bytes(cols, edges, b, p.arith.itemsize,
                                   p.storage.itemsize),
                     call_ops(edges, b)))
    return roofline(ctx, rows)
