"""The sum-product check-node update (``decoders/bp_qc.py::qc_cn_bp``,
``decoders/bp.py::bp_cn_update``, each a span ``ldpc.decode.bp_check``):
share of its roofline, over the device time of the kernels launched inside
the span (:mod:`._launch_spans`), whatever kernels do the work.  A call
reads every edge's v2c message and writes every edge's c2v message, both
in the storage type: the least any implementation moves.  Its f32
operations per check of degree dc: the two pair folds, 4 for each of
dc − 1 slots each, and per edge the combine (6), the exponential, the
division and the logarithm."""

from ..reference import precision
from ._kernels import roofline
from ._launch_spans import per_span

LAYER = "sum-product check-node update"
MOVES = "info_bits_per_s"
SPAN = "ldpc.decode.bp_check"


def call_bytes(edges: int, batch: int, storage_size: int) -> int:
    return edges * batch * 2 * storage_size


def call_ops(degrees, batch: int) -> int:
    return batch * sum(8 * (dc - 1) + 9 * dc for dc in degrees)


def read(ctx):
    secs = per_span(ctx["summary"], SPAN)
    if not secs:
        return None
    g, b = ctx["graph"], ctx["batch"]
    size = precision(ctx["cell"].config["precision"]).storage.itemsize
    degrees = (g.check_edges < g.e).sum(dim=1).tolist()
    nbytes, ops = call_bytes(g.e, b, size), call_ops(degrees, b)
    return roofline(ctx, [(s, nbytes, ops) for s in secs])
