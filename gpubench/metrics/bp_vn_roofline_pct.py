"""The sum-product variable-node update (``decoders/bp_qc.py::qc_bp_step``'s
VN side, the span ``ldpc.decode.bp_vn``): share of its roofline, over the
device time of the kernels launched inside the span
(:mod:`._launch_spans`), whatever kernels do the work.  A call reads every
edge's c2v message and writes the posterior in the arithmetic type, reads
the channel in its type and writes every edge's v2c message in the storage
type: the least any implementation moves.  Its f32 operations: 4 an
edge-lane (the fold's add, the extrinsic subtraction, the clip's two
compares) and 1 a column-lane (the channel's add)."""

from ..reference import precision
from ._kernels import roofline
from ._launch_spans import per_span

LAYER = "sum-product variable-node update"
MOVES = "info_bits_per_s"
SPAN = "ldpc.decode.bp_vn"


def call_bytes(edges: int, n: int, batch: int, arith: int, storage: int,
               channel: int) -> int:
    return batch * (edges * (arith + storage) + n * (channel + arith))


def call_ops(edges: int, n: int, batch: int) -> int:
    return batch * (4 * edges + n)


def read(ctx):
    secs = per_span(ctx["summary"], SPAN)
    if not secs:
        return None
    g, b = ctx["graph"], ctx["batch"]
    p = precision(ctx["cell"].config["precision"])
    nbytes = call_bytes(g.e, g.n, b, p.arith.itemsize, p.storage.itemsize,
                        p.channel.itemsize)
    return roofline(ctx, [(s, nbytes, call_ops(g.e, g.n, b)) for s in secs])
