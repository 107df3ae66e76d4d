"""B5, the flooding min-sum variable-node update (``QCPlan.vn_rows``,
``MinSumPlan.vn_rows`` → ``csrc/minsum_vn_update.cu``): share of its
roofline.  A call reads every edge's check message and writes its new
message over it (the storage type), reads the channel and writes the
posterior (the channel's type); one add an edge for the fold and one for
the extrinsic, one a column for the channel."""

from ._kernels import calls, roofline, size

LAYER = "min-sum variable-node update"
MOVES = "info_bits_per_s"
KERNEL = r"minsum_vn_kernel<"


def call_bytes(edges: int, n: int, batch: int, store: int,
               chan: int) -> int:
    return batch * (2 * edges * store + 2 * n * chan)


def read(ctx):
    g, b = ctx["graph"], ctx["batch"]
    rows = [(sec, call_bytes(g.e, g.n, b, size(name, 0), size(name, 1)),
             (2 * g.e + g.n) * b)
            for name, sec in calls(ctx, KERNEL)]
    return roofline(ctx, rows)
