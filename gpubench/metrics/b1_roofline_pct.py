"""B1, the min-sum check-node update (``decoders/minsum_qc.py``,
``decoders/minsum.py`` → ``csrc/minsum_cn_scan.cu``): share of its
roofline.  A call reads every edge's message in the storage type and
writes every edge's output (in the storage type, or f32); a few
comparisons an edge, no f32 arithmetic to speak of."""

from ._kernels import calls, roofline, size

LAYER = "min-sum check-node update"
MOVES = "info_bits_per_s"
KERNEL = r"minsum_cn_lanes_kernel<"


def call_bytes(edges: int, batch: int, in_size: int, out_size: int) -> int:
    return edges * batch * (in_size + out_size)


def read(ctx):
    e, b = ctx["graph"].e, ctx["batch"]
    rows = [(sec, call_bytes(e, b, size(name, 0), size(name, 2)), 0)
            for name, sec in calls(ctx, KERNEL)]
    return roofline(ctx, rows)
