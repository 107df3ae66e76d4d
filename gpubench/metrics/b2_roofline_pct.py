"""B2, the channel (``channel/awgn.py`` → ``csrc/awgn_philox.cu``): share of
its roofline.  A call writes the batch's [B, n] f32 samples (and, in its
checking instance, two int32 words per sample); about 12 f32 operations a
sample (two uniforms, log, square root, cosine and the products)."""

from ..roofline import template_args
from ._kernels import calls, roofline

LAYER = "channel"
MOVES = "info_bits_per_s"
KERNEL = r"awgn_philox_kernel<"


def call_bytes(n: int, batch: int, bits: bool) -> int:
    return n * batch * (4 + (8 if bits else 0))


def read(ctx):
    n, b = ctx["graph"].n, ctx["batch"]
    rows = [(sec, call_bytes(n, b, template_args(name)[1] == "true"),
             12 * n * b)
            for name, sec in calls(ctx, KERNEL)]
    return roofline(ctx, rows)
