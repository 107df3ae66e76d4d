"""B4, the bit-flip decoders' Gaussian perturbation (``decoders/gdbf.py``
→ ``csrc/uniform_philox.cu``, its Gaussian instances): share of its
roofline.  A call writes [n, B] f32 samples (and, in its checking
instance, one int32 a sample); about 30 f32 operations a sample (the
uniform, erfinv, the products)."""

from ..roofline import template_args
from ._kernels import calls, roofline

LAYER = "decoder noise"
MOVES = "info_bits_per_s"
KERNEL = r"philox_draw_kernel<true,"


def call_bytes(n: int, batch: int, bits: bool) -> int:
    return n * batch * (4 + (4 if bits else 0))


def read(ctx):
    n, b = ctx["graph"].n, ctx["batch"]
    rows = [(sec, call_bytes(n, b, template_args(name)[3] == "true"),
             30 * n * b)
            for name, sec in calls(ctx, KERNEL)]
    return roofline(ctx, rows)
