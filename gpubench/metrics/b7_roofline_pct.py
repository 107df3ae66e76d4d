"""B7, the parallel bit-flip step (``decoders/gdbf.py`` →
``csrc/gdbf_step.cu``): share of its roofline.  A step reads the syndrome
[m, B], reads and writes the decisions [n, B] (their type), reads the
channel, the thresholds (written back where they adapt) and the
perturbation (f32), and inside the smoothing window reads and writes the
int32 decision sums; one flag a frame; about 5 f32 operations a bit.  The
window is the last ``window − 1`` steps of a batch; a batch's steps are
counted from its channel launch."""

from ..roofline import template_args
from ._kernels import roofline, size, steps_in_batch

LAYER = "bit-flip step"
MOVES = "info_bits_per_s"
KERNEL = r"gdbf_step_kernel<"
#: presets whose thresholds adapt, and whose outputs are smoothed
ADAPTS = ("ATGDBF", "SATGDBF", "MNGDBF", "SMNGDBF", "RSMNGDBF")
SMOOTHS = ("SMGDBF", "SATGDBF", "SMNGDBF", "RSMNGDBF")


def call_bytes(n: int, m: int, batch: int, d_size: int, adapts: bool,
               pert: bool, smooth: bool) -> int:
    per_lane = (m * d_size + 2 * n * d_size + 4 * n
                + 4 * n * (2 if adapts else 1) + (4 * n if pert else 0)
                + (8 * n if smooth else 0) + 1)
    return batch * per_lane


def read(ctx):
    g, b = ctx["graph"], ctx["batch"]
    dec = ctx["cell"].config["decoder"]
    preset = dec["preset"]
    rows = []
    for name, sec, step in steps_in_batch(ctx, KERNEL):
        smooth = (preset in SMOOTHS
                  and step > dec["iterations"] - dec["window"])
        pert = template_args(name)[2] == "true"
        rows.append((sec, call_bytes(g.n, g.m, b, size(name, 0),
                                     preset in ADAPTS, pert, smooth),
                     5 * g.n * b))
    return roofline(ctx, rows)
