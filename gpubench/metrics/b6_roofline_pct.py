"""B6, the parity check (``decoders/base.py::xor_satisfied`` →
``csrc/parity_check.cu``): share of its roofline.  A call reads the
decisions [n, B] and writes one flag a frame, and in the bit-flip
decoders also the syndrome [m, B] in the decisions' type; XORs only."""

from ._kernels import calls, roofline, size

LAYER = "parity check"
MOVES = "info_bits_per_s"
KERNEL = r"parity_check_kernel<"
#: decoder families whose calls also write the syndrome
SYNDROME_FAMILIES = ("ngdbf",)


def call_bytes(n: int, m: int, batch: int, d_size: int,
               syndrome: bool) -> int:
    return batch * (n * d_size + 1 + (m * d_size if syndrome else 0))


def read(ctx):
    g, b = ctx["graph"], ctx["batch"]
    syn = ctx["cell"].config["family"] in SYNDROME_FAMILIES
    rows = [(sec, call_bytes(g.n, g.m, b, size(name, 0), syn), 0)
            for name, sec in calls(ctx, KERNEL)]
    return roofline(ctx, rows)
