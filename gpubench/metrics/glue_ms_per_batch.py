"""Device milliseconds per batch of the kernels that are not hand-written
(transposes, initial planes, decisions, the [B] bookkeeping, the error
count): the plain-torch glue.  A hand-written kernel is one that a
metric's ``KERNEL`` pattern names."""

import re

LAYER = "plain-torch glue"
MOVES = "info_bits_per_s"


def read(ctx):
    if not ctx["batches"]:
        return None
    hand = [re.compile(p) for p in ctx["hand_kernels"]]
    ns = sum(t - s for n, s, t, kind in ctx["summary"]["device"]
             if kind == "kernel" and not any(p.search(n) for p in hand))
    return ns / 1e6 / ctx["batches"]
