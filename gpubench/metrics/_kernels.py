"""What the per-layer readers share: a hand-written kernel's calls in a
sub-window, grouped by batch, and its roofline share."""

from __future__ import annotations

import re

from ..roofline import SIZES, share, template_args
from ..trace import BATCH_KERNEL


def calls(ctx, pattern: str) -> list:
    """[(name, seconds)] of the device kernels whose name matches
    ``pattern``, in launch order."""
    rx = re.compile(pattern)
    return [(n, (t - s) / 1e9) for n, s, t, kind in ctx["summary"]["device"]
            if kind == "kernel" and rx.search(n)]


def steps_in_batch(ctx, pattern: str) -> list:
    """[(name, seconds, index within its batch)] of the kernels matching
    ``pattern``; a batch starts at each launch of kernel B2 (the channel),
    which every batch makes once, first."""
    out, step = [], 0
    for n, s, t, kind in ctx["summary"]["device"]:
        if kind != "kernel":
            continue
        if BATCH_KERNEL in n:
            step = 0
        if re.search(pattern, n):
            out.append((n, (t - s) / 1e9, step))
            step += 1
    return out


def size(name: str, i: int) -> int:
    """Bytes of the type in template argument ``i`` of a kernel's name."""
    return SIZES[template_args(name)[i]]


def roofline(ctx, rows) -> float:
    """Share in per cent over ``rows`` ([(seconds, bytes, flops)]), None
    without calls."""
    return share(rows, ctx["kind"])
