"""Device time by the program span that launched it.

On one stream the device runs kernels in the order the host launched
them, so within a summary's whole batches (every launch has its device
record, :mod:`..trace`) the i-th kernel launch on the loop's thread is the
i-th kernel on the device.  A launch belongs to a span when it starts
inside one of the span's host ranges.  This reads the spans of a plain
PyTorch layer, whose kernels carry no name of their own, and keeps reading
them when a hand kernel takes the layer's place under the same span.
"""

from __future__ import annotations

import bisect
import sys

from ..trace import LAUNCHES


def per_span(summary: dict, name: str):
    """[seconds of device kernels launched inside each range ``name``]
    over the sub-window, in time order; None where the program opened no
    such range, or, said on stderr, where launches and device kernels do
    not pair one to one."""
    ranges = sorted((s, t) for n, s, t in summary["host"] if n == name)
    if not ranges:
        return None
    launches = sorted(s for n, s, _ in summary["host"] if n in LAUNCHES)
    kernels = [t - s for _, s, t, kind in summary["device"]
               if kind == "kernel"]
    if len(launches) != len(kernels):
        print(f"trace: {len(launches)} kernel launches against "
              f"{len(kernels)} device kernels: no device time is read by "
              f"span {name}", file=sys.stderr)
        return None
    starts = [s for s, _ in ranges]
    ns = [0] * len(ranges)
    for at, took in zip(launches, kernels):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at < ranges[i][1]:
            ns[i] += took
    return [v / 1e9 for v in ns]
