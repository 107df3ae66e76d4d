"""Peaks of the devices the benchmark runs on, and a kernel's share of its
roofline.

The roofline time of a call is the larger of its bytes over the memory
bandwidth and its f32 operations over the f32 rate outside the tensor
cores; a kernel's share is the sum of its calls' roofline times over the
sum of their measured times, in per cent.  Each input byte counts as read
once and each output byte as written once.
"""

from __future__ import annotations

import re
from typing import Optional

#: NVIDIA's data sheet, H100 SXM5: HBM3 bandwidth, dense f32 (non-tensor)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_per_s": 67e12},
}

#: bytes of the C++ types in kernel template arguments
SIZES = {"__half": 2, "float": 4, "int": 4, "signed char": 1, "bool": 1,
         "__nv_bfloat16": 2}


def template_args(name: str) -> list:
    """The template arguments of a kernel's demangled name, as strings."""
    m = re.search(r"<(.*?)>\(", name)
    return [a.strip() for a in m.group(1).split(",")] if m else []


def share(calls, kind: str) -> Optional[float]:
    """Per cent of the roofline over ``calls`` ([(seconds, bytes,
    flops)]), on the device ``kind``; None without calls or peaks."""
    peak = PEAKS.get(kind)
    if not calls or peak is None:
        return None
    spent = sum(c[0] for c in calls)
    least = sum(max(c[1] / peak["bytes_per_s"], c[2] / peak["f32_per_s"])
                for c in calls)
    return 100.0 * least / spent if spent > 0 else None
