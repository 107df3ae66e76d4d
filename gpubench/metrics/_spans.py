"""The card's idle time by the innermost program span open during it.

The program names its phases with ``torch.profiler.record_function``
ranges whose names start with ``ldpc.`` (``ldpcsimulation_tpu_torch/
spans.py``); they are host operations of the summary like any other.  Kept
alone, they name each idle stretch of the sub-window by the innermost span
open then (:func:`..trace.idle_gaps`).  The decoder's spans are
``ldpc.decode`` and the names under it; every other span is the loop's.
The names are matched here, not imported from the program, so that the
readers also run over a program without spans (and read nothing there).
"""

from __future__ import annotations

from ..trace import idle_gaps

PREFIX = "ldpc."
DECODE = "ldpc.decode"


def is_decode(name: str) -> bool:
    return name == DECODE or name.startswith(DECODE + ".")


def idle_by_span(summary: dict):
    """{span name: idle ns} over the sub-window, or None where the program
    opened no span in it (a program without spans)."""
    host = [h for h in summary["host"] if h[0].startswith(PREFIX)]
    if not host:
        return None
    out = {}
    for name, ns in idle_gaps(dict(summary, host=host)):
        if name.startswith(PREFIX):
            out[name] = out.get(name, 0) + ns
    return out


def idle_ms_per_batch(ctx, decode: bool):
    """Idle ms per batch under the decoder's spans (``decode``) or under
    the loop's, None without a batch or a span."""
    idle = idle_by_span(ctx["summary"]) if ctx["batches"] else None
    if idle is None:
        return None
    ns = sum(v for k, v in idle.items() if is_decode(k) == decode)
    return ns / 1e6 / ctx["batches"]
