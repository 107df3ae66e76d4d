"""What the modes share: the end-to-end metrics of a window, the traced
sub-window's per-layer metrics, and the check of the kept batches."""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from .. import check, trace
from ..reference import Precision, codes, precision, sigma_of
from ..window import draw_batches


def setup_reference(cell):
    """(the code's graph, the reference's σ of each operating point, the
    program's precision, the control's precision) of a cell."""
    cfg = cell.config
    graph = codes.graph(codes.load_table(cfg["code"]))
    return (graph, [sigma_of(s, graph.k / graph.n)
                    for s in cell.traffic["snr_db"]],
            precision(cfg["precision"]), precision(cfg["control"]))


def plan(traffic: dict, seconds: float, batch_s: float, seed: int,
         traced: bool):
    """(batches to keep, trace plan (first, count) or None) for a window
    of ``seconds`` whose batches take about ``batch_s``: the kept batches
    are drawn from the seed among the first 80 % of the window, or, in a
    traced run, among those before the traced sub-window, which starts at
    30 % of the window."""
    expected = max(1, int(seconds / max(batch_s, 1e-9)))
    keep_n = max(1, math.ceil(traffic["check_frames"] / traffic["batch"]))
    if not traced:
        return draw_batches(seed, int(0.8 * expected), keep_n), None
    count = max(1, min(traffic["trace_batches"],
                       int(traffic["trace_seconds"] / batch_s)))
    first = max(keep_n + 2, int(0.3 * expected))
    return draw_batches(seed, first - 1, keep_n), (first, count)


def end_to_end(cell, window, frames: int, k: int, peak: int,
               setup_s: float) -> dict:
    """The cell's end-to-end metrics of a window.  A metric ``q.part``
    (a quantity split over cells whose noise differs) reports quantity
    ``q``."""
    ms = window.batch_ms()
    quantity = {
        "info_bits_per_s": frames * k / window.seconds_measured,
        "batch_ms_p95": float(np.percentile(ms, 95)),
        "peak_mem_gib": peak / 2 ** 30,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": quantity[m["name"].split(".")[0]],
                        "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell, summary, graph) -> dict:
    """The cell's per-layer metrics read from a sub-window's summary (its
    ``batches`` whole batches); a reader that finds nothing to read is left
    out."""
    if summary is None:
        return {}
    ctx = {"summary": summary, "batches": summary["batches"], "cell": cell,
           "graph": graph, "batch": cell.traffic["batch"],
           "kind": (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "cpu"),
           "hand_kernels": hand_kernels(cell)}
    out = {}
    for m in cell.per_layer:
        mod = cell.metric_module(m["name"])
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def hand_kernels(cell) -> tuple:
    """The name patterns of the hand-written kernels: every metric module's
    ``KERNEL``."""
    from ..spec import listing

    pats = []
    for name in listing(cell.root)["metrics"]:
        pat = getattr(cell.metric_module(name), "KERNEL", None)
        if pat:
            pats.append(pat)
    return tuple(pats)


def device_times(summary) -> dict:
    """``busy_s`` and ``window_s`` of a sub-window."""
    w0, w1 = summary["window"]
    return {"busy_s": trace.busy_ns(summary) / 1e9,
            "window_s": (w1 - w0) / 1e9}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def counts_of_hard(hard: torch.Tensor) -> tuple:
    """(bit errors, word errors) of ±1 decisions of the all-(+1) word."""
    neg = hard < 0
    return int(neg.sum()), int(neg.any(dim=1).sum())


def check_kept(cell, kept: dict, graph, seed: int, sigma_of_kept,
               prec: Precision, device, control: Precision = None):
    """Hold the kept batches against the reference, batch ``i`` of the
    window (of each point, in the grid) being frames ``i·b`` to ``i·b +
    b − 1`` of the seed's run: (the program's tally,
    the control's tally, {batch index: the reference's (bit, word)
    errors}); the control, the reference in ``control``'s precision in the
    program's place, is tallied only when given, its counts held against
    the reference's at once."""
    fam = cell.family
    g = graph.to(device)
    prog, ctrl, want = check.Tally(), check.Tally(), {}
    for idx, batch in sorted(kept.items()):
        b = batch["hard"].shape[0]
        # batch ``idx`` of the window is due to decode frames idx·b on:
        # the reference follows the batch's index, not the program's key
        frame0 = idx * b
        frames = frame0 + torch.arange(b, device=device)
        sigma = sigma_of_kept(batch)
        ref = fam.reference(cell.config, g, seed, frames, sigma, prec)
        want[idx] = prog.add(batch, ref, keyed=batch["frame0"] == frame0)
        if control is not None:
            c = fam.reference(cell.config, g, seed, frames, sigma, control)
            ctrl.add(dict(inp=c[0].cpu(), hard=c[1].cpu(),
                          iterations=c[2].cpu(), satisfied=c[3].cpu()), ref)
            ctrl.count(counts_of_hard(c[1]), want[idx])
            del c
        del ref
    return prog, ctrl, want
