"""One operating point on one card through the program's own loop,
``ldpcsimulation_tpu_torch.harness.montecarlo.simulate``.

Set-up builds the code and the decoder, then one warm call of two batches
compiles and loads everything the window uses.  The window is one call of
``simulate`` whose stop rule (:class:`..window.Window`) stamps the host
clock between batches and ends the call once ``--seconds`` have passed; each
batch ends with its counts on the host.  The batches drawn from the seed
are kept for the check, which runs once the window has closed, the peak of
memory has been read and the program's state is freed.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import common
from ..check import verdict
from ..trace import Tracer, breakdown
from ..window import Keeper, Window, sync


def run(cell, seed: int, seconds: float, traced: bool, t_proc: float,
        device, readings=None) -> int:
    """Run the cell and print its result; returns the exit code.
    ``readings``: a list of seeds, to print the program's and the control's
    numbers on each (the limits' readings) instead of a result."""
    from ldpcsimulation_tpu_torch.channel.awgn import snr_to_sigma
    from ldpcsimulation_tpu_torch.harness.montecarlo import simulate

    from ..reference import codes
    from ..result import device_info, emit

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    cfg, traffic = cell.config, cell.traffic
    graph, ref_sigmas, prec, ctrl_prec = common.setup_reference(cell)
    port = cell.family.Port(cfg, codes.load_table(cfg["code"]), device)
    snr, batch = traffic["snr_db"][0], traffic["batch"]
    decode, pre = port.batch_decoder(snr_to_sigma(snr, port.code.rate))

    def window_of(stop, dec, s):
        return simulate(port.code, dec, snr, stop=stop, batch_size=batch,
                        seed=s, preprocess=pre, device=device,
                        max_batches=10 ** 9)

    warm = Window(frames=2 * batch)
    window_of(warm, decode, seed)
    sync(device)
    if traced:
        Tracer.warm(device)
    batch_s = warm.batch_ms()[-1] / 1e3

    def one_window(s, trace_it):
        keep, span = common.plan(traffic, seconds, batch_s, s, trace_it)
        keeper = Keeper(decode, keep, lambda key: key.frame0)
        tracer = Tracer(device) if span else None
        win = Window(seconds=seconds, trace=None if span is None else
                     (*span, tracer),
                     min_batches=max(keep) + 1)
        stats = window_of(win, keeper, s)
        sync(device)
        return win, keeper, tracer, stats

    if readings:
        for s in readings:
            win, keeper, _, stats = one_window(s, False)
            common.free(device)
            prog, ctrl, want = common.check_kept(
                cell, keeper.kept, graph, s, lambda b: ref_sigmas[0], prec,
                device, control=ctrl_prec)
            for i, w in want.items():
                prog.count(win.counts_of(i), w)
            print(json.dumps({"seed": s, "batches": win.batches,
                              "frames_checked": prog.frames,
                              "program": prog.numbers(),
                              "control": ctrl.numbers()}), flush=True)
        return 0

    win, keeper, tracer, stats = one_window(seed, traced)
    setup_s = win.stamps[0] - t_proc
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = stats.total_words
    dev = device_info(device, 1, peak)
    extra = {}
    if traced:
        summary = tracer.summary()
        metrics = common.per_layer(cell, summary, graph)
        if summary is not None:
            dev.update(common.device_times(summary))
            extra["breakdown"] = breakdown(summary)
    else:
        metrics = common.end_to_end(cell, win, attempted, graph.k, peak,
                                    setup_s)
    del stats, decode, tracer
    common.free(device)
    t_check = time.perf_counter()
    prog, _, want = common.check_kept(
        cell, keeper.kept, graph, seed, lambda b: ref_sigmas[0], prec,
        device)
    print(f"check: the reference took {time.perf_counter() - t_check:.1f} "
          "s", file=sys.stderr)
    for i, w in want.items():
        prog.count(win.counts_of(i), w)
    ok, table = verdict(prog.numbers(), cfg["limits"], prog.frames)
    result = {"correct": ok, "attempted": attempted, "failed": prog.differ,
              "metrics": metrics, "device": dev, **extra}
    return emit(result, table, prog.frames)


def main(cell, args, t_proc: float, readings) -> int:
    """The command line's run on the first card."""
    return run(cell, args.seed, args.seconds, bool(args.trace), t_proc,
               torch.device("cuda", 0), readings)
