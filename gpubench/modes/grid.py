"""An operating-point grid over several cards through the program's grid
engine, ``ldpcsimulation_tpu_torch.parallel.montecarlo.simulate_grid``,
one rank per card, as the sweep CLI's ``--distributed`` route runs it on a
host with several cards.

The command starts the ranks itself (``parallel.mesh.spawn_ranks``, as the
sweep does) and rank 0 prints the run's one result for all of them.  Every
rank must make the same stop decision, or one would wait forever in the
all-reduce: so set-up times two warm rounds, rank 0 broadcasts the round's
time once, and every rank runs the same fixed number of rounds in the
window, which adds no collective of its own.  A round counts as a batch:
every card's slot decodes its point's next frames, and the counters are
all-reduced.  After the window each rank checks its kept round against the
reference, and rank 0 holds the counts it reported for every point against
the reference's of the rank that decoded that point.  Each rank also reports
whether JAX or the JAX package is loaded in it: rank 0 prints no result if
any is.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from . import common
from ..check import Tally, verdict
from ..trace import Tracer, breakdown
from ..window import Keeper, Window, sync

RUN = Path(__file__).resolve().parent.parent / "run.py"


def main(cell, args, t_launch: float, readings) -> int:
    """The launcher, or, under ``RANK``, one rank."""
    if "RANK" in os.environ:
        return rank_main(cell, args, t_launch, readings)
    from ldpcsimulation_tpu_torch.parallel.mesh import spawn_ranks

    cmd = [sys.executable, str(RUN), "--workload", cell.name,
           "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--launched-at", repr(t_launch)]
    if readings:
        cmd += ["--readings", ",".join(map(str, readings))]
    return spawn_ranks(cmd, cell.chips)


def _device(cpu: bool):
    if cpu:
        return torch.device("cpu")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return dev


def rank_main(cell, args, t_launch: float, readings, cpu: bool = False):
    """One rank: set-up, the window(s), the check; rank 0 prints."""
    from ldpcsimulation_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        world,
    )
    from ldpcsimulation_tpu_torch.parallel.montecarlo import simulate_grid

    from ..reference import codes
    from ..result import device_info, emit, jax_loaded

    device = _device(cpu)
    init_distributed(devices=[device])
    rank, size = world()
    cfg, traffic = cell.config, cell.traffic
    snrs, batch = traffic["snr_db"], traffic["batch"]
    points = [{"snr": s} for s in snrs]
    if len(points) != size:
        raise ValueError(f"{len(points)} points on {size} ranks: the "
                         "window's slots take one point each")
    graph, ref_sigmas, prec, ctrl_prec = common.setup_reference(cell)
    port = cell.family.Port(cfg, codes.load_table(cfg["code"]), device)
    decode, pre = port.grid_decoder()
    mesh = make_mesh(len(points), [device] * size if cpu else None)
    T = cfg["decoder"]["iterations"]

    def grid(stop, dec, s):
        stop.start()
        return simulate_grid(port.code, dec, points, mesh, max_iterations=T,
                             stop=stop, batch_per_device=batch, seed=s,
                             preprocess=pre)

    warm = Window(frames=2 * batch, points=len(points))
    grid(warm, decode, args.seed)
    sync(device)
    if args.trace:
        Tracer.warm(device)
    # rank 0's round time, so every rank plans the same rounds
    t = torch.tensor([warm.batch_ms()[-1] / 1e3], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, 0)
    round_s = float(t)
    rounds = max(2, math.ceil(args.seconds / round_s))

    def one_window(s, traced):
        keep, span = common.plan(traffic, args.seconds, round_s, s, traced)
        keeper = Keeper(decode, keep, lambda sigma, key, point: key.frame0)
        tracer = Tracer(device) if span else None
        n = max(rounds, max(keep) + 1, sum(span) + 1 if span else 0)
        win = Window(frames=n * batch, points=len(points),
                     trace=None if span is None else
                     (*span, tracer))
        stats = grid(win, keeper, s)
        sync(device)
        return win, keeper, tracer, stats

    def checked(win, keeper, s, control):
        """Gathered on rank 0: the program's tally (and the control's)
        with every point's counts held against the reference's."""
        prog, ctrl, want = common.check_kept(
            cell, keeper.kept, graph, s, lambda b: ref_sigmas[rank], prec,
            device, control=ctrl_prec if control else None)
        mine = {"prog": vars(prog), "ctrl": vars(ctrl), "want": want}
        every = [None] * size
        dist.all_gather_object(every, mine)
        total, ctrl_total = Tally(), Tally()
        for p, got in enumerate(every):
            for t_, part in ((total, got["prog"]), (ctrl_total, got["ctrl"])):
                t_.chan = max(t_.chan, part["chan"])
                t_.differ += part["differ"]
                t_.frames += part["frames"]
                t_.gap = max(t_.gap, part["gap"])
            for idx, w in got["want"].items():
                total.count(win.counts_of(idx, p), w)
        return total, ctrl_total

    if readings:
        for s in readings:
            win, keeper, _, _ = one_window(s, False)
            common.free(device)
            prog, ctrl = checked(win, keeper, s, True)
            if rank == 0:
                print(json.dumps({"seed": s, "batches": win.batches,
                                  "frames_checked": prog.frames,
                                  "program": prog.numbers(),
                                  "control": ctrl.numbers()}), flush=True)
        dist.destroy_process_group()
        return 0

    traced = bool(args.trace)
    win, keeper, tracer, stats = one_window(args.seed, traced)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted = sum(st.total_words for st in stats)
    mine = {"peak": peak}
    if traced:
        summary = tracer.summary()
        mine["per_layer"] = common.per_layer(cell, summary,
                                             graph)
        if summary is not None:
            mine["times"] = common.device_times(summary)
            mine["breakdown"] = breakdown(summary)
    every = [None] * size
    dist.all_gather_object(every, mine)
    del stats, decode, tracer
    common.free(device)
    t_check = time.perf_counter()
    prog, _ = checked(win, keeper, args.seed, False)
    print(f"check: rank {rank}: the reference took "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    # every rank decoded part of the window: each looks at its own modules
    loaded = [None] * size
    dist.all_gather_object(loaded, jax_loaded())
    dist.destroy_process_group()
    if rank != 0:
        return 0
    peak = max(e["peak"] for e in every)
    dev = device_info(device, size, peak)
    extra = {}
    if traced:
        metrics = {}
        for m in cell.per_layer:
            vals = [e["per_layer"][m["name"]]["value"] for e in every
                    if m["name"] in e["per_layer"]]
            if len(vals) == size:  # read on every card, or left out
                fold = getattr(cell.metric_module(m["name"]),
                               "ACROSS_CARDS", lambda v: v[0])
                metrics[m["name"]] = {"value": fold(vals), "unit": m["unit"]}
        times = [e["times"] for e in every if "times" in e]
        if len(times) == size:
            dev["busy_s"] = sum(t["busy_s"] for t in times) / len(times)
            dev["window_s"] = sum(t["window_s"] for t in times) / len(times)
        if "breakdown" in every[0]:
            extra["breakdown"] = every[0]["breakdown"]
    else:
        metrics = common.end_to_end(cell, win, attempted, graph.k, peak,
                                    win.stamps[0] - t_launch)
    ok, table = verdict(prog.numbers(), cfg["limits"], prog.frames)
    result = {"correct": ok, "attempted": attempted, "failed": prog.differ,
              "metrics": metrics, "device": dev, **extra}
    return emit(result, table, prog.frames,
                [(f"rank {r}", m) for r, m in enumerate(loaded) if r])
