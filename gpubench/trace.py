"""The traced sub-window: ``torch.profiler`` over whole batches inside the
window, reduced to plain lists that the per-layer metrics read.

Each traced batch is a range of its own on the host (``MARK``), from one
between-batch stop check to the next.  The profiler can lose device events
(on an H100, now and then a kernel of a sub-window, most often its first):
a batch is whole when every kernel that the host launched in its range has
its device record, and the summary spans the longest run of consecutive
whole batches.

A summary is ``{"window": (start_ns, end_ns), "batches": n, "device":
[(name, start_ns, end_ns, kind)], "host": [(name, start_ns, end_ns)]}``:
the span of ``n`` whole batches and of every device operation they
launched, those operations (kernels, kind ``"kernel"``, and copies and
fills, ``"copy"``), and the operations of the host thread that runs the
loop, inside the span only.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import re
import sys

import torch

MARK = "gpubench.batch"
#: the kernel every batch launches once, first: B2, the channel
BATCH_KERNEL = "awgn_philox_kernel"
#: host calls that launch a kernel, and those that start a copy or a fill
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")
TRANSFERS = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
             "cudaMemset")


class Tracer:
    """Starts the profiler before a batch, marks each batch, and stops it
    after the last (:class:`..window.Window` calls :meth:`start`,
    :meth:`next` and :meth:`stop` between batches); the events stay in
    memory."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark = None
        self.stopped = False

    @staticmethod
    def _activities(device) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    @staticmethod
    def warm(device) -> None:
        """Profile one small operation, so that the profiler's own start-up
        (loading CUPTI) falls in set-up and not in the window."""
        with torch.profiler.profile(activities=Tracer._activities(device)):
            torch.ones(8, device=device).sum().item()

    def start(self) -> None:
        self.prof = torch.profiler.profile(
            activities=self._activities(self.device))
        self.prof.start()
        # one small operation, waited for, before the first batch's range
        torch.ones(8, device=self.device).sum().item()
        self.next()

    def next(self) -> None:
        """Close the range of the batch that ended and open the next's."""
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()

    def stop(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.mark.__exit__(None, None, None)
        self.mark = None
        self.prof.stop()
        self.stopped = True

    def summary(self):
        """The summary of the longest run of whole batches, or None when
        the window ended before the sub-window did (the profiler is stopped
        then all the same) or no batch is whole."""
        if self.prof is None:
            return None
        if not self.stopped:
            self.stop()
            return None
        return summarize(self.prof.profiler.kineto_results.events())


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def summarize(events):
    """A summary from the profiler's raw events (see the module's
    docstring), or None, said on stderr, when no batch is whole."""
    marks = sorted((e for e in events
                    if e.name() == MARK and not _is_device(e)),
                   key=lambda e: e.start_ns())
    if not marks:
        return None
    main = marks[0].start_thread_id()  # the thread that runs the loop
    edges = [(m.start_ns(), m.end_ns()) for m in marks]

    starts = [b0 for b0, _ in edges]

    def batch_of(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < edges[i][1] else None

    launched = {}  # correlation id: (batch, is a kernel launch)
    host = []
    for e in events:
        if _is_device(e) or e.start_thread_id() != main or e.name() == MARK:
            continue
        host.append((e.name(), e.start_ns(), e.end_ns()))
        if e.name() in LAUNCHES + TRANSFERS:
            launched[e.correlation_id()] = (batch_of(e.start_ns()),
                                            e.name() in LAUNCHES)
    device, ran = [], set()
    for e in events:
        if not _is_device(e) or e.is_user_annotation():
            continue  # a range such as nccl:all_reduce is no operation
        name = e.name()
        kind = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
        corr = e.correlation_id()
        b = launched[corr][0] if corr in launched else batch_of(e.start_ns())
        device.append((name, e.start_ns(), e.end_ns(), kind, b))
        if kind == "kernel":
            ran.add(corr)
    lost, firsts = [0] * len(edges), [0] * len(edges)
    for c, (b, kernel) in launched.items():
        if kernel and b is not None and c not in ran:
            lost[b] += 1
    for name, _, _, kind, b in device:
        if b is not None and kind == "kernel" and BATCH_KERNEL in name:
            firsts[b] += 1
    whole = [lost[i] == 0 and firsts[i] == 1 for i in range(len(edges))]
    run, (n, last) = 0, (0, 0)  # the longest run: its length, its end
    for i, ok in enumerate(whole):
        run = run + 1 if ok else 0
        if run > n:
            n, last = run, i
    if n == 0:
        print(f"trace: none of {len(edges)} traced batches holds every "
              "kernel it launched: the profiler lost device events, so no "
              "per-layer metric is read", file=sys.stderr)
        return None
    first = last - n + 1
    if n < len(edges):
        print(f"trace: the profiler lost device events of "
              f"{whole.count(False)} of {len(edges)} traced batches: read "
              f"over batches {first} to {last}", file=sys.stderr)
    mine = sorted(((name, s, t, kind) for name, s, t, kind, b in device
                   if b is not None and first <= b <= last),
                  key=lambda d: d[1])
    # the device's clock, set against the host's, can put a batch's first
    # kernel a little before its range or its last after it: the span
    # takes in every operation of its batches
    w0 = min([edges[first][0]] + [d[1] for d in mine])
    w1 = max([edges[last][1]] + [d[2] for d in mine])
    return {"window": (w0, w1), "batches": n, "device": mine,
            "host": [(name, max(s, w0), min(t, w1)) for name, s, t in host
                     if t > w0 and s < w1]}


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its return type, namespaces and
    arguments."""
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            cut = i
            break
    head = name[:cut]
    head = re.sub(r"^void\s+", "", head)
    head = re.sub(r"\(anonymous namespace\)::", "", head)
    head = re.sub(r"\bat::native::", "", head)
    return head[:width]


def busy_ns(summary: dict) -> int:
    """Nanoseconds of the sub-window in which the device ran a kernel or a
    copy (the union of their intervals)."""
    total, end = 0, None
    for _, s, t, _ in summary["device"]:
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def host_timeline(host: list) -> list:
    """[(start, end, name)]: the stretches of the host's time, each named
    by the innermost operation open then (``"host, no operation"`` where
    none is), from properly nested intervals."""
    edges = sorted([(s, 1, -t, i) for i, (_, s, t) in enumerate(host)]
                   + [(t, 0, -s, i) for i, (_, s, t) in enumerate(host)])
    out, stack, at = [], [], None
    for when, opens, _, i in edges:
        if at is not None and when > at:
            out.append((at, when, host[stack[-1]][0] if stack
                        else "host, no operation"))
        at = when
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return out


def idle_gaps(summary: dict) -> list:
    """[(what the host was doing, ns)]: every stretch of the sub-window in
    which the device ran nothing, split by the innermost host operation
    open during it (``"host, no operation"`` where none is: Python and
    NumPy between operations)."""
    w0, w1 = summary["window"]
    gaps, at = [], w0
    for _, s, t, _ in summary["device"]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    timeline = host_timeline(summary["host"])
    timeline = ([(w0, timeline[0][0], "host, no operation")] if timeline
                else [(w0, w1, "host, no operation")]) + timeline
    if timeline[-1][1] < w1:
        timeline.append((timeline[-1][1], w1, "host, no operation"))
    out, j = [], 0
    for g0, g1 in gaps:
        while j < len(timeline) and timeline[j][1] <= g0:
            j += 1
        k = j
        while k < len(timeline) and timeline[k][0] < g1:
            s, t, name = timeline[k]
            out.append((name, min(t, g1) - max(s, g0)))
            k += 1
    return [(n, ns) for n, ns in out if ns > 0]


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, in seconds, ``top`` of each."""
    ops, idle = {}, {}
    for name, s, t, _ in summary["device"]:
        key = short_name(name)
        ops[key] = ops.get(key, 0) + (t - s)
    for name, ns in idle_gaps(summary):
        idle[name] = idle.get(name, 0) + ns

    def rank(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
