"""The per-layer metrics' arithmetic on a synthetic sub-window."""

import pytest

from gpubench import roofline, trace
from gpubench.modes import common
from gpubench.metrics import (
    b1_roofline_pct,
    b2_roofline_pct,
    b6_roofline_pct,
    b7_roofline_pct,
    device_idle_pct,
    glue_ms_per_batch,
    kernels_per_batch,
)
from gpubench.reference import codes

from .helpers import small_cell

H100 = "NVIDIA H100 80GB HBM3"
B2 = ("void (anonymous namespace)::awgn_philox_kernel<true, false>"
      "(unsigned int, float*, int*)")
B1 = ("void (anonymous namespace)::minsum_cn_lanes_kernel<__half, 4, "
      "__half>(__half const*, int const*, __half*)")
B6 = ("void (anonymous namespace)::parity_check_kernel<signed char, 16>"
      "(long const*, signed char const*, bool*, signed char*)")
B7 = ("void (anonymous namespace)::gdbf_step_kernel<signed char, 4, true, "
      "false>(signed char*, float const*)")
GLUE = "void at::native::vectorized_elementwise_kernel<4, X>(int, X)"
MS = 1_000_000  # ns


def ctx_of(cell, device, batches=1):
    g = codes.graph(codes.load_table(cell.config["code"]))
    return {"summary": {"window": (0, 100 * MS), "device": device,
                        "host": [("aten::copy_", 0, 100 * MS)]},
            "batches": batches, "cell": cell, "graph": g,
            "batch": cell.traffic["batch"], "kind": H100,
            "hand_kernels": common.hand_kernels(cell)}


@pytest.fixture
def minsum_ctx():
    cell = small_cell("minsum-fixed-2.0dB", batch=32768)
    dev = [(B2, 0, 1 * MS, "kernel"), (B1, 2 * MS, 3 * MS, "kernel"),
           (B1, 3 * MS, 4 * MS, "kernel"), (GLUE, 5 * MS, 8 * MS, "kernel"),
           ("Memcpy DtoH (Device -> Pageable)", 9 * MS, 10 * MS, "copy")]
    return ctx_of(cell, dev, batches=2)


def test_counts_and_glue(minsum_ctx):
    assert kernels_per_batch.read(minsum_ctx) == 2.0
    assert glue_ms_per_batch.read(minsum_ctx) == pytest.approx(1.5)


class Event:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start, end, device=False, corr=0, thread=1):
        self._name, self._s, self._t = name, start, end
        self._dev, self._corr, self._thread = device, corr, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return False


def traced_batches(n, lose=()):
    """Raw events of ``n`` traced batches of 100 ns, each launching B2, B1
    and a copy; ``lose``: (batch, kernel) device records left out."""
    ev = [Event("cudaLaunchKernel", 1, 2, corr=1),  # before the first batch
          Event("void warm<int>(int)", 3, 4, device=True, corr=1)]
    for i in range(n):
        at = 10 + 100 * i
        ev.append(Event(trace.MARK, at, at + 90))
        for j, (name, kind) in enumerate([(B2, "cudaLaunchKernel"),
                                          (B1, "cudaLaunchKernel"),
                                          ("Memcpy DtoH", "cudaMemcpyAsync")]):
            corr = 10 * i + j + 10
            ev.append(Event(kind, at + 1 + j, at + 2 + j, corr=corr))
            if (i, name) not in lose:
                # the device's clock set a little apart from the host's:
                # B2 seems to start before its batch's range, and the last
                # batch's B1 to end after it
                s = at - 1 if name == B2 else at + 10 * j + 5
                t = at + 95 if (i, name) == (n - 1, B1) else at + 10 * j + 9
                ev.append(Event(name, s, t, device=True, corr=corr))
    return ev


def test_summary_spans_whole_batches():
    s = trace.summarize(traced_batches(4))
    assert s["batches"] == 4 and s["window"] == (9, 405)
    assert sum(kind == "kernel" for *_, kind in s["device"]) == 8
    assert s["device"][0] == (B2, 9, 19, "kernel")
    assert (B1, 325, 405, "kernel") in s["device"]


@pytest.mark.parametrize("lose,want", [
    ({(1, B1)}, (2, (209, 405))),  # batches 2-3
    ({(0, B2)}, (3, (109, 405))),  # the first B2, as on an H100
    ({(3, "Memcpy DtoH")}, (4, (9, 405)))])  # a copy is no kernel
def test_a_batch_that_lost_a_kernel_is_not_read(lose, want, capsys):
    s = trace.summarize(traced_batches(4, lose))
    assert (s["batches"], s["window"]) == want
    kernels = [d for d in s["device"] if d[3] == "kernel"]
    assert len(kernels) == 2 * want[0]
    assert ("lost device events" in capsys.readouterr().err) is (want[0] < 4)


def test_no_whole_batch_no_summary(capsys):
    assert trace.summarize(traced_batches(2, {(0, B1), (1, B2)})) is None
    assert "no per-layer metric" in capsys.readouterr().err


def test_window_marks_the_traced_batches():
    from gpubench.window import Window

    class Calls:
        def __init__(self):
            self.log = []

        def __getattr__(self, name):
            return lambda: self.log.append(name)

    calls = Calls()
    win = Window(seconds=1e9, trace=(2, 3, calls))
    for _ in range(8):
        win.done(0, 0, 0)
    assert calls.log == ["start", "next", "next", "stop"]


def test_idle_share_counts_copies(minsum_ctx):
    assert trace.busy_ns(minsum_ctx["summary"]) == 7 * MS
    assert device_idle_pct.read(minsum_ctx) == pytest.approx(93.0)


def test_roofline_shares(minsum_ctx):
    g = minsum_ctx["graph"]
    b1 = 2 * b1_roofline_pct.call_bytes(g.e, 32768, 2, 2) / 3.35e12
    assert b1_roofline_pct.read(minsum_ctx) == pytest.approx(
        100 * b1 / 2e-3)
    b2 = max(g.n * 32768 * 4 / 3.35e12, 12 * g.n * 32768 / 67e12)
    assert b2_roofline_pct.read(minsum_ctx) == pytest.approx(100 * b2 / 1e-3)
    assert b6_roofline_pct.read(minsum_ctx) is None  # nothing to read


def test_b7_window_steps():
    cell = small_cell("smngdbf-3.25dB", batch=32768)
    T, win = 300, 64
    dev, at = [(B2, 0, MS, "kernel")], 2 * MS
    for _ in range(T):
        dev += [(B6, at, at + 10_000, "kernel"),
                (B7, at + 20_000, at + 320_000, "kernel")]
        at += 400_000
    ctx = ctx_of(cell, dev)
    ctx["summary"]["window"] = (0, at)
    g = ctx["graph"]
    inside = b7_roofline_pct.call_bytes(g.n, g.m, 32768, 1, True, True, True)
    outside = b7_roofline_pct.call_bytes(g.n, g.m, 32768, 1, True, True,
                                         False)
    n_in = T - (T - win) - 1  # steps T - win + 1 … T - 1
    want = (n_in * inside + (T - n_in) * outside) / 3.35e12 / (T * 300e-6)
    assert b7_roofline_pct.read(ctx) == pytest.approx(100 * want)
    syn = b6_roofline_pct.call_bytes(g.n, g.m, 32768, 1, True) / 3.35e12
    assert b6_roofline_pct.read(ctx) == pytest.approx(100 * syn / 10e-6)


def test_breakdown_and_idle_gaps():
    s = {"window": (0, 100), "host": [("outer", 0, 90), ("inner", 25, 55)],
         "device": [("void k1<int>(int)", 10, 20, "kernel"),
                    ("void k2<int>(int)", 15, 30, "kernel")]}
    assert trace.idle_gaps(s) == [("outer", 10), ("inner", 25),
                                  ("outer", 35), ("host, no operation", 10)]
    s["device"].append(("Memcpy DtoH", 60, 65, "copy"))
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k2<int>", 15e-9]
    assert b["idle_gaps"] == [["outer", 40e-9], ["inner", 25e-9],
                              ["host, no operation", 10e-9]]


def test_per_layer_leaves_out_what_it_cannot_read():
    cell = small_cell("minsum-fixed-2.0dB", batch=32768)
    g = codes.graph(codes.load_table(cell.config["code"]))
    summary = {"window": (0, 10 * MS), "batches": 3, "device": [],
               "host": []}
    out = common.per_layer(cell, summary, g)
    assert "b1_roofline_pct" not in out
    assert out["kernels_per_batch"]["value"] == 0.0
    assert out["device_idle_pct"]["value"] == 100.0


def test_template_args():
    assert roofline.template_args(B7) == ["signed char", "4", "true",
                                          "false"]


def test_split_metrics_read_with_their_quantity():
    cell = small_cell("minsum-b1024-2.0dB", batch=1024)
    g = codes.graph(codes.load_table(cell.config["code"]))
    summary = {"window": (0, 10 * MS), "batches": 1, "host": [],
               "device": [(B2, 0, MS, "kernel"),
                          (GLUE, MS, 2 * MS, "kernel")]}
    out = common.per_layer(cell, summary, g)
    assert out == {
        "kernels_per_batch.host_paced": {"value": 2.0, "unit": "kernels/batch"},
        "glue_ms_per_batch.host_paced": {"value": 1.0, "unit": "ms/batch"},
        "device_idle_pct.host_paced": {"value": 80.0, "unit": "%"}}


@pytest.mark.parametrize("name,want", [
    ("minsum-fixed-2.0dB", {"info_bits_per_s", "batch_ms_p95",
                            "peak_mem_gib", "setup_s"}),
    ("minsum-b1024-2.0dB", {"batch_ms_p95.host_paced", "peak_mem_gib",
                            "setup_s"}),
    ("minsum-grid4-4chip", {"info_bits_per_s.grid", "batch_ms_p95.grid",
                            "peak_mem_gib", "setup_s"})])
def test_end_to_end_names_follow_the_cell(name, want):
    from gpubench.window import Window

    win = Window(seconds=0.0)
    win.stamps = [0.0, 0.5, 1.0]
    out = common.end_to_end(small_cell(name), win, 2048, 504, 2 ** 30, 7.0)
    assert set(out) == want
    assert out["peak_mem_gib"]["value"] == 1.0
    for rate in {"info_bits_per_s", "info_bits_per_s.grid"} & set(out):
        assert out[rate]["value"] == 2048 * 504
