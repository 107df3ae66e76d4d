"""The BP cell's variable-node layer (``bp_vn_roofline_pct``): its byte and
operation counts, its reading of the span ``ldpc.decode.bp_vn`` by launch
order, nothing read from a program without the span, and the span's idle
time counted as the decoder's."""

import pytest

from gpubench.metrics import (
    _launch_spans,
    bp_vn_roofline_pct,
    decode_idle_ms_per_batch,
    loop_idle_ms_per_batch,
)
from gpubench.reference import codes

from .helpers import small_cell
from .test_gpubench_imports import BENCH, JAX, top_level_imports

CELL = "bp-et20-2.0dB"
H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000  # ns
K = "void k<float>(float)"
SPAN = bp_vn_roofline_pct.SPAN


@pytest.fixture(scope="module")
def graph():
    return codes.graph(codes.load_table("qc_1008_504"))


def test_vn_update_bytes(graph):
    # c2v read and the posterior written in f32, v2c' in f16, y in f32
    nbytes = bp_vn_roofline_pct.call_bytes(graph.e, graph.n, 32768, 4, 2, 4)
    assert round(nbytes / 1e6, 1) == 858.8
    assert round(nbytes / 3.35e9, 4) == 0.2564  # ms, the layer's least time
    ops = bp_vn_roofline_pct.call_ops(graph.e, graph.n, 32768)
    assert ops == 32768 * (4 * 3024 + 1008)
    assert ops / 67e12 < nbytes / 3.35e12 / 10  # the bytes bound it


def summary_of(host, kernels, batches=1):
    return {"window": (0, 100 * MS), "batches": batches, "host": host,
            "device": [(K, s, t, "kernel") for s, t in kernels]}


def launches(*starts):
    return [("cudaLaunchKernel", s * MS, s * MS + 5000) for s in starts]


def ctx_of(summary):
    cell = small_cell(CELL, batch=32768)
    g = codes.graph(codes.load_table("qc_1008_504"))
    return {"summary": summary, "batches": 1, "cell": cell, "graph": g,
            "batch": 32768, "kind": H100, "hand_kernels": ()}


# a round: the check update's kernel at 1 ms, B9's at 3 ms, the exit check's
# at 5 ms; two rounds
KERNELS = [(10 * MS, 12 * MS), (12 * MS, 12 * MS + 300_000),
           (13 * MS, 14 * MS), (20 * MS, 22 * MS),
           (22 * MS, 22 * MS + 340_000), (23 * MS, 24 * MS)]
HOST = ([("ldpc.decode.bp_check", 0, 2 * MS), (SPAN, 2 * MS, 4 * MS),
         ("ldpc.decode.bp_check", 8 * MS, 9 * MS), (SPAN, 9 * MS, 10 * MS)]
        + launches(1, 3, 5, 8.5, 9.5, 11))


def test_the_span_reads_its_kernels_alone():
    secs = _launch_spans.per_span(summary_of(HOST, KERNELS), SPAN)
    assert secs == pytest.approx([0.3e-3, 0.34e-3])
    ctx = ctx_of(summary_of(HOST, KERNELS))
    least = bp_vn_roofline_pct.call_bytes(
        ctx["graph"].e, ctx["graph"].n, 32768, 4, 2, 4) / 3.35e12
    assert bp_vn_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * least / 0.64e-3)


def test_a_program_without_the_span_reads_nothing():
    host = [s for s in HOST if s[0] != SPAN]
    ctx = ctx_of(summary_of(host, KERNELS))
    assert _launch_spans.per_span(ctx["summary"], SPAN) is None
    assert bp_vn_roofline_pct.read(ctx) is None


def test_the_bp_cell_alone_reports_it():
    mine = [m for m in small_cell(CELL).per_layer
            if m["name"] == "bp_vn_roofline_pct"]
    assert mine and mine[0]["layer"] == bp_vn_roofline_pct.LAYER
    assert mine[0]["moves"] == bp_vn_roofline_pct.MOVES
    for other in ("minsum-fixed-2.0dB", "smngdbf-3.25dB",
                  "minsum-b1024-2.0dB", "minsum-grid4-4chip"):
        assert "bp_vn_roofline_pct" not in [
            m["name"] for m in small_cell(other).per_layer]


def test_idle_under_the_span_is_the_decoders():
    # the card idles 40-50 ms; the host is inside the VN span 38-45 ms
    dev = [(K, 0, 40 * MS, "kernel"), (K, 50 * MS, 100 * MS, "kernel")]
    host = [("ldpc.batch", 0, 100 * MS), ("ldpc.decode", 30 * MS, 60 * MS),
            (SPAN, 38 * MS, 45 * MS)]
    ctx = {"summary": {"window": (0, 100 * MS), "host": host,
                       "device": dev}, "batches": 1}
    assert decode_idle_ms_per_batch.read(ctx) == pytest.approx(10.0)
    assert loop_idle_ms_per_batch.read(ctx) == 0.0


def test_the_reader_imports_no_jax():
    assert not top_level_imports(
        BENCH / "metrics/bp_vn_roofline_pct.py") & JAX
