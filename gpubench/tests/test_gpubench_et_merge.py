"""The early-termination decision merge's layer (``et_merge_roofline_pct``):
its byte and operation counts on both codes the cells run, its reading of
the span ``ldpc.decode.et_merge`` by launch order, nothing read from a
program without the span, and the cells that report it."""

import pytest

from gpubench.metrics import _launch_spans, et_merge_roofline_pct
from gpubench.reference import codes

from .helpers import small_cell

H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000  # ns
K = "void k<float>(float)"
SPAN = et_merge_roofline_pct.SPAN
ET_CELLS = ("bp-et20-2.0dB", "dvbs2-et50-1.6dB")


@pytest.mark.parametrize("code, batch, nbytes, ops", [
    # n (4 + 1) + 5 bytes a lane: the f32 posterior read, the int8
    # decisions written, done read, the int32 count written; 3 operations
    # a column-lane
    ("qc_1008_504", 32768, 32768 * (1008 * 5 + 5), 32768 * 3 * 1008),
    ("dvbs2_1_2_qc", 8192, 8192 * (64800 * 5 + 5), 8192 * 3 * 64800),
])
def test_merge_bytes_and_ops(code, batch, nbytes, ops):
    n = codes.graph(codes.load_table(code)).n
    assert et_merge_roofline_pct.call_bytes(n, batch, 4) == nbytes
    assert et_merge_roofline_pct.call_ops(n, batch) == ops
    assert ops / 67e12 < nbytes / 3.35e12 / 10  # the bytes bound it


def test_dvbs2_least_time_a_round():
    nbytes = et_merge_roofline_pct.call_bytes(64800, 8192, 4)
    assert round(nbytes / 1e9, 3) == 2.654
    assert round(nbytes / 3.35e9, 3) == 0.792  # ms


def summary_of(host, kernels):
    return {"window": (0, 100 * MS), "batches": 1, "host": host,
            "device": [(K, s, t, "kernel") for s, t in kernels]}


def launches(*starts):
    return [("cudaLaunchKernel", s * MS, s * MS + 5000) for s in starts]


def ctx_of(summary, cell="dvbs2-et50-1.6dB", code="dvbs2_1_2_qc",
           batch=8192):
    return {"summary": summary, "batches": 1,
            "cell": small_cell(cell, batch=batch),
            "graph": codes.graph(codes.load_table(code)), "batch": batch,
            "kind": H100, "hand_kernels": ()}


# a round: the update's kernel, the merge's two kernels, the parity check;
# two rounds
KERNELS = [(10 * MS, 14 * MS), (14 * MS, 15 * MS), (15 * MS, 16 * MS),
           (16 * MS, 17 * MS), (20 * MS, 24 * MS), (24 * MS, 25 * MS),
           (25 * MS, 26 * MS), (26 * MS, 27 * MS)]
HOST = ([("ldpc.decode.exit_check", 0, 1 * MS), (SPAN, 2 * MS, 4 * MS),
         ("ldpc.decode.exit_check", 6 * MS, 7 * MS),
         (SPAN, 8 * MS, 9 * MS)]
        + launches(1.5, 2.5, 3.5, 5, 7.5, 8.2, 8.6, 9.5))


def test_the_span_reads_its_kernels_alone():
    secs = _launch_spans.per_span(summary_of(HOST, KERNELS), SPAN)
    assert secs == pytest.approx([2e-3, 2e-3])
    ctx = ctx_of(summary_of(HOST, KERNELS))
    least = et_merge_roofline_pct.call_bytes(64800, 8192, 4) / 3.35e12
    assert et_merge_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * least / 4e-3)


def test_the_bp_cell_reads_at_its_width():
    ctx = ctx_of(summary_of(HOST, KERNELS), "bp-et20-2.0dB", "qc_1008_504",
                 32768)
    least = et_merge_roofline_pct.call_bytes(1008, 32768, 4) / 3.35e12
    assert et_merge_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * least / 4e-3)


def test_a_program_without_the_span_reads_nothing():
    host = [s for s in HOST if s[0] != SPAN]
    ctx = ctx_of(summary_of(host, KERNELS))
    assert _launch_spans.per_span(ctx["summary"], SPAN) is None
    assert et_merge_roofline_pct.read(ctx) is None


def test_the_early_terminating_cells_alone_report_it():
    for name in ET_CELLS:
        mine = [m for m in small_cell(name).per_layer
                if m["name"] == "et_merge_roofline_pct"]
        assert mine and mine[0]["layer"] == et_merge_roofline_pct.LAYER
        assert mine[0]["moves"] == et_merge_roofline_pct.MOVES
    for other in ("minsum-fixed-2.0dB", "smngdbf-3.25dB",
                  "minsum-b1024-2.0dB", "minsum-grid4-4chip"):
        assert "et_merge_roofline_pct" not in [
            m["name"] for m in small_cell(other).per_layer]


def test_the_name_is_the_programs():
    """The reader matches the program's span by name, without importing
    the program (so it reads nothing from a program without the span)."""
    from ldpcsimulation_tpu_torch import spans

    assert SPAN == spans.ET_MERGE
