"""The idle readers by program span (``metrics/_spans.py``,
``loop_idle_ms_per_batch``, ``decode_idle_ms_per_batch``) on synthetic
sub-windows."""

import pytest

from gpubench.metrics import (
    _spans,
    decode_idle_ms_per_batch,
    device_idle_pct,
    loop_idle_ms_per_batch,
)
from gpubench.modes import common
from gpubench.reference import codes

from .helpers import small_cell

MS = 1_000_000  # ns
K = "void k<int>(int)"


def ctx_of(host, device, batches=1, window=(0, 100 * MS)):
    return {"summary": {"window": window, "host": host, "device": device},
            "batches": batches}


def one_batch(*inner):
    """A batch of 100 ms: the card busy but for 10–20, 40–50 and 80–90 ms;
    the host's ``ldpc.batch`` from 5 to 95 ms with ``inner`` in it."""
    dev = [(K, 0, 10 * MS, "kernel"), (K, 20 * MS, 40 * MS, "kernel"),
           (K, 50 * MS, 80 * MS, "kernel"), (K, 90 * MS, 100 * MS, "kernel")]
    return ctx_of([("ldpc.batch", 5 * MS, 95 * MS), *inner], dev)


def test_copy_under_to_host_is_loop_idle():
    ctx = one_batch(("ldpc.to_host", 75 * MS, 92 * MS),
                    ("aten::copy_", 78 * MS, 91 * MS))
    # the gap 80-90 under aten::copy_, inside ldpc.to_host; the other two
    # under ldpc.batch alone: all the loop's
    assert loop_idle_ms_per_batch.read(ctx) == pytest.approx(30.0)
    assert decode_idle_ms_per_batch.read(ctx) == 0.0


def test_exit_check_is_decode_idle():
    ctx = one_batch(("ldpc.decode", 30 * MS, 60 * MS),
                    ("ldpc.decode.exit_check", 38 * MS, 45 * MS),
                    ("cudaStreamSynchronize", 39 * MS, 44 * MS))
    # 40-45 under the check, 45-50 under the decode: the decoder's
    assert decode_idle_ms_per_batch.read(ctx) == pytest.approx(10.0)
    assert loop_idle_ms_per_batch.read(ctx) == pytest.approx(20.0)


def test_outside_every_span_counts_in_neither():
    ctx = one_batch()
    ctx["summary"]["host"] = [("ldpc.batch", 15 * MS, 85 * MS),
                              ("aten::copy_", 85 * MS, 95 * MS)]
    # 10-15 and 85-90 lie outside ldpc.batch: 10 of the 30 idle ms
    assert loop_idle_ms_per_batch.read(ctx) == pytest.approx(20.0)
    assert decode_idle_ms_per_batch.read(ctx) == 0.0
    assert _spans.idle_by_span(ctx["summary"]) == {"ldpc.batch": 20 * MS}


def test_the_two_cover_the_idle_time_inside_the_spans():
    ctx = one_batch(("ldpc.channel", 6 * MS, 18 * MS),
                    ("ldpc.decode", 18 * MS, 70 * MS),
                    ("ldpc.decode.exit_check", 42 * MS, 44 * MS),
                    ("ldpc.count", 70 * MS, 75 * MS),
                    ("ldpc.to_host", 75 * MS, 90 * MS))
    ctx["summary"]["host"][0] = ("ldpc.batch", 0, 100 * MS)
    ctx["batches"] = 2
    loop = loop_idle_ms_per_batch.read(ctx)
    decode = decode_idle_ms_per_batch.read(ctx)
    # 10-18 and 80-90 the loop's, 18-20 and 40-50 the decoder's
    assert (loop, decode) == (pytest.approx(9.0), pytest.approx(6.0))
    window_ms = 100
    idle_ms = device_idle_pct.read(ctx) / 100 * window_ms / ctx["batches"]
    assert loop + decode == pytest.approx(idle_ms)


def test_a_program_without_spans_reads_nothing():
    ctx = one_batch()
    ctx["summary"]["host"] = [("aten::copy_", 0, 100 * MS)]
    assert loop_idle_ms_per_batch.read(ctx) is None
    assert decode_idle_ms_per_batch.read(ctx) is None
    ctx["batches"] = 0
    ctx["summary"]["host"] = one_batch()["summary"]["host"]
    assert loop_idle_ms_per_batch.read(ctx) is None


@pytest.mark.parametrize("name,suffix", [
    ("minsum-fixed-2.0dB", ""), ("smngdbf-3.25dB", ""),
    ("minsum-b1024-2.0dB", ".host_paced"), ("minsum-grid4-4chip", ".grid")])
def test_each_cell_reads_its_half(name, suffix):
    cell = small_cell(name)
    g = codes.graph(codes.load_table(cell.config["code"]))
    summary = one_batch(("ldpc.decode", 30 * MS, 60 * MS))["summary"]
    summary["batches"] = 1
    out = common.per_layer(cell, summary, g)
    assert out["loop_idle_ms_per_batch" + suffix] == {
        "value": pytest.approx(20.0), "unit": "ms/batch"}
    assert out["decode_idle_ms_per_batch" + suffix] == {
        "value": pytest.approx(10.0), "unit": "ms/batch"}


def test_the_grid_reads_the_highest_card():
    cell = small_cell("minsum-grid4-4chip")
    cards = [one_batch(("ldpc.decode", 30 * MS, 30 * MS + d * MS))
             for d in (12, 25, 18, 5)]
    for m, want in (("loop_idle_ms_per_batch.grid", 30.0),
                    ("decode_idle_ms_per_batch.grid", 10.0)):
        assert m in [e["name"] for e in cell.per_layer]
        mod = cell.metric_module(m)
        assert mod.ACROSS_CARDS([mod.read(c) for c in cards]) == (
            pytest.approx(want))
    # each card's decode ends 42, 55, 48 and 35 ms in: of its idle 40-50
    decode = [decode_idle_ms_per_batch.read(c) for c in cards]
    loop = [loop_idle_ms_per_batch.read(c) for c in cards]
    assert decode == pytest.approx([2.0, 10.0, 8.0, 0.0])
    assert loop == pytest.approx([28.0, 20.0, 22.0, 30.0])
