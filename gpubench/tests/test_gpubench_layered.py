"""The 802.11n layered cell (``wifi-layered-et30-2.2dB``): the frozen table
against the program's 802.11n code, the plain layered reference against the
program's ``decode_minsum_layered_qc`` on the CPU bit for bit (decisions,
round counts, satisfied flags, the f32 posterior), the cell's files and the
lists of ``BENCHMARK.json`` that name it, and the layer step's reader."""

import json

import numpy as np
import pytest
import torch

from gpubench.families import minsum_layered as fam
from gpubench.metrics import _launch_spans, layer_step_roofline_pct
from gpubench.reference import Precision, codes, philox, sigma_of
from gpubench.reference import minsum_layered as ref
from gpubench.spec import load_cell

from .conftest import ROOT
from .helpers import run_cpu, small_cell
from .test_gpubench_codes import HAND, built

CELL = "wifi-layered-et30-2.2dB"
CODE = "wifi_1944_972"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2 ** 31 + 8191
F16 = Precision()
CONTROL = Precision(torch.bfloat16, torch.float8_e4m3fn, torch.bfloat16)
ALPHA = 1.25
T = 5
#: frames clean at the channel (0 rounds), in the waterfall, and beyond the
#: decoder's reach (all T rounds, never satisfied)
POINTS = [(16.0, 8), (2.5, 48), (-1.0, 8)]
H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000  # ns

# the lists the cell joins; B1's and B5's shares count the whole graph a
# call and stay off it
LISTS = ("info_bits_per_s", "batch_ms_p95", "kernels_per_batch",
         "glue_ms_per_batch", "b2_roofline_pct", "b6_roofline_pct",
         "device_idle_pct", "loop_idle_ms_per_batch",
         "decode_idle_ms_per_batch", "et_merge_roofline_pct",
         "layer_step_roofline_pct")
NOT_LISTED = ("b1_roofline_pct", "b5_roofline_pct", "b7_roofline_pct",
              "b4_roofline_pct", "bp_check_roofline_pct",
              "bp_vn_roofline_pct")


def samples(n: int) -> torch.Tensor:
    parts, frame0 = [], 0
    for snr, count in POINTS:
        frames = frame0 + torch.arange(count)
        parts.append(philox.channel(SEED, frames, n, sigma_of(snr, 0.5)))
        frame0 += count
    return torch.cat(parts)


def program(qc, y, T, early):
    from ldpcsimulation_tpu_torch.decoders.minsum_layered import (
        decode_minsum_layered_qc,
    )

    return decode_minsum_layered_qc(qc, y, T, variant="normalized",
                                    alpha=ALPHA, early_termination=early,
                                    storage_dtype=torch.float16)


def test_frozen_table_is_the_standard():
    from ldpcsimulation_tpu_torch.codes.standards import wifi_1944_rate12_qc

    want = wifi_1944_rate12_qc()
    t, g, qc = built(CODE)
    assert "extra" not in t and "minus" not in t
    assert t["z"] == want.z == 81
    assert tuple(tuple(r) for r in t["base"]) == tuple(
        tuple(int(s) for s in r) for r in want.base)
    assert (g.n, g.m, g.e) == (1944, 972, 7047)
    base = np.array(t["base"])
    assert [int(d) for d in (base >= 0).sum(axis=1)] == [
        7, 7, 7, 7, 7, 7, 8, 7, 7, 7, 8, 8]
    assert sorted({int(d) for d in (base >= 0).sum(axis=0)}) == [2, 3, 4, 11]
    code = qc.to_code("cpu")
    assert torch.equal(g.check_cols,
                       torch.where(code.cn_mask, code.cn_vn.long(), g.n))


@pytest.mark.parametrize("early", [True, False])
def test_reference_equals_program(early):
    _, g, qc = built(CODE)
    y = samples(g.n)
    hard, its, sat = ref.decode(g, built(CODE)[0], y, T, ALPHA, F16, early)
    res = program(qc, y, T, early)
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert bool(((its == T) & ~sat).any())  # never satisfied
    assert bool(sat.any())
    if early:
        assert bool((its == 0).any())  # satisfied at the channel
        assert bool(((its > 0) & (its < T) & sat).any())


def test_posterior_equals_program_bit_for_bit():
    from ldpcsimulation_tpu_torch.decoders.minsum_layered import (
        layered_l0,
        qc_minsum_layered_step,
    )

    t, g, qc = built(CODE)
    y = samples(g.n)
    step = qc_minsum_layered_step(qc, "normalized", ALPHA,
                                  storage_dtype=torch.float16)
    state = (y.t().contiguous(),
             layered_l0(qc, y.shape[0], torch.float16, "cpu"))
    for _ in range(T):
        state = step(state)[0]
    want = ref.posterior(g, t, y, T, ALPHA, F16).contiguous()
    assert torch.equal(state[0].t().contiguous().view(torch.int32),
                       want.view(torch.int32))


def test_control_differs():
    """The reference one precision step lower (bf16 channel and
    arithmetic, fp8 messages) moves decisions or round counts."""
    t, g, _ = built(CODE)
    y = samples(g.n)
    want = ref.decode(g, t, y, 30, ALPHA, F16, True)
    got = ref.decode(g, t, y.to(torch.bfloat16).float(), 30, ALPHA,
                     CONTROL, True)
    differ = ((got[0] < 0) != (want[0] < 0)).any(dim=1) | (
        got[1] != want[1]) | (got[2] != want[2])
    assert int(differ.sum()) > 0


def test_quantizer_equals_the_programs():
    """The sweep's ``quantize_no_zero`` (Ymax 2.0, 8 levels), bit for bit,
    on channel samples and on zeros of both signs, the levels themselves,
    values past ±Ymax and a value that floors to 0."""
    from ldpcsimulation_tpu_torch.channel.quantize import quantize_no_zero

    y = samples(1944).flatten()
    edges = torch.tensor([0.0, -0.0, 2.0, -2.0, 2.0000002, -7.5, 4 / 7,
                          -4 / 7, 8 / 7, 1e-9, -1e-9])
    y = torch.cat([y, edges])
    got = ref.quantize(y, 2.0, 8)
    assert torch.equal(got.view(torch.int32),
                       quantize_no_zero(y, 2.0, 8).view(torch.int32))
    assert len(torch.unique(got)) == 8  # 8 levels, none of them 0


def test_pairs_are_refused_by_name():
    t, g, _ = built(HAND["name"])
    with pytest.raises(ValueError, match="extra circulants"):
        ref.decode(g, t, torch.ones(2, g.n), 1, ALPHA, F16)


def test_other_variants_are_refused_by_name():
    cell = small_cell(CELL)
    cell.config["decoder"]["variant"] = "offset"
    g = built(CODE)[1]
    with pytest.raises(NotImplementedError, match="offset"):
        fam.reference(cell.config, g, SEED, torch.arange(2), 0.7, F16)


def test_the_cell_runs_correct_on_the_cpu():
    """The cell through ``simulate`` and the family's port at 64 frames a
    batch and T=5: every kept batch agrees with the reference."""
    got = run_cpu(small_cell(CELL, batch=64, iterations=T), seconds=0.5)
    assert got["correct"] is True
    assert sorted(got["metrics"]) == ["batch_ms_p95", "info_bits_per_s",
                                      "peak_mem_gib", "setup_s"]
    assert all(v["value"] == 0 for v in got["checks"].values())


def test_the_port_is_the_sweeps_layered_route():
    cell = load_cell(ROOT, CELL)
    port = fam.Port(cell.config, codes.load_table(CODE), "cpu")
    assert port.T == 30
    assert port.kw == dict(variant="normalized", alpha=1.25,
                           early_termination=True,
                           storage_dtype=torch.float16)
    assert port.code.rate == 0.5
    assert port.quantizer == {"ymax": 2.0, "levels": 8}
    pre = port.batch_decoder(0.7)[1]
    y = samples(1944)
    assert torch.equal(pre(y), ref.quantize(y, 2.0, 8))
    with pytest.raises(NotImplementedError, match="one card"):
        port.grid_decoder()


def test_the_cell_runs_the_layered_decode():
    cell = load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["code"] == CODE
    assert cell.config["family"] == "minsum_layered"
    assert cell.config["decoder"] == {"variant": "normalized",
                                      "alpha": 1.25, "iterations": 30,
                                      "early_termination": True}
    assert cell.config["precision"] == {
        "channel": "float32", "storage": "float16", "arith": "float32"}
    assert cell.config["control"] == {
        "channel": "bfloat16", "storage": "float8_e4m3fn",
        "arith": "bfloat16"}
    assert cell.config["limits"] == {
        "chan_max_err": 1e-4, "frames_differ": 1e-3, "count_gap": 1e-4}
    assert cell.config["quantizer"] == {"ymax": 2.0, "levels": 8}
    assert cell.config["reduced"] == []
    t = cell.traffic
    assert (t["mode"], t["snr_db"], t["batch"], t["check_frames"],
            t["trace_seconds"], t["trace_batches"]) == (
        "simulate", [2.2], 32768, 65536, 3.0, 200)


def test_the_files_lie_under_the_paths():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    (c,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    assert c["reduced"] == [] and len(c["source"]) <= 200
    files = [c["file"], f"gpubench/traffic/{w['traffic']}.json",
             f"gpubench/codes/{CODE}.json"]
    for f in files:
        assert (ROOT / f).is_file()
        assert any(f.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("name", LISTS)
def test_the_cell_is_listed(name):
    (m,) = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
            if m["name"] == name]
    assert CELL in m["workloads"]


@pytest.mark.parametrize("name", NOT_LISTED)
def test_the_cell_is_not_listed(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert CELL not in m["workloads"]


def test_the_layer_metric_entry():
    (m,) = [m for m in BENCH["per_layer"]
            if m["name"] == "layer_step_roofline_pct"]
    assert m == {"name": "layer_step_roofline_pct", "unit": "%",
                 "better": "higher", "source": "device_trace",
                 "layer": layer_step_roofline_pct.LAYER,
                 "moves": layer_step_roofline_pct.MOVES,
                 "workloads": [CELL]}


# --- the layer step's reader -------------------------------------------

DEGREES = [7, 7, 7, 7, 7, 7, 8, 7, 7, 7, 8, 8]


def test_layer_sizes():
    """Each layer meets each of its columns once: as many columns as
    edges, 81 a circulant."""
    sizes = layer_step_roofline_pct.layer_sizes(built(CODE)[1], 81)
    assert sizes == [(81 * d, 81 * d) for d in DEGREES]


@pytest.mark.parametrize("degree, nbytes", [
    # 81·d columns read and written in f32, 81·d messages read and
    # written in f16: 12 bytes an edge-lane
    (7, 32768 * (567 * 2 * 4 + 567 * 2 * 2)),
    (8, 32768 * (648 * 2 * 4 + 648 * 2 * 2)),
])
def test_layer_bytes(degree, nbytes):
    edges = 81 * degree
    assert layer_step_roofline_pct.call_bytes(edges, edges, 32768, 4,
                                              2) == nbytes
    assert nbytes == 12 * edges * 32768
    ops = layer_step_roofline_pct.call_ops(edges, 32768)
    assert ops == 6 * edges * 32768
    assert ops / 67e12 < nbytes / 3.35e12 / 10  # the bytes bound it


def test_a_round_at_the_cells_width():
    """2.77 GB a round of 12 layers at B=32768: 0.827 ms at 3.35 TB/s."""
    total = sum(layer_step_roofline_pct.call_bytes(
        81 * d, 81 * d, 32768, 4, 2) for d in DEGREES)
    assert total == 2_770_993_152
    assert round(total / 3.35e9, 3) == 0.827  # ms


def ranges(count):
    """``count`` layer ranges 1 ms apart, each launching two kernels of
    0.4 ms; an exit check's launch between each 12."""
    host, kernels = [], []
    for i in range(count):
        s = (10 + i) * MS
        host += [(layer_step_roofline_pct.SPAN, s, s + MS // 2),
                 ("cudaLaunchKernel", s + 1000, s + 2000),
                 ("cudaLaunchKernel", s + 3000, s + 4000)]
        kernels += [(s + MS // 2, s + MS // 2 + 200_000),
                    (s + MS // 2 + 200_000, s + MS // 2 + 400_000)]
        if i % 12 == 11:
            host.append(("cudaLaunchKernel", s + 600_000, s + 601_000))
            kernels.append((s + 950_000, s + 960_000))
    return host, kernels


def ctx_of(host, kernels):
    summary = {"window": (0, 100 * MS), "batches": 1, "host": host,
               "device": [("void k<float>(float)", s, t, "kernel")
                          for s, t in kernels]}
    return {"summary": summary, "batches": 1,
            "cell": small_cell(CELL, batch=32768),
            "graph": built(CODE)[1], "batch": 32768, "kind": H100,
            "hand_kernels": ()}


def test_the_span_reads_each_layer():
    ctx = ctx_of(*ranges(24))
    secs = _launch_spans.per_span(ctx["summary"],
                                  layer_step_roofline_pct.SPAN)
    assert secs == pytest.approx([4e-4] * 24)
    least = 2 * 2_770_993_152 / 3.35e12
    assert layer_step_roofline_pct.read(ctx) == pytest.approx(
        100 * least / (24 * 4e-4))


def test_launches_outside_the_batches_are_left_out():
    """The profiler's start-up launches before the first batch (a fill and
    a sum, whose kernels the summary does not hold) unpair every launch
    from its kernel; inside the program's ``ldpc.batch`` ranges the layers
    read as without them."""
    host, kernels = ranges(24)
    warm = [("cudaLaunchKernel", 2 * MS, 2 * MS + 1000),
            ("cudaLaunchKernel", 3 * MS, 3 * MS + 1000)]
    batches = [("ldpc.batch", 9 * MS, 22 * MS), ("ldpc.batch", 22 * MS,
                                                 35 * MS)]
    ctx = ctx_of(warm + host + batches, kernels)
    assert _launch_spans.per_span(ctx["summary"],
                                  layer_step_roofline_pct.SPAN) is None
    assert layer_step_roofline_pct.read(ctx) == pytest.approx(
        layer_step_roofline_pct.read(ctx_of(host, kernels)))


def test_a_count_of_ranges_off_the_layers_reads_nothing():
    assert layer_step_roofline_pct.read(ctx_of(*ranges(13))) is None


def test_a_program_without_the_span_reads_nothing():
    host, kernels = ranges(24)
    host = [h for h in host if h[0] != layer_step_roofline_pct.SPAN]
    assert layer_step_roofline_pct.read(ctx_of(host, kernels)) is None


def test_the_name_is_the_programs():
    """The reader matches the program's span by name, without importing
    the program (so it reads nothing from a program without the span)."""
    from ldpcsimulation_tpu_torch import spans

    assert layer_step_roofline_pct.SPAN == spans.LAYER_STEP
