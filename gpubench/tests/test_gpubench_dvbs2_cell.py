"""The committed DVB-S2 cell (``dvbs2-et50-1.6dB``): what its configuration
and traffic files hold, that they lie under the benchmark's paths, and the
metric lists of ``BENCHMARK.json`` that name it.  Its decode on the CPU,
bit for bit against the reference, is held by ``test_gpubench_minsum_et``
and ``test_gpubench_data_driven``."""

import json

import pytest

from gpubench.spec import load_cell

from .conftest import ROOT

CELL = "dvbs2-et50-1.6dB"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

# the lists the cell joins: the flagship's, and the merge's share
LISTS = ("info_bits_per_s", "batch_ms_p95", "kernels_per_batch",
         "glue_ms_per_batch", "b2_roofline_pct", "b1_roofline_pct",
         "b5_roofline_pct", "b6_roofline_pct", "device_idle_pct",
         "loop_idle_ms_per_batch", "decode_idle_ms_per_batch",
         "et_merge_roofline_pct")


def test_the_cell_runs_the_dvbs2_decode():
    cell = load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["code"] == "dvbs2_1_2_qc"
    assert cell.config["family"] == "minsum"
    assert cell.config["decoder"] == {"variant": "plain", "iterations": 50,
                                      "early_termination": True}
    assert cell.config["precision"] == {
        "channel": "float32", "storage": "float16", "arith": "float32"}
    assert cell.config["control"] == {
        "channel": "bfloat16", "storage": "float8_e4m3fn",
        "arith": "bfloat16"}
    assert cell.config["limits"] == {
        "chan_max_err": 1e-4, "frames_differ": 1e-3, "count_gap": 1e-4}
    t = cell.traffic
    assert (t["mode"], t["snr_db"], t["batch"], t["check_frames"],
            t["trace_seconds"], t["trace_batches"]) == (
        "simulate", [1.6], 8192, 8192, 3.0, 200)


def test_the_files_lie_under_the_paths():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    (c,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
    files = [c["file"], f"gpubench/traffic/{w['traffic']}.json"]
    for f in files:
        assert (ROOT / f).is_file()
        assert any(f.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("name", LISTS)
def test_the_cell_is_listed(name):
    (m,) = [m for m in BENCH["end_to_end"] + BENCH["per_layer"]
            if m["name"] == name]
    assert CELL in m["workloads"]
