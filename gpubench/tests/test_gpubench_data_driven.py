"""A configuration, a traffic mix and a per-layer metric are added by
adding files and entries: in a copy of the benchmark, new ones are listed
and loaded with no existing file edited."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

from .conftest import ROOT


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpubench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    g = tmp_path / "gpubench"
    (g / "traffic" / "awgn-2.4dB-b4096.json").write_text(json.dumps({
        "mode": "simulate", "snr_db": [2.4], "batch": 4096,
        "check_frames": 8192, "trace_seconds": 1.0, "trace_batches": 100,
        "why": "a new mix"}))
    cfg = json.loads((g / "configs" / "qc1008-minsum-t10-f16.json")
                     .read_text())
    cfg.update(name="qc1008-minsum-t5-f16")
    cfg["decoder"]["iterations"] = 5
    (g / "configs" / "qc1008-minsum-t5-f16.json").write_text(
        json.dumps(cfg))
    (g / "metrics" / "launch_share.py").write_text(textwrap.dedent('''
        LAYER = "host launch path"
        MOVES = "info_bits_per_s"

        def read(ctx):
            return 42.0
    '''))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "qc1008-minsum-t5-f16", "source": "a test",
        "file": "gpubench/configs/qc1008-minsum-t5-f16.json",
        "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({
        "name": "new-cell", "config": "qc1008-minsum-t5-f16",
        "traffic": "awgn-2.4dB-b4096", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({
        "name": "launch_share", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "host launch path",
        "moves": "info_bits_per_s", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    probe = textwrap.dedent('''
        import json, sys
        from pathlib import Path
        root = Path(sys.argv[1])
        sys.path.insert(0, str(root))
        sys.path.append(sys.argv[2])  # the program, from the checkout
        from gpubench.spec import listing, load_cell
        from gpubench.modes import common
        cell = load_cell(root, "new-cell")
        mod = cell.metric_module("launch_share")
        print(json.dumps({
            "listing": listing(root),
            "iterations": cell.config["decoder"]["iterations"],
            "snr": cell.traffic["snr_db"],
            "per_layer": [m["name"] for m in cell.per_layer],
            "read": mod.read({}),
            "runner": cell.runner.__name__,
            "family": cell.family.__name__,
            "module": mod.__file__}))
    ''')
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path),
                          str(ROOT)],
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True).stdout
    got = json.loads(out)
    assert "awgn-2.4dB-b4096" in got["listing"]["traffic"]
    assert "qc1008-minsum-t5-f16" in got["listing"]["configs"]
    assert "launch_share" in got["listing"]["metrics"]
    assert got["iterations"] == 5 and got["snr"] == [2.4]
    assert got["per_layer"] == ["launch_share"]
    assert got["read"] == 42.0
    assert got["module"].startswith(str(tmp_path))
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_dvbs2_cell_needs_only_files_and_entries(tmp_path):
    """The DVB-S2 min-sum configuration (pairs of circulants, an absent
    edge, T=50 with early termination) and a cell of it are added as a
    configuration file, a traffic file and entries: no existing file
    changes, and the cell loads, builds and runs correct on the CPU at a
    tiny batch."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    g = tmp_path / "gpubench"
    (g / "traffic" / "awgn-1.6dB-b16384-et.json").write_text(json.dumps({
        "mode": "simulate", "snr_db": [1.6], "batch": 16384,
        "check_frames": 16384, "trace_seconds": 3.0, "trace_batches": 200,
        "why": "DVB-S2's waterfall point, T=50 with early termination"}))
    (g / "configs" / "dvbs2-minsum-f16.json").write_text(json.dumps({
        "name": "dvbs2-minsum-f16", "source": "a test",
        "code": "dvbs2_1_2_qc", "family": "minsum",
        "decoder": {"variant": "plain", "iterations": 50,
                    "early_termination": True},
        "precision": {"channel": "float32", "storage": "float16",
                      "arith": "float32"},
        "control": {"channel": "bfloat16", "storage": "float8_e4m3fn",
                    "arith": "bfloat16"},
        "limits": {"chan_max_err": 1e-4, "frames_differ": 1e-3,
                   "count_gap": 1e-4},
        "reduced": []}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "dvbs2-minsum-f16", "source": "a test",
        "file": "gpubench/configs/dvbs2-minsum-f16.json",
        "reduced": [], "why": "a new configuration"})
    bench["workloads"].append({
        "name": "dvbs2-et50-1.6dB", "config": "dvbs2-minsum-f16",
        "traffic": "awgn-1.6dB-b16384-et", "chips": 1, "why": "a new cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "minsum-fixed-2.0dB" in m.get("workloads", []):
            m["workloads"].append("dvbs2-et50-1.6dB")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    probe = textwrap.dedent('''
        import contextlib, io, json, sys, time
        from pathlib import Path
        root = Path(sys.argv[1])
        sys.path.insert(0, str(root))
        sys.path.append(sys.argv[2])  # the program, from the checkout
        import torch
        torch.set_num_threads(2)
        from gpubench.spec import load_cell
        from gpubench.modes import common, simulate
        from gpubench.reference import codes
        cell = load_cell(root, "dvbs2-et50-1.6dB")
        graph = common.setup_reference(cell)[0]
        port = cell.family.Port(cell.config,
                                codes.load_table("dvbs2_1_2_qc"), "cpu")
        cell.traffic.update(batch=4, check_frames=4)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = simulate.run(cell, 2 ** 31 + 5, 0.5, False,
                              time.perf_counter(), "cpu")
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(json.dumps({
            "rc": rc, "correct": line["correct"],
            "metrics": sorted(line["metrics"]),
            "edges": graph.e, "pairs": len(port.qc.extra_edges),
            "absent": len(port.qc.minus_edges),
            "kw": port.kw["early_termination"],
            "family": cell.family.__file__}))
    ''')
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path),
                          str(ROOT)],
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True, timeout=600).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["correct"] is True
    assert got["metrics"] == ["batch_ms_p95", "info_bits_per_s",
                              "peak_mem_gib", "setup_s"]
    assert (got["edges"], got["pairs"], got["absent"]) == (226799, 8, 1)
    assert got["kw"] is True
    assert got["family"].startswith(str(tmp_path))
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
