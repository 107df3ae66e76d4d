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
