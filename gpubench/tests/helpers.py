"""Small runs of the benchmark's modes on the CPU, for the tests."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

from gpubench.modes import simulate
from gpubench.spec import load_cell

from .conftest import ROOT

SEED = 2 ** 31 + 11


def small_cell(workload: str, batch: int = 64, iterations=None):
    """The cell ``workload`` with its batch and check cut to ``batch``
    frames (and, given, its decoder's iterations)."""
    cell = load_cell(ROOT, workload)
    cell.traffic.update(batch=batch, check_frames=2 * batch)
    if iterations is not None:
        cell.config["decoder"]["iterations"] = iterations
    return cell


def run_cpu(cell, seconds: float = 1.0, traced: bool = False,
            seed: int = SEED) -> dict:
    """Run a cell's single-card mode on the CPU; its last line, parsed."""
    out = io.StringIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = simulate.run(cell, seed, seconds, traced, time.perf_counter(),
                          "cpu")
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def run_grid_cpu(*fault) -> subprocess.CompletedProcess:
    """The grid cell on four gloo ranks on the CPU at 32 frames a slot
    (``tests/cpu_rank.py``, with its ``FAULT``, if given)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    script = ROOT / "gpubench" / "tests" / "cpu_rank.py"
    return subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]);"
         "from ldpcsimulation_tpu_torch.parallel.mesh import spawn_ranks;"
         "sys.exit(spawn_ranks(sys.argv[2:], 4))", str(ROOT),
         sys.executable, str(script), str(ROOT), "minsum-grid4-4chip",
         str(SEED), "1", "32", *fault],
        capture_output=True, text=True, env=env, timeout=600)
