"""The run fails without the cards it needs, and without the program:
another exit code than 0, and no result printed."""

import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT


def run(cwd, workload="minsum-fixed-2.0dB", env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", workload,
         "--seed", "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("workload", ["minsum-fixed-2.0dB",
                                      "minsum-grid4-4chip"])
def test_no_card_no_result(workload):
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = run(ROOT, workload, env)
    assert got.returncode != 0
    assert got.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    got = run(tmp_path)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
