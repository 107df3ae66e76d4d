"""``tools/ab_smoke.py``: another checkout's ``chip_smoke.py`` runs from its
own directory with this checkout's ``time_ms``, and its exit code comes
back."""

from pathlib import Path

import pytest

from ldpcsimulation_tpu_torch.tools import ab_smoke

FAKE = """
import os, sys


def time_ms(fn, reps=10):
    return -1.0


def main():
    print("cwd", os.path.basename(os.getcwd()))
    print("patched", time_ms.__module__ == "timer_source")
    return {rc}


def phase_x(device, timer):
    print("phase_x on", device, timer.__module__)
"""


def test_ab_smoke_runs_each_checkout_with_this_timer(tmp_path, capfd):
    assert ab_smoke.TIMER == Path(__file__).resolve().parents[1] / \
        "chip_smoke.py"
    for name, rc in (("new", 3), ("old", 0)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "chip_smoke.py").write_text(FAKE.format(rc=rc))
    # every checkout runs; the first non-zero exit code is returned
    assert ab_smoke.main([str(tmp_path / "new"), str(tmp_path / "old")]) == 3
    out = capfd.readouterr().out
    assert "cwd new" in out and "cwd old" in out
    assert out.count("patched True") == 2
    assert f"== {tmp_path / 'new'}: exit 3" in out
    assert f"== {tmp_path / 'old'}: exit 0" in out


def test_ab_smoke_runs_one_phase_repeatedly(tmp_path, capfd):
    (tmp_path / "new").mkdir()
    (tmp_path / "new" / "chip_smoke.py").write_text(FAKE.format(rc=3))
    args = ["--phase", "phase_x", "--repeat", "2"]
    assert ab_smoke.main(args + [str(tmp_path / "new")]) == 0
    out = capfd.readouterr().out
    assert out.count("phase_x on cuda:0 timer_source") == 2 and "cwd" not in out
    assert "-- phase_x run 1" in out


def test_ab_smoke_here_runs_this_phase_in_each_checkout(tmp_path, capfd,
                                                        monkeypatch):
    """``--here``: the phase is this checkout's script's, run from each
    DIR (its package and build), which needs no chip_smoke.py of its own;
    without ``--phase`` it is refused."""
    here = tmp_path / "here"
    here.mkdir()
    (here / "chip_smoke.py").write_text(FAKE.format(rc=0) + """

def phase_y(device, timer):
    print("phase_y in", os.path.basename(os.getcwd()), timer.__module__)
""")
    monkeypatch.setattr(ab_smoke, "TIMER", here / "chip_smoke.py")
    (tmp_path / "old").mkdir()
    args = ["--here", "--phase", "phase_y"]
    assert ab_smoke.main(args + [str(tmp_path / "old"), str(here)]) == 0
    out = capfd.readouterr().out
    assert "phase_y in old timer_source" in out
    assert "phase_y in here timer_source" in out
    with pytest.raises(SystemExit):
        ab_smoke.main(["--here", str(tmp_path / "old")])
