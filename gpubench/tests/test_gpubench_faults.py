"""``correct`` comes out false with the timed path broken underneath, and
for the control (the reference one precision step lower in the program's
place), at sizes a test run holds: the rest of a run is driven on the CPU
(the program's plain twins), past the look for a card."""

import json

import pytest
import torch

from gpubench.check import verdict
from gpubench.modes import common
from gpubench.reference import precision

from .helpers import SEED, run_cpu, run_grid_cpu, small_cell

CELLS = {"minsum-fixed-2.0dB": {}, "smngdbf-3.25dB": {"batch": 32}}


def test_sound_runs_are_correct():
    for name, kw in CELLS.items():
        got = run_cpu(small_cell(name, **kw))
        assert got["correct"], got
        assert got["checks"]["frames_differ"]["value"] == 0.0


@pytest.mark.parametrize("name", list(CELLS))
def test_control_is_not_correct(name):
    cell = small_cell(name, **CELLS[name])
    graph, sigmas, prec, ctrl = common.setup_reference(cell)
    frames = 7 * cell.traffic["batch"]
    kept = {7: {"frame0": frames, "hard": torch.zeros(
        (cell.traffic["batch"], graph.n))}}
    ref = cell.family.reference(cell.config, graph, SEED,
                                frames + torch.arange(cell.traffic["batch"]),
                                sigmas[0], prec)
    kept[7].update(inp=ref[0], hard=ref[1], iterations=ref[2],
                   satisfied=ref[3])
    prog, control, _ = common.check_kept(cell, kept, graph, SEED,
                                      lambda b: sigmas[0], prec, "cpu",
                                      control=ctrl)
    assert verdict(prog.numbers(), cell.config["limits"], prog.frames)[0]
    ok, table = verdict(control.numbers(), cell.config["limits"],
                        control.frames)
    assert not ok
    assert table["chan_max_err"]["value"] > table["chan_max_err"]["limit"]
    assert table["frames_differ"]["value"] > table["frames_differ"]["limit"]


def _patched(monkeypatch, name, fault):
    """Break the program's timed path of cell ``name`` with ``fault``."""
    import ldpcsimulation_tpu_torch.decoders.gdbf as gdbf
    import ldpcsimulation_tpu_torch.decoders.minsum_qc as mqc
    from gpubench.families import minsum, ngdbf

    if fault == "unadvanced_frames":  # every batch decodes frames 0…b−1
        import ldpcsimulation_tpu_torch.harness.montecarlo as hm

        chan, key = hm.awgn_all_zero, hm.NoiseKey
        monkeypatch.setattr(hm, "awgn_all_zero",
                            lambda seed, f0, *a, **k: chan(seed, 0, *a, **k))
        monkeypatch.setattr(hm, "NoiseKey", lambda seed, f0: key(seed, 0))
        return
    if fault == "unchanged_state":
        if name.startswith("minsum"):
            monkeypatch.setattr(mqc, "minsum_iteration",
                                lambda v2c, y, *a, **k: (v2c, y.clone()))
        else:
            monkeypatch.setattr(gdbf, "gdbf_parallel_step",
                                lambda *a, **k: None)
        return
    port = minsum.Port if name.startswith("minsum") else ngdbf.Port
    real = port.batch_decoder

    def broken(self, sigma):
        decode, pre = real(self, sigma)

        def half(y, key):
            res = decode(y[: y.shape[0] // 2], key)
            res.hard = res.hard.repeat(2, 1)
            res.iterations = res.iterations.repeat(2)
            res.satisfied = res.satisfied.repeat(2)
            return res

        def altered(y, key):
            res = decode(y, key)
            res.hard = res.hard.clone()
            res.hard[0, 0] = -res.hard[0, 0]
            return res

        return {"half_batch": half, "altered_answer": altered}[fault], pre

    monkeypatch.setattr(port, "batch_decoder", broken)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer", "unadvanced_frames"])
@pytest.mark.parametrize("name", list(CELLS))
def test_fault_is_not_correct(monkeypatch, name, fault):
    _patched(monkeypatch, name, fault)
    got = run_cpu(small_cell(name, **CELLS[name]))
    assert got["correct"] is False


def _grid(*fault):
    """A grid run on four gloo ranks on the CPU; its last line, parsed."""
    out = run_grid_cpu(*fault)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_grid_sound_run_is_correct():
    got = _grid()
    assert got["correct"], got
    assert got["device"]["count"] == 4


def test_grid_without_the_exchange_is_not_correct():
    got = _grid("no_exchange")
    assert got["correct"] is False
    assert got["checks"]["count_gap"]["value"] > 0
