"""The port's ``sweep --distributed`` against the JAX CLI's and against the
port's own ``simulate``.

The JAX CLI runs its grid on the 8 virtual CPU devices of
``tests/conftest.py`` (8 operating slots); the port's CLI with ``--device
cpu`` runs one slot.  So the rows are compared with the JAX CLI's by layout,
parameter columns, ``<log>.done`` keys, itdist file names and refusal
messages, and each route's statistics are compared exactly with the port's
``simulate`` over the same frames, with the route's decode (each point's
scalars rounded to f32, as the grid passes them).  The cases carry the
``--distributed`` tests of ``tests/test_tools.py``: two-point rows, the
multi-parameter grid, resume, the guards, layered schedules, the quantized
variants, NGDBFhw's fixed frame count and itdist files, and ``nbqspa``;
and two torchrun ranks write the rows of one process.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.tools.sweep import main as jax_main
from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    quantize_no_zero,
    saturate,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp,
    decode_bp_layered_qc,
    decode_ddbmp,
    decode_minsum,
)
from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf, preset
from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import (
    NGDBFHwConfig,
    decode_ngdbf_hw,
)
from ldpcsimulation_tpu_torch.harness import (
    StopRule,
    bp_log_row,
    gdbf_log_row,
    minsum_log_row,
    ngdbfhw_log_row,
    simulate,
)
from ldpcsimulation_tpu_torch.parallel.mesh import spawn_ranks
from ldpcsimulation_tpu_torch.tools import sweep
from ldpcsimulation_tpu_torch.tools.sweep import main
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

PEG = load_named_code("peg_96_48")


def _rows(path):
    return [line.split("\t") for line in path.read_text().splitlines()]


def _f32(v):
    return float(np.float32(v))


def _sigma(snr, code=PEG):
    return _f32(snr_to_sigma(snr, code.rate))


def _sim(snr, dec, stop, batch, code=PEG, pre=None):
    """``simulate`` of one point with the route's decode, on the CPU."""
    return simulate(code, dec, snr, stop=stop, batch_size=batch, seed=0,
                    preprocess=pre, device="cpu")


def _port(tmp_path, args, name="p.log"):
    log = tmp_path / name
    assert main(args + ["--distributed", "--device", "cpu",
                        "--log", str(log)]) == 0
    return _rows(log)


def _jax(tmp_path, args, name="j.log"):
    log = tmp_path / name
    assert jax_main(args + ["--distributed", "--log", str(log)]) == 0
    return _rows(log)


def _same_but(stats, prows, jrows):
    """Rows equal column for column outside the ``stats`` columns."""
    assert len(prows) == len(jrows)
    for p, j in zip(prows, jrows):
        assert len(p) == len(j)
        assert [v for i, v in enumerate(p) if i not in stats] == [
            v for i, v in enumerate(j) if i not in stats]


def test_sweep_distributed(tmp_path):
    """Two SNR points (each numbering its own frames): rows equal
    ``simulate``'s with the slot-array min-sum, the JAX CLI's layout."""
    args = ["minsum", "--code", "peg_96_48", "--snr", "2.0,4.0", "-T", "5",
            "--early-termination", "--batch", "16", "--min-errors", "10",
            "--min-word-errors", "2", "--max-frames", "512"]
    rows = _port(tmp_path, args)
    assert len(rows) == 2 and float(rows[0][1]) > float(rows[1][1])
    stop = StopRule(10, 2, 512)
    for row, snr in zip(rows, (2.0, 4.0)):
        st = _sim(snr, lambda y, key: decode_minsum(
            PEG, y, 5, early_termination=True), stop, 16)
        assert row == minsum_log_row(snr, st, 5, "peg_96_48").split("\t")
    jrows = _jax(tmp_path, args)
    _same_but((1, 2, 3), rows, jrows)
    assert float(jrows[0][1]) > float(jrows[1][1])


GDBF_ARGS = ["gdbf", "--preset", "SMNGDBF", "--code", "peg_96_48",
             "--snr", "3.0,4.5", "-T", "30", "--theta", "-0.8",
             "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "0.75",
             "--ymax", "2.5", "--batch", "16", "--min-errors", "10",
             "--min-word-errors", "2", "--max-frames", "1024"]


def test_sweep_distributed_gdbf(tmp_path):
    """SMNGDBF rows (the smoothing columns included) equal ``simulate``'s
    with the route's f32 parameters, under the frames' noise keys."""
    rows = _port(tmp_path, GDBF_ARGS)
    assert len(rows) == 2 and float(rows[0][1]) >= float(rows[1][1])
    cfg = preset("SMNGDBF", num_iterations=30, theta=_f32(-0.8),
                 noise_scale=_f32(0.9), lam=_f32(0.98), alpha=_f32(0.75))
    for row, snr in zip(rows, (3.0, 4.5)):
        sigma = _sigma(snr)
        st = _sim(snr, lambda y, key: decode_gdbf(PEG, y, sigma, cfg,
                                                  key=key),
                  StopRule(10, 2, 1024), 16,
                  pre=lambda y: saturate(y, _f32(2.5)))
        want = gdbf_log_row(
            snr, st, 30, -0.8, "peg_96_48", noise_scale=0.9, lam=0.98,
            alpha=0.75, smoothing_used=int(st.extra["smoothing_used"]),
            window_size=cfg.window_size, ymax=2.5)
        assert row == want.split("\t")


def test_sweep_distributed_ddbmp_ngdbfhw(tmp_path):
    """DD-BMP and NGDBFhw rows equal ``simulate``'s; NGDBFhw runs its
    fixed ``--frames`` count (no pointer carry, as the JAX grid) and
    writes one itdist file per SNR."""
    dd = ["ddbmp", "--code", "peg_96_48", "--snr", "3.0,5.0", "-T", "20",
          "--ymax", "1.5", "--nq", "8", "--batch", "16", "--min-errors",
          "5", "--min-word-errors", "1", "--max-frames", "512"]
    rows = _port(tmp_path, dd, "dd.log")
    assert len(rows) == 2 and float(rows[0][1]) >= float(rows[1][1])
    for row, snr in zip(rows, (3.0, 5.0)):
        st = _sim(snr, lambda yq, key: decode_ddbmp(PEG, yq, 20),
                  StopRule(5, 1, 512), 16,
                  pre=lambda y: quantize_no_zero(y, 1.5, 8.0))
        assert row == minsum_log_row(snr, st, 20, "peg_96_48",
                                     ymax=1.5).split("\t")
    hw = ["ngdbfhw", "--code", "peg_96_48", "--snr", "4.0,6.0", "-T", "30",
          "--batch", "16", "--frames", "96"]
    rows = _port(tmp_path, hw, "hw.log")
    assert len(rows) == 2
    cfg = NGDBFHwConfig(num_iterations=30, w=_f32(0.185), ymax=_f32(1.625),
                        noise_scale=_f32(0.95), theta0=_f32(-0.525),
                        ring_len=2648)
    for row, snr in zip(rows, (4.0, 6.0)):
        sigma = _sigma(snr)
        st = _sim(snr, lambda y, key: decode_ngdbf_hw(PEG, y, sigma, cfg,
                                                      key=key),
                  StopRule.fixed_frames(96), 16)
        want = ngdbfhw_log_row(snr, st, 30, -0.525, 0.95, 0.185, 1.625, 5,
                               1, 0)
        assert row == want.split("\t")
        assert (tmp_path / f"hw.log_{snr:g}_itdist.dat").exists()


def test_sweep_distributed_nbqspa(tmp_path):
    """One SNR per slot: the port's one CPU slot takes one SNR (its row is
    the single-device route's) and refuses two with the JAX CLI's
    message; the JAX CLI's 8 slots take two, in the same layout."""
    args = ["nbqspa", "--nb-random", "24:12:3:8", "-T", "8", "--batch", "8",
            "--min-errors", "5", "--min-word-errors", "1",
            "--max-frames", "256"]
    (row,) = _port(tmp_path, args + ["--snr", "3.0"])
    assert main(args + ["--snr", "3.0", "--device", "cpu", "--log",
                        str(tmp_path / "s.log")]) == 0
    assert [row] == _rows(tmp_path / "s.log")
    with pytest.raises(SystemExit, match=r"needs len\(snrs\)=2 to divide "
                                         r"the device count \(1\)"):
        _port(tmp_path, args + ["--snr", "3.0,6.0"], "x.log")
    jrows = _jax(tmp_path, args + ["--snr", "3.0,6.0"])
    assert len(jrows) == 2 and float(jrows[0][1]) >= float(jrows[1][1])
    _same_but((1, 2, 3, 4), [row], jrows[:1])


def test_sweep_distributed_ngdbfhw_fixed_frames(tmp_path):
    """Exactly --frames frames (round-aligned), the JAX CLI's row layout
    and itdist file names on a swept parameter."""
    args = ["ngdbfhw", "--code", "peg_96_48", "--snr", "3.0", "-T", "5",
            "--batch", "8", "--frames", "128", "--w", "0.2", "0.25"]
    prows = _port(tmp_path, args)
    jrows = _jax(tmp_path, args)
    assert [r[2] for r in prows] == [r[2] for r in jrows] == ["128", "128"]
    _same_but((1, 3, 4, 5, 6, 7), prows, jrows)
    for w in ("0.2", "0.25"):
        for log in ("p.log", "j.log"):
            assert (tmp_path / f"{log}_3_w{w}_itdist.dat").exists()


@pytest.mark.parametrize("args", [
    ["minsum", "--code", "peg_96_48", "--snr", "2.0", "--schedule",
     "layered"],
    ["minsum", "--code", "peg_96_48", "--snr", "2.0", "--ymax", "1.5",
     "2.0"],
    ["gdbf", "--code", "peg_96_48", "--snr", "2.0", "--theta", "-0.8",
     "--nq", "4", "5"],
    ["ddbmp", "--code", "peg_96_48", "--snr", "2.0", "--alpha", "1.0",
     "1.25"],
    ["minsum", "--code", "peg_96_48", "--snr", "2.0", "--stream",
     "--early-termination"],
])
def test_sweep_distributed_guards(tmp_path, args):
    """Both CLIs refuse with the same message: layered without a QC code,
    a multi-valued parameter the decoder cannot take per point, gdbf's
    structural --nq, --stream with --distributed."""
    common = args + ["-T", "3", "--batch", "8", "--distributed"]
    with pytest.raises(SystemExit) as port:
        main(common + ["--device", "cpu", "--log", str(tmp_path / "p")])
    with pytest.raises(SystemExit) as ref:
        jax_main(common + ["--log", str(tmp_path / "j")])
    assert str(port.value).startswith("sweep: error: --")
    assert str(port.value) == str(ref.value)


def test_sweep_distributed_parameter_grid(tmp_path):
    """2 SNR × 2 θ × 2 noise scale × 2 α = 16 points in one launch: each
    combination once with its own values, the single-device layout, the
    JAX CLI's rows outside the statistics, and a point equal to
    ``simulate``'s."""
    args = ["gdbf", "--preset", "MNGDBF", "--code", "peg_96_48",
            "--snr", "3.0,4.0", "-T", "20", "--theta", "-0.8", "-0.6",
            "--noise-scale", "0.8", "1.0", "--alpha", "0.75", "1.0",
            "--lam", "0.98", "--ymax", "2.5", "--batch", "8",
            "--max-frames", "32", "--min-errors", "1000000",
            "--min-word-errors", "1000000"]
    rows = _port(tmp_path, args)
    assert len(rows) == 16
    seen = {(r[0], r[7], r[8], r[10]) for r in rows}
    assert seen == {(f"{s:g}", f"{t:g}", f"{ns:g}", f"{a:g}")
                    for s in (3.0, 4.0) for t in (-0.8, -0.6)
                    for ns in (0.8, 1.0) for a in (0.75, 1.0)}
    single = tmp_path / "single.log"
    assert main(["gdbf", "--preset", "MNGDBF", "--code", "peg_96_48",
                 "--snr", "3.0", "-T", "20", "--theta", "-0.8",
                 "--noise-scale", "0.8", "--alpha", "0.75", "--lam", "0.98",
                 "--ymax", "2.5", "--batch", "8", "--max-frames", "32",
                 "--device", "cpu", "--log", str(single)]) == 0
    assert all(len(r) == len(_rows(single)[0]) for r in rows)
    _same_but((1, 2, 3, 4, 5), rows, _jax(tmp_path, args))
    # the last point (4 dB, θ −0.6, noise scale 1, α 1) against simulate
    cfg = preset("MNGDBF", num_iterations=20, theta=_f32(-0.6),
                 noise_scale=1.0, lam=_f32(0.98), alpha=1.0)
    sigma = _sigma(4.0)
    st = _sim(4.0, lambda y, key: decode_gdbf(PEG, y, sigma, cfg, key=key),
              StopRule(10**6, 10**6, 32), 8,
              pre=lambda y: saturate(y, 2.5))
    assert rows[-1][1:6] == gdbf_log_row(
        4.0, st, 20, -0.6, "peg_96_48").split("\t")[1:6]


def test_sweep_distributed_row_layout_matches_single_device(tmp_path):
    """Distributed and single-device rows of one config have one layout
    (gdbf's smoothing columns, offset min-sum's Ymax)."""
    common = ["--code", "peg_96_48", "--snr", "4.0", "-T", "15",
              "--batch", "16", "--max-frames", "64",
              "--min-errors", "1000000", "--min-word-errors", "1000000",
              "--device", "cpu"]
    for decoder, extra in [
        ("gdbf", ["--preset", "SMNGDBF", "--theta", "-0.8",
                  "--noise-scale", "0.9", "--lam", "0.98",
                  "--alpha", "0.9", "--ymax", "2.5"]),
        ("offsetminsum", ["--ymax", "2.0", "--nq", "8", "--delta", "0.25"]),
    ]:
        log_s = tmp_path / f"{decoder}_s.log"
        log_d = tmp_path / f"{decoder}_d.log"
        assert main([decoder, *common, *extra, "--log", str(log_s)]) == 0
        assert main([decoder, *common, *extra, "--distributed",
                     "--log", str(log_d)]) == 0
        (cols_s,), (cols_d,) = _rows(log_s), _rows(log_d)
        assert len(cols_s) == len(cols_d), (decoder, cols_s, cols_d)


def test_sweep_distributed_quantizes_variants(tmp_path):
    """The quantized variants decode ``quantize_no_zero`` samples: with 2
    levels at Ymax 1 the BER is far above the unquantized channel's, and
    the row equals ``simulate``'s on the same quantizer."""
    args = ["normalizedminsum", "--code", "peg_96_48", "--snr", "3.0",
            "-T", "8", "--alpha", "1.25", "--ymax", "1.0", "--nq", "2",
            "--batch", "16", "--max-frames", "128",
            "--min-errors", "1000000", "--min-word-errors", "1000000"]
    (row,) = _port(tmp_path, args)
    assert float(row[1]) > 0.02
    st = _sim(3.0, lambda yq, key: decode_minsum(
        PEG, yq, 8, variant="normalized", alpha=1.25), StopRule(
        10**6, 10**6, 128), 16, pre=lambda y: quantize_no_zero(y, 1.0, 2.0))
    assert row == minsum_log_row(3.0, st, 8, "peg_96_48", ymax=1.0,
                                 alpha=1.25).split("\t")


def test_sweep_distributed_resume(tmp_path):
    """--resume: the sidecar's keys are the JAX CLI's, and a second run
    writes no duplicate row."""
    base = ["minsum", "--code", "peg_96_48", "--snr", "3.0,4.0", "-T", "3",
            "--batch", "8", "--max-frames", "32", "--min-errors", "1",
            "--min-word-errors", "1", "--resume"]
    assert len(_port(tmp_path, base)) == 2
    assert len(_port(tmp_path, base)) == 2
    _jax(tmp_path, base)
    assert (tmp_path / "p.log.done").read_text() == (
        (tmp_path / "j.log.done").read_text())


def test_sweep_distributed_layered(tmp_path):
    """--schedule layered under --distributed on a QC code: min-sum rows by
    SNR, and layered BP equal to ``simulate`` with the layered decoder on
    LLRs of the f32 σ."""
    common = ["--code", "qc_1008_504", "--schedule", "layered",
              "--snr", "2.0,3.0", "-T", "6", "--early-termination",
              "--batch", "8", "--max-frames", "32",
              "--min-errors", "1000000", "--min-word-errors", "1000000"]
    rows = _port(tmp_path, ["minsum", *common])
    assert len(rows) == 2 and float(rows[0][1]) > float(rows[1][1])
    qc = load_named_qc("qc_1008_504")
    code = qc.to_code()
    (row, _) = _port(tmp_path, ["bp", *common], "bp.log")
    s = _sigma(2.0, code)
    st = _sim(2.0, lambda y, key: decode_bp_layered_qc(
        qc, llr_from_channel(y, 2.0 * s * s), 6, early_termination=True),
        StopRule(10**6, 10**6, 32), 8, code=code)
    assert row == bp_log_row(2.0, st, 6, "qc_1008_504").split("\t")


def test_sweep_distributed_bp_flooding(tmp_path):
    """Flooding BP decodes on the slot arrays (as the JAX CLI's route),
    f16 message storage, LLRs of the f32 σ: equal to ``simulate``'s."""
    (row,) = _port(tmp_path, ["bp", "--code", "peg_96_48", "--snr", "2.5",
                              "-T", "8", "--msg-dtype", "f16", "--batch",
                              "16", "--max-frames", "64"])
    s = _sigma(2.5)
    st = _sim(2.5, lambda y, key: decode_bp(
        PEG, llr_from_channel(y, 2.0 * s * s), 8,
        storage_dtype=torch.float16), StopRule(200, 20, 64), 16)
    assert row == bp_log_row(2.5, st, 8, "peg_96_48").split("\t")


def test_sweep_spawns_one_rank_per_card(tmp_path, monkeypatch):
    """Without torchrun, a host with several cards runs one rank per card
    (``spawn_ranks``, here two CPU ranks): rank 0's rows equal one
    process's; a failing rank's exit code comes back."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", root)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = ["minsum", "--code", "peg_96_48", "--snr", "2.0,3.0", "-T", "6",
            "--batch", "32", "--max-frames", "64", "--min-errors", "100000",
            "--min-word-errors", "100000", "--device", "cpu",
            "--distributed"]
    cli = [sys.executable, "-m", "ldpcsimulation_tpu_torch.tools.sweep"]
    assert spawn_ranks(cli + args + ["--log", str(tmp_path / "sp.log")],
                       2) == 0
    assert main(args + ["--log", str(tmp_path / "one.log")]) == 0
    rows = _rows(tmp_path / "sp.log")
    assert len(rows) == 2 and rows == _rows(tmp_path / "one.log")
    assert spawn_ranks(cli + ["minsum", "--code", "no_such_code"], 2) == 2
    # the CLI takes this path only for CUDA cards and without torchrun
    calls = []
    monkeypatch.setattr(sweep, "spawn_ranks",
                        lambda cmd, n: calls.append(n) or 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert main(args + ["--log", str(tmp_path / "cpu.log")]) == 0
    assert calls == []


def test_sweep_distributed_under_torchrun(tmp_path):
    """Two ranks started by torchrun join one gloo group from its
    environment (one CPU slot each); rank 0 writes the rows, equal to one
    process's, since each point numbers its own frames."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["minsum", "--code", "peg_96_48", "--snr", "2.0,2.5,3.0", "-T",
            "6", "--batch", "32", "--max-frames", "128", "--min-errors",
            "100000", "--min-word-errors", "100000", "--device", "cpu",
            "--distributed", "--resume"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "ldpcsimulation_tpu_torch.tools.sweep",
         *args, "--log", str(tmp_path / "tr.log")],
        env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=180,
        start_new_session=True)  # torchrun signals its own process group
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert main(args + ["--log", str(tmp_path / "one.log")]) == 0
    rows = _rows(tmp_path / "tr.log")
    assert len(rows) == 3 and rows == _rows(tmp_path / "one.log")
    assert (tmp_path / "tr.log.done").read_text() == (
        (tmp_path / "one.log.done").read_text())
