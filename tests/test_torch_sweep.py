"""The port's sweep CLI: the min-sum route writes the JAX CLI's row format
and resume keys; everything not ported exits naming its ROADMAP item."""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.tools.sweep import main as jax_main
from ldpcsimulation_tpu_torch.tools.sweep import _parse_snr, main
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

BASE = ["minsum", "--code", "qc_1008_504", "-T", "10", "--msg-dtype", "f16",
        "--batch", "128", "--max-frames", "128", "--device", "cpu"]


def _jax_point(log, snr):
    """One point through the JAX CLI (one compiled signature for the file)."""
    return jax_main([
        "minsum", "--code", "qc_1008_504", "-T", "10", "--msg-dtype", "f16",
        "--batch", "64", "--max-frames", "64", "--snr", snr,
        "--log", str(log),
    ])


def _rows(path):
    return [line.split("\t") for line in path.read_text().splitlines()]


def test_minsum_row_has_jax_columns(tmp_path):
    log = tmp_path / "ms.log"
    assert main(BASE + ["--snr", "2.0", "--log", str(log)]) == 0
    jlog = tmp_path / "jax.log"
    assert _jax_point(jlog, "2.0") == 0
    (row,), (jrow,) = _rows(log), _rows(jlog)
    # SNR BER avgIters WER T code
    assert len(row) == len(jrow) == 6
    assert [row[0], row[2], row[4], row[5]] == [jrow[0], jrow[2], jrow[4],
                                                 jrow[5]]
    assert row[:1] + row[2:] == ["2", "10", row[3], "10", "qc_1008_504"]
    assert 0.0 < float(row[1]) < 0.1 and 0.0 < float(row[3]) <= 1.0
    assert (tmp_path / "ms.log.done").read_text() == (
        (tmp_path / "jax.log.done").read_text()
    )


def test_resume_skips_done_points(tmp_path, capsys):
    log = tmp_path / "r.log"
    assert main(BASE + ["--snr", "2.0", "--log", str(log)]) == 0
    assert main(BASE + ["--snr", "2.0:2.5:0.5", "--log", str(log),
                        "--resume"]) == 0
    assert [r[0] for r in _rows(log)] == ["2", "2.5"]
    assert "SNR=2.0 point already logged" in capsys.readouterr().err
    # a log without a sidecar resumes by its SNR column
    (tmp_path / "r.log.done").unlink()
    assert main(BASE + ["--snr", "2.0:2.5:0.5", "--log", str(log),
                        "--resume"]) == 0
    assert len(_rows(log)) == 2


def test_resume_reads_jax_sidecar(tmp_path):
    log = tmp_path / "j.log"
    assert _jax_point(log, "3.0") == 0
    assert main(BASE + ["--snr", "3.0", "--log", str(log), "--resume"]) == 0
    assert len(_rows(log)) == 1


def test_codeword_fixture_route(tmp_path):
    from ldpcsimulation_tpu.codes import make_encoder, random_codewords
    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.harness.fixtures import save_codeword_file
    import jax

    enc = make_encoder(load_named_qc("qc_1008_504").to_code())
    cw = np.asarray(random_codewords(enc, jax.random.key(9), 8))
    cwf = tmp_path / "data.enc"
    save_codeword_file(str(cwf), cw)
    log = tmp_path / "cw.log"
    assert main(BASE + ["--snr", "3.0", "--codewords", str(cwf),
                        "--early-termination", "--log", str(log)]) == 0
    assert float(_rows(log)[0][1]) < 0.02
    bad = cw.copy()
    bad[:, 0] ^= 1
    save_codeword_file(str(cwf), bad)
    with pytest.raises(SystemExit, match="not codewords"):
        main(BASE + ["--snr", "3.0", "--codewords", str(cwf),
                     "--log", str(log)])


@pytest.mark.parametrize("extra,item", [
    (["--schedule", "layered"], "A9"),
    (["--stream"], "A10"),
    (["--distributed"], "A13"),
])
def test_unported_options_name_roadmap_item(tmp_path, extra, item):
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        main(BASE + ["--snr", "2.0", "--log", str(tmp_path / "x")] + extra)


@pytest.mark.parametrize("decoder,item", [
    ("bp", "A8"), ("gdbf", "A11"), ("nbqspa", "A12"),
    ("offsetminsum", "S4"),
])
def test_unported_decoders_name_roadmap_item(tmp_path, decoder, item):
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        main([decoder] + BASE[1:] + ["--snr", "2.0", "--log",
                                     str(tmp_path / "x")])


def test_non_qc_code_and_missing_cuda(tmp_path, monkeypatch):
    args = ["minsum", "--code", "peg_96_48", "-T", "2", "--snr", "2.0",
            "--device", "cpu", "--log", str(tmp_path / "x")]
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        main(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args[:-4] + ["--log", str(tmp_path / "x")])


def test_parse_snr():
    assert _parse_snr("2.0:2.6:0.3") == [2.0, 2.3, 2.6]
    assert _parse_snr("1,2.5") == [1.0, 2.5]
    with pytest.raises(SystemExit):
        _parse_snr("3:2:0.5")
