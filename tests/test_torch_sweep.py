"""The port's sweep CLI: the min-sum routes (plain, offset, normalized; named
codes and --alist files; flooding and layered), the BP routes (slot-array,
QC, layered), the DD-BMP route, the GDBF route, the NGDBFhw route (with
its itdist file), the non-binary ``nbqspa`` route (``--nb-random`` and NB
alists), and the ``--stream`` routes (NGDBFhw and ``nbqspa`` among them),
write the JAX CLI's row format and resume keys; ``--stream`` refuses what
the JAX CLI refuses; ``--distributed`` (ROADMAP A13) writes the rows of the
single-device routes (``tests/test_torch_sweep_distributed.py`` holds it
against the JAX CLI's)."""

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
    (["--distributed"], "A13"),
    (["--schedule", "layered", "--distributed"], "A13"),
])
def test_unported_options_name_roadmap_item(tmp_path, extra, item):
    """The options of ROADMAP ``item`` run: ``--distributed`` writes the
    single-device route's row layout; its flooding route decodes with the
    slot-array ``decode_minsum`` (as the JAX CLI's), equal to ``simulate``
    over the same frames, and its layered route equals the single-device
    layered row."""
    dlog, slog = tmp_path / "d.log", tmp_path / "s.log"
    assert main(BASE + ["--snr", "2.0", "--log", str(dlog)] + extra) == 0
    assert main(BASE + ["--snr", "2.0", "--log", str(slog)]
                + extra[:-1]) == 0
    (drow,), (srow,) = _rows(dlog), _rows(slog)
    assert len(drow) == len(srow) == 6
    assert [drow[0], drow[4], drow[5]] == ["2", "10", "qc_1008_504"]
    if "layered" in extra:
        assert drow == srow
        return
    from ldpcsimulation_tpu_torch.codes import load_named_code
    from ldpcsimulation_tpu_torch.decoders import decode_minsum
    from ldpcsimulation_tpu_torch.harness import StopRule, fmt, simulate

    code = load_named_code("qc_1008_504")
    st = simulate(code, lambda y, key: decode_minsum(
        code, y, 10, storage_dtype=torch.float16), 2.0,
        stop=StopRule(max_frames=128), batch_size=128, device="cpu")
    assert drow[1:4] == [fmt(st.ber), fmt(st.avg_iterations), fmt(st.fer)]


def _codeword_file(tmp_path):
    from ldpcsimulation_tpu.codes import make_encoder, random_codewords
    from ldpcsimulation_tpu.codes.library import load_named_qc
    from ldpcsimulation_tpu.harness.fixtures import save_codeword_file
    import jax

    enc = make_encoder(load_named_qc("qc_1008_504").to_code())
    cw = np.asarray(random_codewords(enc, jax.random.key(9), 4))
    path = tmp_path / "data.enc"
    save_codeword_file(str(path), cw)
    return str(path)


@pytest.mark.parametrize("args,msg", [
    (BASE, "--stream requires --early-termination"),
    (BASE + ["--schedule", "layered"],
     "--stream requires --early-termination"),
    (["bp"] + BASE[1:], "--stream requires --early-termination"),
    (BASE + ["--early-termination", "--codewords", None],
     "--stream simulates all-zero codewords"),
    (BASE + ["--early-termination", "--distributed"],
     "--stream runs on one device in the CLI"),
    (["ddbmp"] + BASE[1:] + ["--schedule", "layered"],
     "--schedule layered streams min-sum variants and BP only"),
    (["ddbmp", "--code", "peg_96_48", "-T", "4", "--batch", "16",
      "--max-frames", "16"], "--stream ddbmp requires a QC code"),
    (["ngdbfhw", "--code", "peg_96_48", "-T", "4", "--batch", "16",
      "--frames", "16", "--persistent-qpointer"],
     "--stream ngdbfhw already chains ring offsets per frame"),
])
def test_stream_refusals_are_the_jax_clis(tmp_path, args, msg):
    """``--stream`` refuses what the JAX CLI refuses, with its message."""
    args = [_codeword_file(tmp_path) if a is None else a for a in args]
    args = [a for a in args if a not in ("--device", "cpu")]
    common = args + ["--snr", "2.0", "--stream", "--log",
                     str(tmp_path / "x")]
    with pytest.raises(SystemExit, match=msg):
        main(common + ["--device", "cpu"])
    with pytest.raises(SystemExit, match=msg):
        jax_main(common)


@pytest.mark.parametrize("decoder,item", [
    ("nbqspa", "A12"),
])
def test_unported_decoders_name_roadmap_item(tmp_path, decoder, item):
    """The decoder of ROADMAP A12 (``nbqspa``) is ported and writes its row;
    its multi-device form (A13) on one slot writes the same row: the same
    frames through the same decoder."""
    args = [decoder, "--nb-random", "24:12:3:4", "-T", "4", "--batch", "32",
            "--max-frames", "32", "--device", "cpu", "--snr", "2.0"]
    assert main(args + ["--log", str(tmp_path / "x")]) == 0
    assert main(args + ["--log", str(tmp_path / "d"), "--distributed"]) == 0
    (row,), (drow,) = _rows(tmp_path / "x"), _rows(tmp_path / "d")
    assert drow == row and len(row) == 7


@pytest.mark.parametrize("decoder", ["bp", "ddbmp", "ngdbfhw"])
@pytest.mark.parametrize("extra,item", [
    (["--stream", "--early-termination"], "A11.4"),
    (["--distributed"], "A13"),
])
def test_ported_decoders_still_refuse_stream_and_distributed(
        tmp_path, decoder, extra, item):
    """The streams of these decoders (the NGDBFhw one came with A11.4) and
    their ``--distributed`` routes (A13) run, one row each; a distributed
    row has the single-device row's layout, and DD-BMP's (the same QC
    decoder on the same frames) equals it.  NGDBFhw runs a fixed
    ``--frames`` count."""
    args = [decoder] + BASE[1:] + ["--snr", "2.0", "--frames", "64"]
    assert main(args + ["--log", str(tmp_path / "x")] + extra) == 0
    (row,) = _rows(tmp_path / "x")
    if item == "A11.4":
        return
    assert main(args + ["--log", str(tmp_path / "s")]) == 0
    (srow,) = _rows(tmp_path / "s")
    assert len(row) == len(srow) and row[0] == srow[0] == "2"
    if decoder == "ngdbfhw":
        # SNR errors frames BER ...: the grid counts whole rounds of
        # --batch frames, as the JAX grid does (the single route clips)
        assert (row[2], srow[2]) == ("128", "64")
        assert 0.0 <= float(row[3]) <= 0.5
    else:
        assert 0.0 <= float(row[1]) <= 0.5
    if decoder == "ddbmp":
        assert row == srow


@pytest.mark.parametrize("args,width", [
    (["minsum", "--code", "qc_1008_504", "--msg-dtype", "f16"], 6),
    (["offsetminsum", "--code", "peg_96_48", "--delta", "0.15"], 7),
    (["bp", "--code", "qc_1008_504", "--msg-dtype", "f16"], 6),
    (["bp", "--code", "qc_1008_504", "--schedule", "layered"], 6),
    (["normalizedminsum", "--code", "qc_1008_504", "--schedule", "layered",
      "--alpha", "1.25"], 7),
    (["ddbmp", "--code", "qc_1008_504", "--ymax", "1.6"], 7),
    (["gdbf", "--preset", "SMNGDBF", "--code", "qc_1008_504", "--theta",
      "-0.7", "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "0.8",
      "--ymax", "2.5", "--window", "4"], 16),
])
def test_stream_rows_and_keys_equal_jax_cli(tmp_path, args, width):
    """``--stream`` routes through both CLIs (lanes = --batch): the same
    rows column for column apart from the Monte-Carlo statistics (the
    packages draw other noise), the same resume keys."""
    common = args + ["-T", "4", "--snr", "3.0", "--batch", "32",
                     "--max-frames", "32", "--stream"]
    if args[0] not in ("ddbmp", "gdbf"):
        common.append("--early-termination")
    stats = (1, 2, 3)
    if args[0] == "gdbf":  # errors, frames and smoothing counts too
        stats = (1, 2, 3, 4, 5, 11, 12)
    rows = _assert_rows_and_keys_equal(tmp_path, common, stats=stats)
    assert all(len(r) == width and r[0] == "3" for r in rows)


@pytest.mark.parametrize("decoder", ["bp", "minsum", "normalizedminsum"])
def test_layered_needs_a_qc_code(tmp_path, decoder):
    """The JAX CLI's message, from both CLIs."""
    args = [decoder, "--code", "peg_96_48", "--schedule", "layered", "-T",
            "2", "--snr", "2.0", "--log", str(tmp_path / "x")]
    msg = "--schedule layered requires a QC-structured --code"
    with pytest.raises(SystemExit, match=msg):
        main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit, match=msg):
        jax_main(args)


@pytest.mark.parametrize("args,width,et", [
    (["bp", "--code", "peg_96_48"], 6, False),
    (["bp", "--code", "qc_1008_504", "--msg-dtype", "f16",
      "--early-termination"], 6, True),
    (["bp", "--code", "qc_1008_504", "--schedule", "layered",
      "--early-termination", "--msg-dtype", "f16"], 6, True),
    (["minsum", "--code", "qc_1008_504", "--schedule", "layered",
      "--msg-dtype", "f16"], 6, False),
    (["normalizedminsum", "--code", "wifi_648_324", "--schedule", "layered",
      "--alpha", "1.25", "--early-termination"], 7, True),
    (["offsetminsum", "--code", "qc_1008_504", "--schedule", "layered",
      "--ymax", "2.0", "--delta", "0.15"], 8, False),
    (["ddbmp", "--code", "peg_96_48"], 7, True),
    (["ddbmp", "--code", "qc_1008_504", "--ymax", "1.6", "1.4", "--nq",
      "8"], 7, True),
])
def test_bp_ddbmp_and_layered_rows_and_keys_equal_jax_cli(tmp_path, args,
                                                          width, et):
    """The routes of this slice through both CLIs: rows equal column for
    column apart from the Monte-Carlo statistics (the packages draw other
    noise), the same ``<log>.done`` keys.  BP logs ``bp_log_row``; DD-BMP
    logs its Ymax (1.5 unless given) and a data-dependent iteration
    average; ``--msg-dtype f16`` is accepted and ignored by layered BP."""
    common = args + ["-T", "4", "--snr", "3.0", "--batch", "32",
                     "--max-frames", "32"]
    rows = _assert_rows_and_keys_equal(tmp_path, common,
                                       stats=(1, 2, 3) if et else (1, 3))
    assert all(len(r) == width for r in rows)
    assert all(r[0] == "3" and r[4] == "4" for r in rows)
    if args[0] == "ddbmp":
        assert [r[5] for r in rows] == (["1.6", "1.4"] if "--ymax" in args
                                        else ["1.5"])
        assert all(0.0 <= float(r[2]) <= 4.0 for r in rows)


@pytest.mark.parametrize("args,smoothing", [
    (["--preset", "SMNGDBF", "--code", "peg_96_48", "--snr", "3.0",
      "--theta", "-0.7", "-0.9", "--noise-scale", "0.8", "0.9",
      "--alpha", "0.75", "--lam", "0.99", "--ymax", "2.5", "--window", "4"],
     True),
    (["--preset", "MNGDBF", "--uniform-noise", "--code", "qc_1008_504",
      "--snr", "3.0,3.5", "--theta", "-0.9", "--alpha", "0.75"], False),
    (["--preset", "StochasticNGDBF", "--code", "qc_1008_504", "--snr",
      "3.5", "--nq", "3", "--ymax", "2.5", "--noise-scale", "0.9"], False),
])
def test_gdbf_rows_and_keys_equal_jax_cli(tmp_path, args, smoothing):
    """Same grid through both CLIs: the same rows, column for column apart
    from the Monte-Carlo statistics (other noise), the same resume keys,
    and the port resumes the JAX CLI's sidecar."""
    common = ["gdbf", "-T", "6", "--batch", "32", "--max-frames", "32"] + args
    plog, jlog = tmp_path / "p.log", tmp_path / "j.log"
    assert main(common + ["--device", "cpu", "--log", str(plog)]) == 0
    assert jax_main(common + ["--log", str(jlog)]) == 0
    prows, jrows = _rows(plog), _rows(jlog)
    assert len(prows) == len(jrows) >= 1
    stats = {1, 2, 3} | ({11, 12} if smoothing else set())
    for p, j in zip(prows, jrows):
        assert len(p) == len(j)
        assert [v for i, v in enumerate(p) if i not in stats] == [
            v for i, v in enumerate(j) if i not in stats]
        assert 0.0 <= float(p[1]) <= 0.5 and float(p[2]) <= 6
    assert (tmp_path / "p.log.done").read_text() == (
        (tmp_path / "j.log.done").read_text())
    assert main(common + ["--device", "cpu", "--log", str(jlog),
                          "--resume"]) == 0
    assert len(_rows(jlog)) == len(jrows)


@pytest.mark.parametrize("args", [
    ["--nb-random", "24:12:3:4", "--early-termination"],
    ["--nb-random", "24:12:3:4", "--stream", "--msg-dtype", "f16"],
    ["--nb-random", "32:16:3:8", "--msg-dtype", "f16", "--snr", "2.5"],
    ["--alist", None, "--early-termination"],
])
def test_nbqspa_rows_and_keys_equal_jax_cli(tmp_path, args):
    """The non-binary route through both CLIs (batched, ``--stream`` and an
    NB alist written here): the row ``SNR SER BER avgIters FER T code``
    column for column apart from the Monte-Carlo statistics (the packages
    draw other noise), the same resume keys."""
    from ldpcsimulation_tpu_torch.codes import nb_regular, save_alist

    path = tmp_path / "gf16.alist"
    save_alist(nb_regular(32, 16, 3, 16, seed=5), str(path))
    args = [str(path) if a is None else a for a in args]
    common = ["nbqspa", "-T", "6", "--batch", "32", "--max-frames", "64",
              *args]
    if "--snr" not in args:
        common += ["--snr", "3.0"]
    rows = _assert_rows_and_keys_equal(tmp_path, common, stats=(1, 2, 3, 4))
    (row,) = rows
    assert len(row) == 7 and row[5] == "6"
    assert row[6] == (str(path) if "--alist" in args
                      else "nb_random_" + args[1])
    assert 0.0 <= float(row[2]) <= float(row[1]) <= 1.0
    assert 0.0 < float(row[3]) <= 6.0 and 0.0 <= float(row[4]) <= 1.0


def test_ngdbfhw_stream_rows_keys_and_itdist_equal_jax_cli(tmp_path):
    """``ngdbfhw --stream`` (refill every 16 steps, lanes = --batch) through
    both CLIs: the row apart from the statistics and the frame count (a
    stream counts whole calls), the resume keys and the itdist file."""
    common = ["ngdbfhw", "--code", "peg_96_48", "--snr", "4.0", "-T", "12",
              "--batch", "32", "--frames", "64", "--stream"]
    plog, jlog = tmp_path / "p.log", tmp_path / "j.log"
    assert main(common + ["--device", "cpu", "--log", str(plog)]) == 0
    assert jax_main(common + ["--log", str(jlog)]) == 0
    (p,), (j,) = _rows(plog), _rows(jlog)
    stats = {1, 2, 3, 4, 5, 6, 7}  # ... bits, frames
    assert len(p) == len(j) == 16
    assert [v for i, v in enumerate(p) if i not in stats] == [
        v for i, v in enumerate(j) if i not in stats]
    assert int(p[7]) >= 64 and p[8] == "12"
    assert (tmp_path / "p.log.done").read_text() == (
        (tmp_path / "j.log.done").read_text())
    it = _itdist(tmp_path / "p.log_4_itdist.dat")
    assert it[0] == (0, 1.0) and all(a >= b for (_, a), (_, b) in
                                     zip(it, it[1:]))


def _itdist(path):
    lines = path.read_text().splitlines()
    return [(int(i), float(v)) for i, v in (ln.split("\t") for ln in lines)]


@pytest.mark.parametrize("args,files", [
    (["--code", "peg_96_48", "--snr", "4.0"], ["4"]),
    (["--code", "qc_1008_504", "--snr", "3.5", "--persistent-qpointer",
      "--itdist-biased"], ["3.5"]),
    (["--code", "peg_96_48", "--snr", "4.0", "--w", "0.185", "0.2",
      "--max-phases", "2", "--persistent-qpointer"],
     ["4_w0.185", "4_w0.2"]),
])
def test_ngdbfhw_rows_keys_and_itdist_equal_jax_cli(tmp_path, args, files):
    """The NGDBFhw route through both CLIs: the same rows column for column
    apart from the Monte-Carlo statistics (errors, word errors, BER,
    iterations, FER), the same resume keys, the same itdist files (the
    swept parameters in their names), each a completion CDF from 1 down,
    and the port resumes the JAX CLI's sidecar."""
    common = ["ngdbfhw", "-T", "12", "--batch", "16", "--frames", "32"] + args
    plog, jlog = tmp_path / "p.log", tmp_path / "j.log"
    assert main(common + ["--device", "cpu", "--log", str(plog)]) == 0
    assert jax_main(common + ["--log", str(jlog)]) == 0
    prows, jrows = _rows(plog), _rows(jlog)
    assert len(prows) == len(jrows) == len(files)
    stats = {1, 2, 3, 4, 5}
    for p, j in zip(prows, jrows):
        assert len(p) == len(j) == 16
        assert [v for i, v in enumerate(p) if i not in stats] == [
            v for i, v in enumerate(j) if i not in stats]
        assert p[7] == "32" and 0.0 <= float(p[3]) <= 0.5
    assert (tmp_path / "p.log.done").read_text() == (
        (tmp_path / "j.log.done").read_text())
    for name in files:
        pit = _itdist(tmp_path / f"p.log_{name}_itdist.dat")
        jit = _itdist(tmp_path / f"j.log_{name}_itdist.dat")
        for it in (pit, jit):
            assert it[0] == (0, 1.0) and [i for i, _ in it] == list(
                range(len(it)))
            assert all(a >= b for (_, a), (_, b) in zip(it, it[1:]))
    assert main(common + ["--device", "cpu", "--log", str(jlog),
                          "--resume"]) == 0
    assert len(_rows(jlog)) == len(jrows)


def _assert_rows_and_keys_equal(tmp_path, common, stats=(1, 3)):
    """Same grid through both CLIs: the same rows column for column apart
    from the Monte-Carlo statistics (other noise), the same resume keys."""
    plog, jlog = tmp_path / "p.log", tmp_path / "j.log"
    assert main(common + ["--device", "cpu", "--log", str(plog)]) == 0
    assert jax_main(common + ["--log", str(jlog)]) == 0
    prows, jrows = _rows(plog), _rows(jlog)
    assert len(prows) == len(jrows) >= 1
    for p, j in zip(prows, jrows):
        assert len(p) == len(j)
        assert [v for i, v in enumerate(p) if i not in stats] == [
            v for i, v in enumerate(j) if i not in stats]
        assert 0.0 <= float(p[1]) <= 0.5
    assert (tmp_path / "p.log.done").read_text() == (
        (tmp_path / "j.log.done").read_text())
    return prows


def test_non_qc_code_and_missing_cuda(tmp_path, monkeypatch):
    """A code without QC structure takes the slot-array decoder, with the
    JAX CLI's row and resume key; without a card the CLI exits."""
    args = ["minsum", "--code", "peg_96_48", "-T", "2", "--snr", "2.0",
            "--batch", "32", "--max-frames", "32"]
    (row,) = _assert_rows_and_keys_equal(tmp_path, args)
    assert row[2] == "2" and row[-1] == "peg_96_48" and len(row) == 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(args + ["--log", str(tmp_path / "x")])


@pytest.mark.parametrize("args,width", [
    (["offsetminsum", "--code", "wifi_1944_972", "--ymax", "2.0", "--nq",
      "8", "--delta", "0.15"], 8),
    (["normalizedminsum", "--code", "peg_1008_504", "--alpha", "1.25",
      "0.8"], 7),
    (["offsetminsum", "--code", "qc_1008_504", "--msg-dtype", "f16",
      "--early-termination"], 6),
    (["normalizedminsum", "--code", "peg_96_48", "--ymax", "1.5", "2.5",
      "--nq", "16"], 7),
])
def test_quantized_minsum_rows_and_keys_equal_jax_cli(tmp_path, args, width):
    """The fixed-point routes decode quantize_no_zero samples (Ymax 2.0
    and 8 levels unless given) and write Ymax and alpha or delta in their
    rows (each only when given), as the JAX CLI does; named QC codes take
    the QC decoder, the others the slot-array one."""
    common = args + ["-T", "4", "--snr", "2.0", "--batch", "32",
                     "--max-frames", "32"]
    et = "--early-termination" in args
    rows = _assert_rows_and_keys_equal(tmp_path, common,
                                       stats=(1, 2, 3) if et else (1, 3))
    assert all(len(r) == width for r in rows)


def test_alist_routes_detected_qc_and_generic(tmp_path, capsys):
    """--alist: a QC matrix in natural order is detected and takes the QC
    decoder (the JAX CLI's stderr note), with the JAX CLI's row; an
    unstructured one takes the slot-array decoder."""
    from ldpcsimulation_tpu_torch.codes import (
        code_to_alist,
        load_named_code,
        save_alist,
    )

    qc_path = tmp_path / "qc.alist"
    save_alist(code_to_alist(load_named_code("qc_1008_504")), str(qc_path))
    common = ["minsum", "--alist", str(qc_path), "-T", "5", "--snr", "2.0",
              "--batch", "32", "--max-frames", "32"]
    (row,) = _assert_rows_and_keys_equal(tmp_path, common)
    assert row[-1] == str(qc_path)
    err = capsys.readouterr().err
    assert err.count("detected QC structure z=84 (6x12 base)") == 2
    peg_path = tmp_path / "peg.alist"
    save_alist(code_to_alist(load_named_code("peg_96_48")), str(peg_path))
    log = tmp_path / "g.log"
    assert main(["offsetminsum", "--alist", str(peg_path), "-T", "3",
                 "--snr", "2.0", "--batch", "16", "--max-frames", "16",
                 "--device", "cpu", "--log", str(log)]) == 0
    assert "detected" not in capsys.readouterr().err
    (grow,) = _rows(log)
    assert grow[2] == "3" and grow[-1] == str(peg_path) and len(grow) == 6
    with pytest.raises(SystemExit):
        main(["minsum", "--alist", str(peg_path), "--code", "peg_96_48",
              "-T", "3", "--snr", "2.0", "--log", str(log)])


def test_parse_snr():
    assert _parse_snr("2.0:2.6:0.3") == [2.0, 2.3, 2.6]
    assert _parse_snr("1,2.5") == [1.0, 2.5]
    with pytest.raises(SystemExit):
        _parse_snr("3:2:0.5")
