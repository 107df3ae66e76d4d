"""The port's experiment tools against the JAX package on the CPU.

Redecode statistics (log rows, chunking, per-attempt replay at B=1, mean
Pe within 4 joint standard errors of the JAX tool), message tracing
(min-sum equal to the JAX tool run in f32; BP by tolerance), error imaging
and the probability levels (equal to the JAX functions, files byte for
byte), the reference cross-check (a missing checkout, a stub binary), the
throughput report (one row at a tiny batch, the byte models, the table),
and the CLIs' flags against the JAX CLIs'.
"""

import contextlib
import io
import math
import os
import re
import stat
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu import tools as jtools
from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import make_regular_code as jmake_regular_code
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.decoders import bp as jbp
from ldpcsimulation_tpu.decoders import gdbf as jg
from ldpcsimulation_tpu.decoders import minsum as jms
from ldpcsimulation_tpu.tools import errimage as jerr
from ldpcsimulation_tpu.tools import msg_trace as jmsg
from ldpcsimulation_tpu.tools import perf_report as jperf
from ldpcsimulation_tpu.tools import prob_combinations as jprob
from ldpcsimulation_tpu.tools import redecode_stats as jredecode
from ldpcsimulation_tpu.tools import validate_reference as jvalidate
from ldpcsimulation_tpu_torch import tools as ptools
from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
from ldpcsimulation_tpu_torch.codes import Code
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import gdbf as pg
from ldpcsimulation_tpu_torch.decoders.gdbf import PR_LEVELS
from ldpcsimulation_tpu_torch.tools import errimage as perr
from ldpcsimulation_tpu_torch.tools import msg_trace as pmsg
from ldpcsimulation_tpu_torch.tools import perf_report as pperf
from ldpcsimulation_tpu_torch.tools import prob_combinations as pprob
from ldpcsimulation_tpu_torch.tools import redecode_stats as predecode
from ldpcsimulation_tpu_torch.tools import validate_reference as pvalidate
from tests.conftest import require_reference
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def small():
    jc = jmake_regular_code(48, 24, 3, seed=4)
    return jc, _port_code(jc)


@pytest.fixture(scope="module")
def peg96():
    jc = jbuild_code(jpeg(96, 48, 3, seed=3))
    return jc, _port_code(jc)


# SMNGDBF on peg(96, 48) at 4 dB: mean Pe(f) ~0.24, half the frames with
# Pe > 0 — a point where the redecode statistics have something to show
REDECODE_KW = dict(num_iterations=30, theta=-0.9, noise_scale=0.9,
                   lam=0.988, alpha=0.9, window_size=8)
REDECODE_SNR = 4.0


def test_tools_exports_equal_jax():
    assert set(ptools.__all__) == set(jtools.__all__)
    for name in ptools.__all__:
        assert callable(getattr(ptools, name)) or isinstance(
            getattr(ptools, name), type)


# -- redecode statistics ----------------------------------------------------

def test_redecode_log_rows_format(peg96, tmp_path):
    _, code = peg96
    cfg = pg.preset("SMNGDBF", **REDECODE_KW)
    with open(tmp_path / "rs.log", "w") as f:
        out = predecode.redecode_statistics(
            code, cfg, REDECODE_SNR, num_frames=6, num_redecodes=8, seed=11,
            log=f, device="cpu")
    assert out.shape == (6, 8) and out.dtype == np.int64
    rows = (tmp_path / "rs.log").read_text().splitlines()
    assert rows == ["\t".join([str(f)] + [str(int(w)) for w in out[f]])
                    for f in range(6)]


def test_redecode_outcomes_do_not_depend_on_chunking(peg96):
    _, code = peg96
    cfg = pg.preset("SMNGDBF", **REDECODE_KW)
    runs = [
        predecode.redecode_statistics(
            code, cfg, REDECODE_SNR, num_frames=7, num_redecodes=6, seed=3,
            device="cpu", batch_frames=bf)
        for bf in (None, 1, 3)
    ]
    for other in runs[1:]:
        np.testing.assert_array_equal(other, runs[0])
    assert (runs[0] > 0).any() and (runs[0] == 0).any()


def test_redecode_attempt_replays_at_b1(peg96):
    """Each attempt is a B=1 decode of frame f's B2 row under
    NoiseKey(seed, f·NR + a); no two attempts share a key."""
    _, code = peg96
    cfg = pg.preset("SMNGDBF", **REDECODE_KW)
    seed, nf, nr = 9, 5, 6
    out = predecode.redecode_statistics(code, cfg, REDECODE_SNR,
                                        num_frames=nf, num_redecodes=nr,
                                        seed=seed, device="cpu")
    keys = {predecode.attempt_key(seed, f, a, nr)
            for f in range(nf) for a in range(nr)}
    assert len(keys) == nf * nr
    sigma = snr_to_sigma(REDECODE_SNR, code.rate)
    for f, a in ((0, 0), (2, 5), (4, 3)):
        y = awgn_all_zero(seed, f, 1, code.n, sigma, "cpu")
        res = pg.decode_gdbf(code, y, sigma, cfg,
                             key=predecode.attempt_key(seed, f, a, nr))
        assert int((res.hard != 1).sum()) == out[f, a]


def _pe_stats(out):
    pe = (np.asarray(out) > 0).mean(axis=1)
    f = len(pe)
    share = (pe > 0).mean()
    return ((pe.mean(), pe.std(ddof=1) / math.sqrt(f)),
            (share, math.sqrt(share * (1 - share) / f)))


def test_redecode_mean_pe_within_jax(peg96):
    """64 frames x 16 attempts on peg(96, 48): the mean Pe(f) and the share
    of frames with Pe > 0 within 4 joint standard errors of the JAX tool
    (frames are the sampling unit; the packages key their noise apart)."""
    jc, code = peg96
    jcfg = jg.preset("SMNGDBF", **REDECODE_KW)
    jout = jredecode.redecode_statistics(jc, jcfg, REDECODE_SNR,
                                         num_frames=64, num_redecodes=16,
                                         seed=0)
    pout = predecode.redecode_statistics(
        code, pg.GDBFConfig.from_reference(jcfg), REDECODE_SNR,
        num_frames=64, num_redecodes=16, seed=0, device="cpu")
    for (jv, jse), (pv, pse) in zip(_pe_stats(jout), _pe_stats(pout)):
        assert abs(jv - pv) <= 4 * math.hypot(jse, pse), (jv, pv)
    assert 0.05 < _pe_stats(pout)[0][0] < 0.6


def test_redecode_cli(peg96, tmp_path, capsys):
    from ldpcsimulation_tpu_torch.codes import code_to_alist, save_alist

    _, code = peg96
    alist = tmp_path / "c.alist"
    save_alist(code_to_alist(code), str(alist))
    log = tmp_path / "cli.log"
    assert predecode._main([
        "--alist", str(alist), "--snr", str(REDECODE_SNR), "-T", "30",
        "--frames", "4", "--redecodes", "5", "--theta", "-0.9",
        "--noise-scale", "0.9", "--alpha", "0.9", "--window", "8",
        "--log", str(log), "--device", "cpu"]) == 0
    out = predecode.redecode_statistics(
        code, pg.preset("SMNGDBF", **REDECODE_KW), REDECODE_SNR,
        num_frames=4, num_redecodes=5, device="cpu")
    assert log.read_text().splitlines() == [
        "\t".join([str(f)] + [str(int(w)) for w in out[f]])
        for f in range(4)]
    pe = (out > 0).mean(axis=1)
    assert capsys.readouterr().err == (
        f"4 frames x 5 redecodes: mean Pe(f) = {pe.mean():.4f}, frames "
        f"with Pe>0: {(pe > 0).sum()}\n")


# -- message tracing --------------------------------------------------------

def _jax_trace(jc, samples, truth, iters, algorithm):
    """The JAX tool in f32 (the tests' session turns x64 on)."""
    with jax.enable_x64(False), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jmsg.trace_soft_decoder(jc, samples, truth, iters, algorithm)


def _assert_traces_equal(pt, jt):
    assert len(pt.decisions) == len(jt.decisions)
    for a, b in zip(pt.v2c_sign_errors, jt.v2c_sign_errors):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.checks_with_errors, jt.checks_with_errors):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pt.decisions, jt.decisions):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("which", ["small", "peg96"])
def test_msg_trace_minsum_equals_jax(which, small, peg96):
    jc, pc = small if which == "small" else peg96
    rng = np.random.default_rng(3)
    y = (1 + 0.8 * rng.standard_normal(jc.n)).astype(np.float32)
    truth = np.ones(jc.n)
    pt = pmsg.trace_soft_decoder(pc, y, truth, 6, "minsum", device="cpu")
    jt = _jax_trace(jc, y, truth, 6, "minsum")
    _assert_traces_equal(pt, jt)
    assert pt.v2c_sign_errors[0].shape == (jc.n, jc.dv_max)
    assert pt.checks_with_errors[0].dtype == np.int64
    assert sum(int(c.sum()) for c in pt.checks_with_errors) > 0
    # every erroneous message reaches exactly one check
    for e, c in zip(pt.v2c_sign_errors, pt.checks_with_errors):
        assert int(e.sum()) == int(c.sum())


def test_msg_trace_minsum_on_a_nonbipolar_truth(small):
    """A random codeword's symbols as the truth (the sign test is per
    symbol); equal to the JAX tool."""
    jc, pc = small
    rng = np.random.default_rng(8)
    truth = np.where(rng.random(jc.n) < 0.5, 1, -1)
    y = (truth * (1 + 0.9 * rng.standard_normal(jc.n))).astype(np.float32)
    _assert_traces_equal(
        pmsg.trace_soft_decoder(pc, y, truth, 4, "minsum", device="cpu"),
        _jax_trace(jc, y, truth, 4, "minsum"))


# PR 5's BP tolerance (tests/test_torch_bp.py): exp/log differ by ulps
BP_RTOL, BP_ATOL = 2e-5, 2e-5


def test_msg_trace_bp_by_tolerance(peg96):
    """BP: every sign error, check count and decision equal the JAX tool's,
    except where a JAX message or posterior lies within the BP tolerance of
    zero (there the sign may flip by an ulp)."""
    jc, pc = peg96
    rng = np.random.default_rng(4)
    llr = (4 * (1 + 0.9 * rng.standard_normal(jc.n)) / 0.9).astype(
        np.float32)
    truth = np.ones(jc.n)
    pt = pmsg.trace_soft_decoder(pc, llr, truth, 5, "bp", device="cpu")
    jt = _jax_trace(jc, llr, truth, 5, "bp")
    # the JAX messages themselves, stepped in f32 as the tool steps them
    with jax.enable_x64(False):
        y_t = jax.numpy.asarray(llr)[:, None]
        v2c = jax.numpy.repeat(y_t, jc.dv_max, axis=0)
        near_msg, near_tot = [], []
        for _ in range(5):
            c2v = jbp.bp_cn_update(jc, v2c)
            v2c, total, _ = jms.vn_update(jc, y_t, c2v, clamp=jbp.MAXLLR)
            m = np.asarray(v2c).reshape(jc.n, jc.dv_max)
            near_msg.append(np.abs(m) <= BP_ATOL + BP_RTOL * np.abs(m))
            t = np.asarray(total)[:, 0]
            near_tot.append(np.abs(t) <= BP_ATOL + BP_RTOL * np.abs(t))
    cn_vn = np.asarray(jc.cn_vn)
    cn_mask = np.asarray(jc.cn_mask)
    flipped = 0
    for it in range(5):
        ok = ~near_msg[it]
        np.testing.assert_array_equal(pt.v2c_sign_errors[it][ok],
                                      jt.v2c_sign_errors[it][ok])
        np.testing.assert_array_equal(pt.decisions[it][~near_tot[it]],
                                      jt.decisions[it][~near_tot[it]])
        touched = (near_msg[it].any(axis=1)[cn_vn] & cn_mask).any(axis=1)
        np.testing.assert_array_equal(pt.checks_with_errors[it][~touched],
                                      jt.checks_with_errors[it][~touched])
        flipped += int(near_msg[it].sum())
    assert flipped < jc.n  # the exclusions stay a small part of the frame
    assert sum(int(c.sum()) for c in pt.checks_with_errors) > 0


def test_msg_trace_guards(small):
    with pytest.raises(ValueError, match="unknown algorithm"):
        pmsg.trace_soft_decoder(small[1], np.ones(48), np.ones(48), 1,
                                "layered", device="cpu")
    tr = pmsg.trace_soft_decoder(small[1], np.ones(48), np.ones(48), 0,
                                 device="cpu")
    assert tr.decisions == [] and tr.v2c_sign_errors == []


# -- error imaging and probability levels -----------------------------------

def test_errimage_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    dec = np.where(rng.random((7, 30)) < 0.2, -1, 1)
    truth = np.ones(30)
    np.testing.assert_array_equal(perr.decisions_to_errors(dec, truth),
                                  jerr.decisions_to_errors(dec, truth))
    assert perr.decisions_to_errors(dec, truth).dtype == np.uint8
    np.testing.assert_array_equal(perr.shift_scale_matrix(dec),
                                  jerr.shift_scale_matrix(dec))
    np.testing.assert_array_equal(
        perr.shift_scale_matrix(dec, 0.5, 3.0),
        jerr.shift_scale_matrix(dec, 0.5, 3.0))
    a, b = dec[:3].astype(float), 2.0 * dec
    for x, y in ((a, b), (b, a), (np.zeros((0, 0)), a)):
        np.testing.assert_array_equal(perr.merge_matrices(x, y),
                                      jerr.merge_matrices(x, y))
    errs = perr.decisions_to_errors(dec, truth)
    for mod, tag in ((perr, "p"), (jerr, "j")):
        mod.error_count_trace(errs, str(tmp_path / f"{tag}.err"))
        mod.write_matrix_file(str(tmp_path / f"{tag}.mat"),
                              np.c_[dec, 0.25 * dec])
    for ext in ("err", "mat"):
        assert (tmp_path / f"p.{ext}").read_bytes() == (
            tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(
        perr.read_matrix_file(str(tmp_path / "p.mat")),
        jerr.read_matrix_file(str(tmp_path / "p.mat")))


def test_errimage_compose_equals_jax(small, tmp_path):
    """errtopng's main on two replay traces (the write_trace format and a
    plain matrix file): the merged matrix and the .err file equal the JAX
    function's, and both PNGs render."""
    from ldpcsimulation_tpu_torch.tools.replay import trace_gdbf, write_trace

    _, pc = small
    sigma = snr_to_sigma(2.0, 0.5)
    rng = np.random.default_rng(1)
    cfg = pg.preset("SMNGDBF", 10, -0.8, noise_scale=0.9, alpha=1.5,
                    window_size=4)
    paths = []
    for i in range(2):
        yq = np.clip(1 + sigma * rng.standard_normal(48), -2.5, 2.5)
        pert = torch.from_numpy(rng.normal(0, 0.5, (10, 48, 1)).astype(
            np.float32))
        tr = trace_gdbf(pc, yq, sigma, cfg, perturbations=pert, device="cpu")
        p = tmp_path / f"t{i}.trace"
        write_trace(tr, str(p))
        paths.append(str(p))
    perr.write_matrix_file(str(tmp_path / "m.mat"), -np.ones((3, 48)))
    paths.append(str(tmp_path / "m.mat"))
    got = perr.compose_error_images(str(tmp_path / "p"), paths)
    want = jerr.compose_error_images(str(tmp_path / "j"), paths)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "p.err").read_bytes() == (
        tmp_path / "j.err").read_bytes()
    assert (tmp_path / "p.png").stat().st_size > 100
    png = tmp_path / "e.png"
    perr.error_matrix_png(perr.decisions_to_errors(
        np.stack([np.ones(48), -np.ones(48)]), np.ones(48)), str(png),
        title="t", scale=2)
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("max_bits,max_ops", [(4, 2), (5, 3), (3, 1)])
def test_prob_combinations_equal_jax(max_bits, max_ops):
    levels = pprob.enumerate_probabilities(max_bits, max_ops)
    assert levels == jprob.enumerate_probabilities(max_bits, max_ops)
    targets = [0.0, 0.03, 0.2, 0.5, 0.77, 1.0, *PR_LEVELS]
    assert pprob.nearest_levels(targets, levels) == jprob.nearest_levels(
        targets, levels)


def test_prob_combinations_realize_the_decoders_levels():
    """The port's own PR_LEVELS (decoders/gdbf.py) are realizable to their
    printed precision, and equal the JAX decoder's table."""
    assert PR_LEVELS == tuple(jg.PR_LEVELS)
    levels = pprob.enumerate_probabilities(max_bits=5, max_ops=3)
    assert 0.0 in levels and 1.0 in levels
    for p in PR_LEVELS:
        snapped = pprob.nearest_levels([p], levels)[0][1]
        assert abs(snapped - p) < 5e-3, (p, snapped)


# -- the reference cross-check ----------------------------------------------

def test_validate_reference_missing_checkout_returns_1(tmp_path, capsys):
    assert pvalidate.main(["--reference", str(tmp_path / "none"),
                           "--device", "cpu"]) == 1
    assert "reference checkout not found" in capsys.readouterr().err
    assert jvalidate.main(["--reference", str(tmp_path / "none")]) == 1


def test_validate_reference_run_ref_on_a_stub(tmp_path):
    """run_ref runs the binary with the reference's argv (alist, rate, SNR,
    T, log) and reads the BER column of the last log row."""
    stub = tmp_path / "decodeStub"
    stub.write_text(
        "#!/bin/sh\n"
        "printf '%s\\t0.0125\\t3.5\\t0.2\\t%s\\n' \"$3\" \"$4\" >> \"$5\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    ber = pvalidate.run_ref(str(stub), "H.alist", 2.0, 10, str(tmp_path),
                            repeats=1)
    assert ber == 0.0125
    row = (tmp_path / "ref.log").read_text().splitlines()[-1]
    assert row.split("\t") == ["2.0", "0.0125", "3.5", "0.2", "10"]


def test_validate_reference_full_run(tmp_path):
    """The whole cross-check, on the reference checkout when it is there."""
    require_reference(pvalidate.PEG_ALIST)
    from tests.conftest import REFERENCE_ROOT

    out = tmp_path / "v.md"
    assert pvalidate.main(["--reference", REFERENCE_ROOT, "--frames", "256",
                           "--out", str(out), "--device", "cpu"]) == 0
    rows = [r for r in out.read_text().splitlines() if r.startswith("| ")]
    assert len(rows) == 8  # the header and 7 operating points


# -- the throughput report --------------------------------------------------

def _jax_nested(name):
    """A byte model of the JAX perf_report (a function nested in its
    main), rebuilt from its code object."""
    code = next(c for c in jperf.main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, {})


def test_perf_report_byte_models_equal_jax():
    jmsg_bytes, jflip = _jax_nested("msg_bytes"), _jax_nested("flip_bytes")
    for e, n, storage, ndirs, overhead in ((3024, 1008, 2, 4, 8),
                                           (3024, 1008, 4, 2, 8),
                                           (226799, 64800, 2, 4, 8),
                                           (16000, 4000, 4, 4, 8)):
        assert pperf.msg_bytes(e, n, storage, ndirs, overhead) == jmsg_bytes(
            e, n, storage, ndirs, overhead)
    assert pperf.msg_bytes(3024, 1008) == jmsg_bytes(3024, 1008, 4, 4, 8)
    for e, n, m in ((3024, 1008, 504), (12288, 2048, 384),
                    (16000, 4000, 2000)):
        assert pperf.flip_bytes(e, n, m) == jflip(e, n, m)
    # the NB model, as the JAX tool writes it inline
    assert pperf.nb_bytes(15000, 6000, 8) == (
        4 * 15000 * 8 * 2 + 2 * 15000 * 4 + 2 * 6000 * 8 * 4)


def test_perf_report_rows_and_one_row_on_the_cpu():
    rows = pperf.rows()
    labels = [r.label for r in rows]
    assert len(set(labels)) == len(labels)
    # no row of the left-behind TPU workarounds; no real-matrix row
    # without the checkout
    assert not any("MXU" in x or "stratified" in x or "REAL 802.3an" in x
                   or "REAL (" in x for x in labels)
    row = next(r for r in rows if "flagship" in r.label)
    assert row.batch == 16384
    m = row.measure("cpu", batch=4, repeats=1)
    assert m.frames == 4 * 8 and m.seconds > 0
    assert m.bits_per_s == pytest.approx(m.frames * 504 / m.seconds)
    assert m.bytes_per_s == pytest.approx(
        m.frames * 10 * pperf.msg_bytes(3024, 1008, storage=2) / m.seconds)
    assert not m.upper
    s = next(r for r in rows if "STREAM refill (K=8)" in r.label)
    m2 = s.measure("cpu", batch=4, repeats=1)
    assert m2.avg_iters is not None and m2.frames > 0
    table = pperf.format_table([m, m2], pperf.card_line("cpu"))
    lines = table.splitlines()
    assert "not a device measurement" in lines[2]
    assert lines[-2].startswith(f"| {m.label} | {m.frames} | ")
    assert lines[-1].count("|") == 7


def test_perf_report_main_on_the_cpu(capsys):
    assert pperf.main(["--only", "GF(64)", "--repeats", "1", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr()
    rows = [r for r in out.out.splitlines() if r.startswith("| FFT")]
    assert len(rows) == 1 and "≤" in rows[0]
    assert "FFT-QSPA GF(64)" in out.err


# -- the CLIs' flags --------------------------------------------------------

def _help_flags(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        fn(["--help"])
    return set(re.findall(r"(?<![\w-])(-T|--[a-z][a-z-]*)", out.getvalue()))


@pytest.mark.parametrize("port,jax_main,added", [
    (predecode._main, jredecode._main, {"--device"}),
    (pvalidate.main, jvalidate.main, {"--device"}),
    (pperf.main, jperf.main, {"--device", "--reference"}),
], ids=["redecode_stats", "validate_reference", "perf_report"])
def test_cli_flags_are_the_jax_clis(port, jax_main, added):
    assert _help_flags(port) == _help_flags(jax_main) | added


def test_tools_import_nothing_of_jax():
    root = os.path.dirname(ptools.__file__)
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            src = open(os.path.join(root, name)).read()
            assert not re.search(r"^\s*(import jax|from jax|"
                                 r"from ldpcsimulation_tpu[ .]|"
                                 r"import ldpcsimulation_tpu\b)", src,
                                 re.M), name
