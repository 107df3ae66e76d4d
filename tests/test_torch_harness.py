"""The port's Monte-Carlo harness: statistics, stopping, itdist and log rows
identical to the JAX package's; ``simulate`` within Monte-Carlo bounds of
the flagship operating point, replayable across batch sizes, and symmetric
under codeword fixtures."""

import jax
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import make_encoder, random_codewords
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.harness import logging as jlog
from ldpcsimulation_tpu.harness import montecarlo as jmc
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_qc
from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
from ldpcsimulation_tpu_torch.harness import logging as plog
from ldpcsimulation_tpu_torch.harness import montecarlo as mc
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FLAGSHIP_BER_2DB = 2.396e-2  # codes/library.py: qc_1008_504, min-sum T=10


def _stats_pair(n=96):
    fields = dict(n=n, errors=1234, uncoded_errors=5001,
                  total_bits=n * 700, total_words=700, word_errors=37,
                  total_iterations=6543, satisfied_words=650)
    hist = np.zeros(n, np.int64)
    hist[[0, 4, 11, n - 1]] = [3, 7, 20, 7]
    ith = np.array([0, 5, 100, 595], np.int64)
    return (
        jmc.MCStats(error_weight_hist=hist.copy(), iteration_hist=ith.copy(),
                    **fields),
        mc.MCStats(error_weight_hist=hist.copy(), iteration_hist=ith.copy(),
                   **fields),
    )


@pytest.mark.parametrize("extra", [
    {}, dict(ymax=2.0), dict(alpha=0.8), dict(delta=0.15),
    dict(ymax=1.5, alpha=1.25, delta=0.1),
])
def test_minsum_row_and_report_byte_identical(extra):
    js, ps = _stats_pair()
    for snr in (2.0, 2.25, 3.1):
        assert plog.minsum_log_row(snr, ps, 10, "qc_1008_504", **extra) == (
            jlog.minsum_log_row(snr, js, 10, "qc_1008_504", **extra)
        )
    assert ps.incremental_report() == js.incremental_report()
    assert (ps.ber, ps.fer, ps.uncoded_ber, ps.avg_iterations) == (
        js.ber, js.fer, js.uncoded_ber, js.avg_iterations
    )


def test_other_rows_byte_identical():
    js, ps = _stats_pair()
    assert plog.bp_log_row(2.0, ps, 20, "c") == jlog.bp_log_row(2.0, js, 20, "c")
    kw = dict(noise_scale=0.9, nq=3, lam=0.99, alpha=0.75,
              smoothing_used=17, window_size=64, ymax=2.5)
    assert plog.gdbf_log_row(3.0, ps, 100, -0.9, "c", **kw) == (
        jlog.gdbf_log_row(3.0, js, 100, -0.9, "c", **kw)
    )
    args = (4.0, None, 300, -0.525, 0.95, 0.185, 1.625, 8, 1, 7)
    assert plog.ngdbfhw_log_row(args[0], ps, *args[2:]) == (
        jlog.ngdbfhw_log_row(args[0], js, *args[2:])
    )
    assert [plog.fmt(v) for v in (True, 3, 2.0, 1e-7)] == [
        jlog.fmt(v) for v in (True, 3, 2.0, 1e-7)
    ]


def test_stop_rule_and_schedule_equal_jax():
    rules = [(200, 20, None), (200, 40, 5000), (0, 0, 300), (10, 0, None)]
    for mb, mw, mf in rules:
        j = jmc.StopRule(mb, mw, mf)
        p = mc.StopRule(mb, mw, mf)
        for errs in (0, 9, 10, 199, 200, 5000):
            for werrs in (0, 19, 20, 40):
                for words in (0, 299, 300, 5000):
                    assert p.done(errs, werrs, words) == j.done(
                        errs, werrs, words
                    )
    assert mc.StopRule.fixed_frames(77) == mc.StopRule(0, 0, 77)
    for n in (96, 10000, 10001, 50000, 64800):
        assert mc.default_min_word_errors(n) == jmc.default_min_word_errors(n)


def test_itdist_equal_jax():
    js, ps = _stats_pair()
    np.testing.assert_array_equal(ps.iteration_cdf(), js.iteration_cdf())
    for seed in (0, 3):
        np.testing.assert_array_equal(
            ps.iteration_cdf_biased(seed), js.iteration_cdf_biased(seed)
        )
    ls = np.random.default_rng(1).integers(0, 12, 500)
    np.testing.assert_array_equal(
        mc.itdist_biased_sequence(ls, 12), jmc.itdist_biased_sequence(ls, 12)
    )


def test_simulate_flagship_ber_within_mc_bounds():
    """qc_1008_504, 2.0 dB, T=10, f16 storage, 2048 frames on the CPU:
    BER within 4 standard errors of the JAX package's 2.396e-2, the
    standard error taken from this run's own per-frame error counts."""
    qc = load_named_qc("qc_1008_504")
    stats = mc.simulate(
        qc.to_code(),
        lambda y: decode_minsum_qc(qc, y, 10, storage_dtype=torch.float16),
        snr_db=2.0, stop=mc.StopRule.fixed_frames(2048), batch_size=1024,
        seed=0,
    )
    assert stats.total_words == 2048 and stats.total_bits == 2048 * qc.n
    w = np.arange(1, qc.n + 1)
    h = stats.error_weight_hist
    assert int((w * h).sum()) == stats.errors
    f = stats.total_words
    mean = stats.errors / f
    var = ((w**2 * h).sum() / f - mean**2) * f / (f - 1)
    se = np.sqrt(var / f) / qc.n
    assert abs(stats.ber - FLAGSHIP_BER_2DB) < 4 * se, (stats.ber, se)
    assert stats.avg_iterations == 10 and stats.iteration_hist[10] == 2048
    assert 0.1 < stats.fer < 0.9
    assert stats.uncoded_ber > stats.ber


@pytest.fixture(scope="module")
def small():
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8)
    return jqc, QCCode.from_reference(jqc)


def _run(qc, **kw):
    return mc.simulate(
        qc.to_code(),
        lambda y: decode_minsum_qc(qc, y, 8, early_termination=True),
        snr_db=2.5, **kw,
    )


def _summary(s):
    return (s.errors, s.word_errors, s.uncoded_errors, s.total_iterations,
            s.satisfied_words, s.total_words, s.error_weight_hist.tolist(),
            s.iteration_hist.tolist())


def test_simulate_replays_across_batch_sizes(small):
    _, qc = small
    stop = mc.StopRule.fixed_frames(200)
    a = _run(qc, stop=stop, batch_size=64, seed=3)
    b = _run(qc, stop=stop, batch_size=96, seed=3)
    assert a.total_words == 200 and _summary(a) == _summary(b)
    assert _summary(_run(qc, stop=stop, batch_size=64, seed=4)) != _summary(a)


def test_simulate_codewords_match_all_zero(small):
    """Min-sum is symmetric under codewords: x·y₊₁ decodes to x·decode(y₊₁),
    so fixture frames give the all-zero run's statistics exactly."""
    jqc, qc = small
    enc = make_encoder(jqc.to_code())
    cw = np.asarray(random_codewords(enc, jax.random.key(5), 10), np.uint8)
    assert cw.any()
    stop = mc.StopRule.fixed_frames(150)
    base = _run(qc, stop=stop, batch_size=64, seed=2)
    fix = _run(qc, stop=stop, batch_size=64, seed=2, codewords=cw)
    assert _summary(fix) == _summary(base)
    with pytest.raises(ValueError):
        _run(qc, stop=stop, codewords=cw[:, :-1])


def test_simulate_stops_on_errors_and_reports(small, capsys):
    _, qc = small
    stats = _run(qc, stop=mc.StopRule(min_bit_errors=50, min_word_errors=5),
                 batch_size=32, seed=1, verbose=True)
    assert stats.errors >= 50 and stats.word_errors >= 5
    assert stats.total_words % 32 == 0
    out = capsys.readouterr().out
    assert out.count("Incremental result:") == stats.total_words // 32
    assert "Final result:" in out
