"""The port's non-binary family against the JAX package: GF(2^m) tables,
``nb_regular`` and the NB ``build_code``, the channel's symbol priors, the
FFT-QSPA machine and decoder, NB min-sum/min-max and ``simulate_nb``.

Tolerances.  The priors go through ``exp``/``log1p``, which XLA and PyTorch
compute a few ulps apart: probabilities within 1e-6 of the row total (1),
log priors within 1e-6 relative.  One check update (``cn_update``): its
messages as normalized probabilities p = exp(x − max over the field)
within 1e-5 (f32 storage; f16 storage: plus 1.1·p times one f16 ulp of
each of the two log values, since an f32 ulp can cross an f16 rounding
boundary), and its log messages within 1e-5 + 1e-5·|x| (f32) or one f16
ulp wherever the probability is above 1e-6 (the inverse WHT of a
vanishing probability cancels to a residue of either sign, whose log is
−69 or ~−18).  ``vn_update``, ``decide`` and ``syndrome_ok`` only
add, take maxima and XOR: equal.  Whole decodes agree in every symbol and
iteration count on ≥ 97 % of frames; the min-sum/min-max decoders equal
the JAX decoders bit for bit on the same negative-log inputs.
``simulate_nb`` draws its channel from kernel B2's rows (keyed per frame),
the JAX package from threefry per batch: the statistics agree within 4
joint standard errors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.channel.nb import symbol_priors as j_priors
from ldpcsimulation_tpu.codes import build_code as j_build_code
from ldpcsimulation_tpu.codes import gf as j_gf
from ldpcsimulation_tpu.codes.alist import parse_alist as j_parse_alist
from ldpcsimulation_tpu.codes.construct import nb_regular as j_nb_regular
from ldpcsimulation_tpu.decoders.nb_minsum import (
    decode_nb_minsum as j_decode_nb_minsum,
)
from ldpcsimulation_tpu.decoders.nb_qspa import (
    decode_nb_qspa as j_decode_nb_qspa,
)
from ldpcsimulation_tpu.decoders.nb_qspa import nb_qspa_machine as j_machine
from ldpcsimulation_tpu.decoders.nb_qspa import wht as j_wht
from ldpcsimulation_tpu_torch.channel import snr_to_n0
from ldpcsimulation_tpu_torch.channel.nb import (
    bits_to_symbols,
    symbol_priors,
    symbols_to_bits,
)
from ldpcsimulation_tpu_torch.codes import (
    build_code,
    dumps_alist,
    gf_bits,
    gf_mul,
    gf_mul_perm,
    gf_tables,
    nb_regular,
    parse_alist,
)
from ldpcsimulation_tpu_torch.decoders.nb_minsum import (
    decode_nb_minsum,
    decode_nb_minsum_nll,
    nb_nll,
)
from ldpcsimulation_tpu_torch.decoders.nb_qspa import (
    decode_nb_qspa,
    nb_qspa_machine,
    wht,
)
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness.montecarlo_nb import simulate_nb
from tests.jax_reference_stats import nb_frames, nb_moments
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FRAME_AGREEMENT = 0.97
F16 = (torch.float16, jnp.float16)
CODE_FIELDS = ("vn_cn", "vn_mask", "vn_deg", "cn_vn", "cn_mask", "cn_deg",
               "cn_from_vn", "vn_from_cn", "vn_coef", "cn_coef")


def _codes(q, n=48, m=24, seed=3):
    """The same (n, m) dv=3 GF(q) code in both packages."""
    return (build_code(nb_regular(n, m, 3, q, seed=seed)),
            j_build_code(j_nb_regular(n, m, 3, q, seed=seed)))


def _channel(q, frames, n, n0, seed):
    """Bit-level samples y = 1 + σ·n of the all-zero word, [F, N, m] f32."""
    m = q.bit_length() - 1
    rng = np.random.default_rng(seed)
    sigma = math.sqrt(n0 / 2.0)
    return (1.0 + sigma * rng.standard_normal((frames, n, m))).astype(
        np.float32)


@pytest.mark.parametrize("q", [4, 8, 16, 32, 64])
def test_gf_tables_equal_jax(q):
    mul, inv = gf_tables(q)
    jmul, jinv = j_gf.gf_tables(q)
    np.testing.assert_array_equal(mul, jmul)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(gf_bits(q), j_gf.gf_bits(q))
    for h in (1, q - 1, q // 2 + 1):
        np.testing.assert_array_equal(gf_mul_perm(q, h),
                                      j_gf.gf_mul_perm(q, h))
    a = np.arange(q)
    np.testing.assert_array_equal(gf_mul(q, a[:, None], a[None, :]), mul)
    # a field: every nonzero element has its inverse, h·a permutes
    assert all(mul[x, inv[x]] == 1 for x in range(1, q))
    assert sorted(gf_mul_perm(q, 3 % q or 1)) == list(range(q))


@pytest.mark.parametrize("n,m,dv,q,seed,method", [
    (48, 24, 3, 4, 3, "peg"),
    (96, 48, 3, 16, 7, "random"),
    (6000, 4000, 3, 8, 0, "peg"),  # the chip path's code: the native PEG
])
def test_nb_regular_equals_jax(n, m, dv, q, seed, method):
    a = nb_regular(n, m, dv, q, seed=seed, method=method)
    ja = j_nb_regular(n, m, dv, q, seed=seed, method=method)
    assert (a.n, a.m, a.q) == (ja.n, ja.m, ja.q) == (n, m, q)
    assert a.nlist == ja.nlist and a.mlist == ja.mlist
    assert a.nvals == ja.nvals and a.mvals == ja.mvals
    assert all(1 <= v < q for row in a.nvals for v in row)


@pytest.mark.parametrize("q", [4, 64])
def test_nb_alist_and_build_code_equal_jax(q):
    """An NB alist's text parses the same in both packages, and
    ``build_code`` gives the JAX package's slot tables and coefficient
    tables (``vn_coef``/``cn_coef``)."""
    text = dumps_alist(nb_regular(96, 48, 3, q, seed=11))
    a, ja = parse_alist(text), j_parse_alist(text)
    assert (a.q, a.nvals, a.mvals) == (ja.q, ja.nvals, ja.mvals)
    code, jcode = build_code(a), j_build_code(ja)
    assert (code.q, code.dv_max, code.dc_max, code.num_edges) == (
        jcode.q, jcode.dv_max, jcode.dc_max, jcode.num_edges)
    for f in CODE_FIELDS:
        np.testing.assert_array_equal(getattr(code, f).numpy(),
                                      np.asarray(getattr(jcode, f)), f)
    assert int(code.cn_coef[code.cn_mask].min()) >= 1


@pytest.mark.parametrize("q", [4, 8, 16])
def test_symbol_priors_equal_jax(q):
    n0 = float(snr_to_n0(1.0, 0.5))
    y = _channel(q, 32, 40, n0, q)
    p = symbol_priors(torch.from_numpy(y), n0, q).numpy()
    jp = np.asarray(j_priors(jnp.asarray(y), n0, q))
    assert p.dtype == np.float32 and p.shape == (32, 40, q)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-6)
    assert np.abs(p - jp).max() <= 1e-6
    lp, jlp = np.log(p.astype(np.float64)), np.log(jp.astype(np.float64))
    assert (np.abs(lp - jlp) <= 1e-6 * np.maximum(1.0, np.abs(jlp))).all()


def test_symbols_and_bits_round_trip():
    s = torch.arange(64).reshape(8, 8)
    bits = symbols_to_bits(s, 64)
    assert bits.shape == (8, 8, 6)
    assert torch.equal(bits_to_symbols(bits, 64), s.to(torch.int32))
    assert torch.equal(bits[0, 5], torch.tensor([1, 0, 1, 0, 0, 0]))


@pytest.mark.parametrize("q", [2, 8, 64])
def test_wht_equals_jax(q):
    x = np.random.default_rng(q).standard_normal((3, q, 5)).astype(np.float32)
    got = wht(torch.from_numpy(x), axis=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_wht(jnp.asarray(x), 1)))
    # self-inverse up to q
    np.testing.assert_allclose(
        wht(torch.from_numpy(got), axis=1).numpy() / q, x, atol=1e-5)


def _messages(code, q, b, rng, dtype):
    """Max-normalized log messages [N·dv_max, q, B] and log priors."""
    v = -rng.exponential(4.0, (code.n * code.dv_max, q, b))
    lp = -rng.exponential(4.0, (code.n, q, b))
    v = (v - v.max(axis=1, keepdims=True)).astype(np.float32).astype(dtype)
    lp = (lp - lp.max(axis=1, keepdims=True)).astype(np.float32)
    return v, lp


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("f16", [False, True])
@pytest.mark.parametrize("q", [4, 8, 16])
def test_machine_updates_equal_jax(q, f16, fresh):
    """One ``cn_update`` (each of the three CN forms: q = 4 class combine, q
    = 8 sign tables, q = 16 permutation + butterflies) and one
    ``vn_update``, ``decide`` and ``syndrome_ok`` against the JAX machine
    on the same inputs."""
    code, jcode = _codes(q, seed=5)
    sdt, jsdt = F16 if f16 else (None, None)
    rng = np.random.default_rng(10 * q + f16)
    b = 16
    v, lp = _messages(code, q, b, rng, np.float16 if f16 else np.float32)
    mask = rng.random(b) < 0.5
    M = nb_qspa_machine(code, q, torch.float32, sdt)
    JM = j_machine(jcode, q, jnp.float32, jsdt)
    kw, jkw = {}, {}
    if fresh:
        kw = dict(log_pri=torch.from_numpy(lp), fresh=torch.from_numpy(mask))
        jkw = dict(log_pri=jnp.asarray(lp), fresh=jnp.asarray(mask))
    c2v = M["cn_update"](torch.from_numpy(v), **kw)
    jc2v = np.array(JM["cn_update"](jnp.asarray(v), **jkw))
    assert c2v.dtype == (torch.float16 if f16 else torch.float32)
    got, want = c2v.float().numpy(), jc2v.astype(np.float32)
    top = want.max(axis=1, keepdims=True)
    p, pw = np.exp(got - got.max(axis=1, keepdims=True)), np.exp(want - top)
    ulp = np.spacing(np.abs(jc2v)).astype(np.float32)
    if f16:  # one f16 ulp of each of the two log values
        ptol = 1e-5 + 1.1 * pw * (ulp + np.spacing(np.abs(top).astype(
            np.float16)).astype(np.float32))
        tol = ulp
    else:
        ptol, tol = 1e-5, 1e-5 + 1e-5 * np.abs(want)
    assert (np.abs(p - pw) <= ptol).all()
    live = pw > 1e-6  # away from the inverse WHT's cancellation residues
    assert (np.abs(got - want) <= tol)[live].all()
    # the VN side on the same (JAX) check messages: adds and maxima
    v2c, post = M["vn_update"](torch.from_numpy(jc2v), torch.from_numpy(lp))
    jv2c, jpost = JM["vn_update"](jnp.asarray(jc2v), jnp.asarray(lp))
    np.testing.assert_array_equal(v2c.float().numpy(),
                                  np.asarray(jv2c).astype(np.float32))
    np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
    sym, jsym = M["decide"](post), JM["decide"](jpost)
    assert sym.dtype == torch.int8
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(M["syndrome_ok"](sym).numpy(),
                                  np.asarray(JM["syndrome_ok"](jsym)))
    np.testing.assert_array_equal(
        M["init"](torch.from_numpy(lp)).float().numpy(),
        np.asarray(JM["init"](jnp.asarray(lp))).astype(np.float32))


def test_decisions_take_the_first_maximum():
    """``torch.argmax`` and ``jnp.argmax`` both return the first of tied
    maxima; ``syndrome_ok`` accepts the zero word and a codeword scaled by
    a coefficient, and rejects a single symbol error."""
    code, jcode = _codes(8, seed=5)
    post = np.zeros((code.n, 8, 3), np.float32)
    post[:, 3, 0] = post[:, 5, 0] = 1.0  # tie between 3 and 5
    post[:, 6, 1] = 2.0
    post[:, 7, 1] = 2.0  # tie between 6 and 7
    M, JM = nb_qspa_machine(code, 8), j_machine(jcode, 8)
    sym = M["decide"](torch.from_numpy(post))
    np.testing.assert_array_equal(sym.numpy(),
                                  np.asarray(JM["decide"](jnp.asarray(post))))
    assert (sym[:, 0] == 3).all() and (sym[:, 1] == 6).all()
    assert (sym[:, 2] == 0).all()
    zero = torch.zeros((code.n, 2), dtype=torch.int8)
    zero[7, 1] = 3
    assert M["syndrome_ok"](zero).tolist() == [True, False]


@pytest.mark.parametrize("f16", [False, True])
@pytest.mark.parametrize("q", [4, 8, 16])
def test_decode_nb_qspa_agrees_with_jax(q, f16):
    code, jcode = _codes(q)
    sdt, jsdt = F16 if f16 else (None, None)
    n0 = float(snr_to_n0(1.5 if q > 4 else 2.0, code.rate))
    y = _channel(q, 64, code.n, n0, 100 + q)
    pri = np.array(j_priors(jnp.asarray(y), n0, q))
    res = decode_nb_qspa(code, torch.from_numpy(pri), 12, storage_dtype=sdt)
    jres = j_decode_nb_qspa(jcode, jnp.asarray(pri), 12, storage_dtype=jsdt)
    assert res.symbols.dtype == torch.int32 and res.symbols.shape == (64, 48)
    same = ((res.symbols.numpy() == np.asarray(jres.symbols)).all(axis=1)
            & (res.iterations.numpy() == np.asarray(jres.iterations))
            & (res.satisfied.numpy() == np.asarray(jres.satisfied)))
    assert same.mean() >= FRAME_AGREEMENT, same.mean()
    # the operating point decodes some frames and not all at once
    assert 0 < res.satisfied.float().mean() and res.iterations.max() > 1


def test_decode_nb_qspa_fixed_trip_equals_jax():
    code, jcode = _codes(8)
    n0 = float(snr_to_n0(1.5, code.rate))
    pri = np.array(j_priors(jnp.asarray(_channel(8, 32, 48, n0, 1)), n0, 8))
    res = decode_nb_qspa(code, torch.from_numpy(pri), 6,
                         early_termination=False)
    jres = j_decode_nb_qspa(jcode, jnp.asarray(pri), 6,
                            early_termination=False)
    assert (res.iterations == 6).all()
    same = (res.symbols.numpy() == np.asarray(jres.symbols)).all(axis=1)
    assert same.mean() >= FRAME_AGREEMENT
    np.testing.assert_array_equal(res.satisfied.numpy(),
                                  np.asarray(jres.satisfied))


@pytest.mark.parametrize("variant", ["minsum", "minmax"])
@pytest.mark.parametrize("q", [4, 8, 16])
def test_nb_minsum_equals_jax_on_the_same_negative_logs(q, variant):
    """After the negative log the decoders select, add and take minima:
    on the JAX decoder's own negative-log inputs every symbol, iteration
    count and flag is equal; the port's negative logs are within 1e-5."""
    code, jcode = _codes(q)
    n0 = float(snr_to_n0(2.0, code.rate))
    pri = jnp.asarray(j_priors(jnp.asarray(_channel(q, 48, 48, n0, q)), n0, q))
    lp = jnp.moveaxis(pri, 0, -1)
    jnll = -jnp.log(lp + jnp.asarray(1e-30, lp.dtype))
    jnll = np.array(jnll - jnp.min(jnll, axis=1, keepdims=True))
    for et in (True, False):
        res = decode_nb_minsum_nll(code, torch.from_numpy(jnll), 8, variant,
                                   early_termination=et)
        jres = j_decode_nb_minsum(jcode, pri, 8, variant=variant,
                                  early_termination=et)
        np.testing.assert_array_equal(res.symbols.numpy(),
                                      np.asarray(jres.symbols))
        np.testing.assert_array_equal(res.iterations.numpy(),
                                      np.asarray(jres.iterations))
        np.testing.assert_array_equal(res.satisfied.numpy(),
                                      np.asarray(jres.satisfied))
    nll = nb_nll(torch.from_numpy(np.array(pri))).numpy()
    assert np.abs(nll - jnll).max() <= 1e-5 * max(1.0, np.abs(jnll).max())
    whole = decode_nb_minsum(code, torch.from_numpy(np.array(pri)), 8,
                             variant)
    assert 0 < whole.satisfied.float().mean()


def test_nb_minsum_rejects_unknown_variant():
    code, _ = _codes(4)
    with pytest.raises(ValueError, match="variant"):
        decode_nb_minsum(code, torch.full((2, 48, 4), 0.25), 2, "maxsum")


def test_simulate_nb_statistics_agree_with_jax():
    """``simulate_nb`` (kernel B2's plain twin) against the JAX package's
    run on a small GF(4) code at the same point: SER, BER, FER and average
    iterations within 4 joint standard errors."""
    code, jcode = _codes(4, n=96, m=48, seed=1)
    snr, T, frames = 2.5, 10, 1024
    stats = simulate_nb(code, snr, T, stop=StopRule.fixed_frames(frames),
                        batch_size=256, seed=4, device="cpu")
    got = _port_moments(stats)
    want = nb_moments(*nb_frames(jcode, snr, T, frames, 256), jcode.n, 4)
    assert stats.total_words == frames and 30 <= stats.word_errors
    for key in ("ser", "ber", "fer", "avg_iterations"):
        (v, se), (w, wse) = got[key], want[key]
        assert abs(v - w) <= 4 * math.hypot(se, wse), (key, v, w)


def _port_moments(stats):
    """(value, s.e.) from the port's per-frame histograms, as
    ``chip_smoke.nb_moments`` computes them."""
    f = stats.total_words

    def hist_moments(hist, offset, scale):
        w = np.arange(len(hist)) + offset
        mean = (w * hist).sum() / f
        var = ((w**2 * hist).sum() / f - mean**2) * f / (f - 1)
        return mean / scale, math.sqrt(var / f) / scale

    m = stats.q.bit_length() - 1
    return dict(ser=hist_moments(stats.symbol_weight_hist, 1, stats.n),
                ber=hist_moments(stats.bit_weight_hist, 1, stats.n * m),
                fer=(stats.fer, math.sqrt(stats.fer * (1 - stats.fer) / f)),
                avg_iterations=hist_moments(stats.iteration_hist, 0, 1.0))


def test_simulate_nb_frames_do_not_depend_on_the_batch():
    """A frame is a pure function of (seed, frame index): two batch sizes
    give the same totals and histograms, and the histograms sum to the
    counters."""
    code, _ = _codes(8)
    kw = dict(stop=StopRule.fixed_frames(96), seed=2, device="cpu",
              storage_dtype=torch.float16)
    a = simulate_nb(code, 1.5, 8, batch_size=96, **kw)
    b = simulate_nb(code, 1.5, 8, batch_size=40, **kw)
    for k in ("symbol_errors", "bit_errors", "uncoded_symbol_errors",
              "word_errors", "total_iterations", "total_words"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.word_errors > 0
    np.testing.assert_array_equal(a.bit_weight_hist, b.bit_weight_hist)
    w = np.arange(1, len(a.symbol_weight_hist) + 1)
    assert (w * a.symbol_weight_hist).sum() == a.symbol_errors
    assert a.symbol_weight_hist.sum() == a.word_errors
    assert (np.arange(len(a.iteration_hist)) * a.iteration_hist).sum() == (
        a.total_iterations)
    assert a.total_bits == 96 * 48 * 3 and a.ber <= a.ser


def test_simulate_nb_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, _ = _codes(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_nb(code, 2.0, 4, stop=StopRule.fixed_frames(4))
    with pytest.raises(ValueError, match="GF"):
        simulate_nb(build_code(parse_alist(dumps_alist(
            nb_regular(12, 6, 3, 2)))), 2.0, 4, device="cpu")
