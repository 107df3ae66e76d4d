"""The port's trace mode and replay tool against the JAX package.

``decode_gdbf(trace=True)``: the per-step decisions equal the JAX
decoder's trace on the same samples and injected draws, and the result
equals ``trace=False``.  Replay: a frame of a ``simulate`` batch replays
bit for bit at B=1 (its own key, or its batch key's column injected);
``trace_gdbf`` rows equal the JAX ``trace_gdbf`` rows on the same input
and draws; the CLI's trace file equals the JAX ``write_trace`` output byte
for byte.  Small codes and T ≤ 30 keep the JAX compiles short.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import make_regular_code as jmake_regular_code
from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.decoders import gdbf as jg
from ldpcsimulation_tpu.tools import replay as jreplay
from ldpcsimulation_tpu_torch.channel import (
    awgn_all_zero,
    saturate,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes import Code
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import gdbf as pg
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from ldpcsimulation_tpu_torch.tools import replay as preplay
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hard", "iterations", "satisfied", "phases", "smoothing_used")


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def small():
    """(JAX code, port code): the JAX tool tests' (48, 24) regular code."""
    jc = jmake_regular_code(48, 24, 3, seed=4)
    return jc, _port_code(jc)


@pytest.fixture(scope="module")
def peg96():
    """(JAX code, port code): peg(96, 48, 3, seed=3)."""
    jc = jbuild_code(jpeg(96, 48, 3, seed=3))
    return jc, _port_code(jc)


# (preset, config overrides): noisy presets, the stochastic rule, redecode
# phases and output smoothing on a deterministic preset
TRACE_CASES = [
    ("SMNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=1.5, window_size=6)),
    ("MNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=1.5)),
    ("StochasticNGDBF", dict(noise_scale=0.9, alpha=1.5)),
    ("RSMNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=1.5, window_size=4,
                      max_phases=3)),
    ("SATGDBF", dict(lam=0.98, window_size=6)),
]


def _draws(rng, cfg, n, b, sigma):
    steps = cfg.max_phases * cfg.num_iterations
    pert = unif = None
    if cfg.add_noise:
        pert = rng.normal(0.0, sigma * cfg.noise_scale,
                          (steps, n, b)).astype(np.float32)
    if cfg.quantize_probabilities:
        unif = rng.uniform(size=(steps, n, b)).astype(np.float32)
    return pert, unif


def _torch(x):
    return None if x is None else torch.from_numpy(x)


def _jax(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name,kw", TRACE_CASES,
                         ids=[c[0] for c in TRACE_CASES])
def test_decode_trace_equals_jax(small, name, kw):
    """d_steps equal the JAX trace on the same samples and injected draws
    (frozen frames included); the result equals trace=False's and JAX's."""
    jc, pc = small
    rng = np.random.default_rng(5)
    sigma = snr_to_sigma(2.5, 0.5)
    T = 8 if name == "RSMNGDBF" else 12
    jcfg = jg.preset(name, num_iterations=T, theta=-0.8, **kw)
    pcfg = pg.GDBFConfig.from_reference(jcfg)
    y = np.clip(1.0 + sigma * rng.standard_normal((8, jc.n)), -2.5,
                2.5).astype(np.float32)
    pert, unif = _draws(rng, jcfg, jc.n, 8, sigma)
    jres, jd = jg.decode_gdbf(
        jc, jnp.asarray(y), sigma, jcfg, key=jax.random.key(0), trace=True,
        perturbations=_jax(pert), stoch_uniforms=_jax(unif))
    pres, pd = pg.decode_gdbf(
        pc, torch.from_numpy(y), sigma, pcfg, trace=True,
        perturbations=_torch(pert), stoch_uniforms=_torch(unif))
    plain = pg.decode_gdbf(
        pc, torch.from_numpy(y), sigma, pcfg,
        perturbations=_torch(pert), stoch_uniforms=_torch(unif))
    assert pd.shape == (jcfg.max_phases * T, jc.n, 8)
    assert pd.dtype == torch.int32
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pres, f).numpy(),
                                      np.asarray(getattr(jres, f)), f)
        assert torch.equal(getattr(pres, f), getattr(plain, f)), f
    assert pres.steps == jcfg.max_phases * T
    sat = pres.satisfied.numpy()
    assert sat.any() and not sat.all()  # both kinds of frame traced
    if name == "RSMNGDBF":
        assert int(pres.phases.max()) > 1


def test_trace_runs_the_whole_budget(small):
    """Trace mode has no "all done" read and no early exit: a batch that
    checks out at step 0 still runs every step."""
    _, pc = small
    cfg = pg.preset("GDBF", 9, -0.9)
    res, d = pg.decode_gdbf(pc, torch.ones((2, pc.n)), 0.5, cfg, trace=True)
    assert res.steps == 9 and d.shape == (9, pc.n, 2)
    assert (d == 1).all() and bool(res.satisfied.all())
    assert pg.decode_gdbf(pc, torch.ones((2, pc.n)), 0.5,
                          cfg).steps <= pg.DONE_CHECK_EVERY


# presets whose replay draws decoder noise: B4 (with and without shaping),
# B3 through the uniform-noise transform, B3's stochastic uniforms
REPLAY_CASES = [
    ("SMNGDBF", {}),
    ("MNGDBF", dict(noise_shaping=True)),
    ("SMNGDBF", dict(uniform_noise=True)),
    ("StochasticNGDBF", {}),
]


@pytest.mark.parametrize("name,kw", REPLAY_CASES,
                         ids=["SMNGDBF", "MNGDBF-shaping", "SMNGDBF-uniform",
                              "StochasticNGDBF"])
def test_replay_reproduces_in_batch_gdbf_decode(peg96, name, kw):
    """A frame replayed through replay_channel + trace_gdbf at B=1
    reproduces the decode it had INSIDE its simulate batch exactly, with
    its own key, and with its batch key's column injected through
    replay_decoder_randomness."""
    _, code = peg96
    cfg = pg.preset(name, num_iterations=30, theta=-0.8, noise_scale=0.9,
                    lam=0.98, alpha=0.9, window_size=8, **kw)
    sigma = snr_to_sigma(3.0, 0.5)
    seed, B = 11, 8
    batches = []

    def dec(yq, key):
        res = pg.decode_gdbf(code, yq, sigma, cfg, key=key)
        batches.append((key, res))
        return res

    simulate(code, dec, 3.0, stop=StopRule.fixed_frames(3 * B),
             batch_size=B, seed=seed, preprocess=lambda y: saturate(y, 2.5),
             device="cpu")
    batch_index = 2
    bkey, bres = batches[batch_index]
    assert bkey == NoiseKey(seed, batch_index * B)
    for frame in (0, 5):
        y_f, fkey = preplay.replay_channel(code, seed, batch_index, frame, B,
                                           sigma, device="cpu")
        assert fkey == NoiseKey(seed, batch_index * B + frame)
        want_y = awgn_all_zero(seed, batch_index * B, B, code.n, sigma,
                               "cpu")[frame]
        assert torch.equal(y_f, want_y)
        yq = saturate(y_f, 2.5)
        pert, stoch = preplay.replay_decoder_randomness(
            code.n, cfg, bkey, B, frame, sigma, device="cpu")
        assert (stoch is None) == (not cfg.quantize_probabilities)
        for tr in (
            preplay.trace_gdbf(code, yq, sigma, cfg, key=fkey),
            preplay.trace_gdbf(code, yq, sigma, cfg, perturbations=pert,
                               stoch_uniforms=stoch),
        ):
            assert tr.iterations == int(bres.iterations[frame])
            assert tr.satisfied == bool(bres.satisfied[frame])
            np.testing.assert_array_equal(tr.decisions[-1],
                                          bres.hard[frame].numpy())


def test_replay_channel_codewords_and_forms(peg96):
    """bits as a frame's word or its batch's words; both AWGN forms as
    simulate applies them; the guards."""
    _, code = peg96
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2, (4, code.n)).astype(np.uint8)
    y0, _ = preplay.replay_channel(code, 3, 1, 2, 4, 0.7, device="cpu")
    c = torch.from_numpy(1 - 2 * words[2].astype(np.int32))
    for bits in (words, words[2]):
        y, _ = preplay.replay_channel(code, 3, 1, 2, 4, 0.7, bits=bits,
                                      device="cpu")
        assert torch.equal(y, c * y0)
        y, _ = preplay.replay_channel(code, 3, 1, 2, 4, 0.7, bits=bits,
                                      awgn_form="additive", device="cpu")
        assert torch.equal(y, y0 + (c - 1.0))
    with pytest.raises(ValueError, match="outside"):
        preplay.replay_channel(code, 3, 1, 4, 4, 0.7, device="cpu")
    with pytest.raises(ValueError, match="AWGN form"):
        preplay.replay_channel(code, 3, 1, 0, 4, 0.7, bits=words,
                               awgn_form="nope", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        preplay.replay_decoder_randomness(
            code.n, pg.preset("SMNGDBF", 5, -0.9), NoiseKey(0, 0), 2, 2, 0.7,
            device="cpu")


@pytest.mark.parametrize("name,kw,snr,expect_sat", [
    ("SMNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=0.9, window_size=8),
     5.5, True),
    ("SMNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=0.9, window_size=8),
     0.5, False),
    ("StochasticNGDBF", dict(noise_scale=0.9, alpha=1.5), 3.0, None),
    ("RSMNGDBF", dict(noise_scale=0.9, lam=0.98, alpha=1.5, window_size=4,
                      max_phases=3), 1.5, None),
], ids=["satisfied", "unsatisfied-smoothed", "stochastic", "phases"])
def test_trace_gdbf_rows_equal_jax(small, name, kw, snr, expect_sat):
    """trace_gdbf's rows (channel row, executed rounds, the smoothed last
    row of an unsatisfied frame), syndromes and flags equal the JAX
    trace_gdbf's on the same yq and injected draws."""
    jc, pc = small
    rng = np.random.default_rng(7)
    T = 8 if name == "RSMNGDBF" else 20
    jcfg = jg.preset(name, num_iterations=T, theta=-0.8, **kw)
    pcfg = pg.GDBFConfig.from_reference(jcfg)
    sigma = snr_to_sigma(snr, 0.5)
    yq = np.clip(1.0 + sigma * rng.standard_normal(jc.n), -2.5,
                 2.5).astype(np.float32)
    pert, unif = _draws(rng, jcfg, jc.n, 1, sigma)
    jt = jreplay.trace_gdbf(jc, yq, sigma, jcfg, key=jax.random.key(0),
                            perturbations=_jax(pert),
                            stoch_uniforms=_jax(unif))
    pt = preplay.trace_gdbf(pc, yq, sigma, pcfg, perturbations=_torch(pert),
                            stoch_uniforms=_torch(unif), device="cpu")
    assert (pt.iterations, pt.satisfied) == (jt.iterations, jt.satisfied)
    np.testing.assert_array_equal(pt.decisions, jt.decisions)
    np.testing.assert_array_equal(pt.syndromes, jt.syndromes)
    if expect_sat is not None:
        assert pt.satisfied == expect_sat


def _help_flags(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        fn(["--help"])
    return set(re.findall(r"(?<![\w-])(-T|--[a-z][a-z-]*)", out.getvalue()))


def test_replay_cli_trace_file_matches_jax_format(peg96, tmp_path):
    """The CLI's trace file equals the JAX write_trace output byte for byte
    on the same rows (the JAX trace_gdbf of the replayed input with the
    port's draws injected), its flags are the JAX CLI's plus --device, and
    its summary line is the JAX CLI's."""
    jc, code = peg96
    argv = ["--alist", "unused", "--snr", "3.0", "--seed", "4",
            "--batch-index", "1", "--frame", "3", "--batch", "16",
            "--preset", "SMNGDBF", "-T", "25", "--theta", "-0.8",
            "--noise-scale", "0.9", "--alpha", "0.9", "--window", "8"]
    from ldpcsimulation_tpu_torch.codes import code_to_alist, save_alist

    alist = tmp_path / "c.alist"
    save_alist(code_to_alist(code), str(alist))
    argv[1] = str(alist)
    out = tmp_path / "port.trace"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert preplay._main(argv + ["--out", str(out), "--device",
                                     "cpu"]) == 0
    sigma = snr_to_sigma(3.0, code.rate)
    cfg = pg.preset("SMNGDBF", num_iterations=25, theta=-0.8,
                    noise_scale=0.9, lam=0.988, alpha=0.9, window_size=8)
    y, key = preplay.replay_channel(code, 4, 1, 3, 16, sigma, device="cpu")
    pert, _ = preplay.replay_decoder_randomness(code.n, cfg, key, 1, 0,
                                                sigma, device="cpu")
    yq = saturate(y, 2.5).numpy()
    jt = jreplay.trace_gdbf(
        jc, yq, sigma, jg.preset("SMNGDBF", num_iterations=25, theta=-0.8,
                                 noise_scale=0.9, lam=0.988, alpha=0.9,
                                 window_size=8),
        key=jax.random.key(0), perturbations=jnp.asarray(pert.numpy()))
    want = tmp_path / "jax.trace"
    jreplay.write_trace(jt, str(want))
    assert out.read_bytes() == want.read_bytes()
    assert buf.getvalue() == (
        f"frame (4,1,3): iterations={jt.iterations} "
        f"satisfied={jt.satisfied} trace -> {out}\n")
    assert _help_flags(preplay._main) == _help_flags(jreplay._main) | {
        "--device"}
