"""The port's GDBF/NGDBF decoders against the JAX package, bit for bit on
the same samples and the same injected noise: the six deterministic
presets, SMNGDBF and RSMNGDBF with injected perturbations (generic and QC
graphs), StochasticNGDBF with injected uniforms, the flip rule on ties, the
QC graph operations on codes with multi-edge blocks and defect edges, and
qc_1008_504 at full width.  The keyed noise (kernels B3/B4 through their
plain twins) is held to replay: a frame decodes the same in any batch, and
a keyed decode equals the decode of its own draws injected.  A small
SMNGDBF ``simulate`` lies within Monte-Carlo bounds of the JAX one.

StochasticNGDBF's ``Φ`` is JAX's ``ndtr`` formula on PyTorch's erf/erfc,
which may differ from XLA's by an ulp; a decision moves only if ``Φ`` lies
within an ulp of a level midpoint, which these inputs do not hit, so the
comparison is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.channel import saturate as jsaturate
from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import base as jbase
from ldpcsimulation_tpu.decoders import gdbf as jg
from ldpcsimulation_tpu.decoders import qc_ops as jqc_ops
from ldpcsimulation_tpu.harness import montecarlo as jmc
from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
from ldpcsimulation_tpu_torch.codes import Code, QCCode
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import gdbf as pg
from ldpcsimulation_tpu_torch.decoders import qc_ops
from ldpcsimulation_tpu_torch import kernels
from ldpcsimulation_tpu_torch.decoders.base import (
    NoiseKey,
    syndrome_from_hard,
)
from ldpcsimulation_tpu_torch.decoders.dense_ops import DenseGraph
from ldpcsimulation_tpu_torch.harness import montecarlo as mc
from ldpcsimulation_tpu_torch.kernels import build
from ldpcsimulation_tpu_torch.kernels.channel import uniform_philox_plain
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hard", "iterations", "satisfied", "phases", "smoothing_used")
SIGMA_4DB = snr_to_sigma(4.0, 0.5)
SIGMA_2DB = snr_to_sigma(2.0, 0.5)
DETERMINISTIC = ["GDBF", "SGDBF", "MGDBF", "ATGDBF", "SATGDBF", "SMGDBF"]


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def graphs():
    """(JAX code, JAX qc or None, port code, port qc or None) by name."""
    out = {}
    jc = jbuild_code(jpeg(48, 24, 3, seed=11))
    out["generic"] = (jc, None, _port_code(jc), None)
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8)
    pqc = QCCode.from_reference(jqc)
    out["qc"] = (jqc.to_code(), jqc, pqc.to_code(), pqc)
    return out


def _channel(rng, b, n, sigma, ymax=2.5):
    y = 1.0 + sigma * rng.standard_normal((b, n))
    return np.clip(y, -ymax, ymax).astype(np.float32)


def _decode_both(graph, y, sigma, jcfg, pert=None, unif=None):
    """Decode with both packages (noise injected as [steps, N, B])."""
    jc, jqc, pc, pqc = graph
    jres = jg.decode_gdbf(
        jc, jnp.asarray(y), sigma, jcfg, key=jax.random.key(0), qc=jqc,
        perturbations=None if pert is None else jnp.asarray(pert),
        stoch_uniforms=None if unif is None else jnp.asarray(unif),
    )
    pres = pg.decode_gdbf(
        pc, torch.from_numpy(y), sigma, pg.GDBFConfig.from_reference(jcfg),
        qc=pqc,
        perturbations=None if pert is None else torch.from_numpy(pert),
        stoch_uniforms=None if unif is None else torch.from_numpy(unif),
    )
    return jres, pres


def _assert_equal(jres, pres):
    for f in FIELDS:
        want = np.asarray(getattr(jres, f))
        got = getattr(pres, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert got.dtype == want.dtype, f


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_presets_equal_jax(graphs, name):
    """Mirror of tests/test_gdbf.py's oracle cases: 6 frames, T=12."""
    rng = np.random.default_rng(DETERMINISTIC.index(name))
    y = _channel(rng, 6, 48, SIGMA_4DB, ymax=100.0)
    cfg = jg.preset(name, num_iterations=12, theta=-0.6, window_size=8)
    jres, pres = _decode_both(graphs["generic"], y, SIGMA_4DB, cfg)
    _assert_equal(jres, pres)
    assert pres.steps <= 12


@pytest.mark.parametrize("graph", ["generic", "qc"])
@pytest.mark.parametrize("name,sigma,kw", [
    ("SMNGDBF", SIGMA_4DB, dict(window_size=6)),
    ("RSMNGDBF", SIGMA_2DB, dict(window_size=4, max_phases=3)),
])
def test_noisy_presets_with_injected_perturbations_equal_jax(
        graphs, graph, name, sigma, kw):
    rng = np.random.default_rng(3)
    n = graphs[graph][0].n
    y = _channel(rng, 16, n, sigma)
    cfg = jg.preset(name, num_iterations=10, theta=-0.9, noise_scale=0.9,
                    lam=0.98, alpha=1.5, **kw)
    steps = cfg.max_phases * cfg.num_iterations
    pert = rng.normal(0.0, sigma * 0.9, (steps, n, 16)).astype(np.float32)
    jres, pres = _decode_both(graphs[graph], y, sigma, cfg, pert=pert)
    _assert_equal(jres, pres)
    if name == "RSMNGDBF":  # redecode phases engaged
        assert pres.phases.max() > 1


@pytest.mark.parametrize("graph", ["generic", "qc"])
def test_stochastic_with_injected_uniforms_equals_jax(graphs, graph):
    rng = np.random.default_rng(4)
    n = graphs[graph][0].n
    y = _channel(rng, 16, n, SIGMA_2DB)
    cfg = jg.preset("StochasticNGDBF", num_iterations=12, theta=-0.6,
                    noise_scale=0.9, alpha=1.5)
    unif = rng.uniform(size=(12, n, 16)).astype(np.float32)
    jres, pres = _decode_both(graphs[graph], y, SIGMA_2DB, cfg, unif=unif)
    _assert_equal(jres, pres)


def test_flagship_full_width_equals_jax():
    """qc_1008_504, SMNGDBF at 4.5 dB, 8 frames, T=40, injected
    perturbations."""
    jqc = jlib.load_named_qc("qc_1008_504")
    pqc = QCCode.from_reference(jqc)
    sigma = snr_to_sigma(4.5, 0.5)
    rng = np.random.default_rng(5)
    y = _channel(rng, 8, jqc.n, sigma)
    cfg = jg.preset("SMNGDBF", num_iterations=40, theta=-0.9,
                    noise_scale=0.975, lam=0.988, alpha=0.75)
    pert = rng.normal(0.0, sigma * 0.975, (40, jqc.n, 8)).astype(np.float32)
    jres, pres = _decode_both(
        (jqc.to_code(), jqc, pqc.to_code(), pqc), y, sigma, cfg, pert=pert
    )
    _assert_equal(jres, pres)
    assert pres.satisfied.any()


def test_flip_decisions_on_ties_equal_jax():
    """Ties in E (argmin takes the first minimum, the prefix-min is
    exclusive), frames in both modes, and the stochastic level scan."""
    rng = np.random.default_rng(6)
    n, b = 24, 40
    e = (np.round(rng.normal(size=(n, b)) * 2.0) / 2.0).astype(np.float32)
    e[:, 0] = 0.5  # all tied
    thetas = np.full((n, b), -0.5, np.float32)
    thetas[::3] = 0.5
    mu = (np.arange(b) % 2).astype(np.int32)
    ns = np.float32(0.7)
    rnum = rng.uniform(size=(n, b)).astype(np.float32)
    ones = np.ones(b, np.int32)  # a parallel-only config keeps mu = 1
    for name, mu in (("SGDBF", mu), ("MGDBF", mu), ("ATGDBF", ones),
                     ("StochasticNGDBF", mu)):
        jcfg = jg.preset(name, num_iterations=5, theta=-0.5)
        pcfg = pg.GDBFConfig.from_reference(jcfg)
        want = jg.flip_decisions(jcfg, jnp.asarray(e), jnp.asarray(thetas),
                                 jnp.asarray(mu), jnp.asarray(ns),
                                 jnp.asarray(rnum))
        got = pg.flip_decisions(pcfg, torch.from_numpy(e),
                                torch.from_numpy(thetas),
                                torch.from_numpy(mu), torch.tensor(ns),
                                torch.from_numpy(rnum))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _edge_codes():
    """QC codes with multi-edge blocks and defect edges, built by the JAX
    package."""
    z = 5
    edges = [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2),
             (1, 0, 2), (1, 1, 2), (1, 2, 4)]
    yield jqc_mod.build_qc_code_edges(edges, z, 2, 3,
                                      minus_edges=((1, 2, 4, 1),))
    edges = [(0, 0, 0), (0, 0, 5), (0, 1, 3), (1, 1, 1), (1, 1, 6),
             (1, 2, 2), (2, 0, 4), (2, 2, 0), (2, 3, 1), (0, 3, 2)]
    yield jqc_mod.build_qc_code_edges(
        edges, 7, 3, 4, minus_edges=((2, 3, 1, 0), (0, 1, 3, 6)))


@pytest.mark.parametrize("which", [0, 1])
def test_qc_ops_with_extra_and_minus_edges_equal_jax(which):
    jqc = list(_edge_codes())[which]
    assert jqc.extra_edges and jqc.minus_edges
    pqc = QCCode.from_reference(jqc)
    rng = np.random.default_rng(which)
    d = np.where(rng.random((jqc.n, 33)) < 0.5, 1, -1).astype(np.int32)
    syn = qc_ops.qc_syndrome_bipolar(pqc, torch.from_numpy(d))
    want = np.asarray(jqc_ops.qc_syndrome_bipolar(jqc, jnp.asarray(d)))
    np.testing.assert_array_equal(syn.numpy(), want)
    # the row gathers equal the generic syndrome on the expanded H
    np.testing.assert_array_equal(
        syndrome_from_hard(pqc.to_code(), torch.from_numpy(d)).numpy(), want
    )
    s = np.where(rng.random((jqc.m, 33)) < 0.5, 1.0, -1.0).astype(np.float32)
    got = qc_ops.qc_syndrome_sum_per_vn(pqc, torch.from_numpy(s))
    want = np.asarray(jqc_ops.qc_syndrome_sum_per_vn(jqc, jnp.asarray(s)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_syndrome_from_hard_equals_jax(graphs):
    jc, _, pc, _ = graphs["generic"]
    d = np.where(np.random.default_rng(9).random((jc.n, 17)) < 0.8, 1,
                 -1).astype(np.int32)
    np.testing.assert_array_equal(
        syndrome_from_hard(pc, torch.from_numpy(d)).numpy(),
        np.asarray(jbase.syndrome_from_hard(jc, jnp.asarray(d))),
    )


def test_config_from_reference():
    for name in jg.PRESETS:
        jcfg = jg.preset(name, num_iterations=30, theta=-0.8,
                         noise_scale=0.9, lam=0.97, alpha=0.75)
        pcfg = pg.GDBFConfig.from_reference(jcfg)
        assert pcfg == pg.preset(name, num_iterations=30, theta=-0.8,
                                 noise_scale=0.9, lam=0.97, alpha=0.75)
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert set(pg.PRESETS) == set(jg.PRESETS) and pg.PR_LEVELS == jg.PR_LEVELS


@pytest.mark.parametrize("name,kw", [
    ("SMNGDBF", {}),
    ("MNGDBF", dict(uniform_noise=True)),
    ("StochasticNGDBF", {}),
])
def test_keyed_noise_replays_across_batches(graphs, name, kw):
    """Frames decoded in one batch equal the same frames decoded in two,
    and a keyed decode equals the decode of its own draws injected."""
    _, _, pc, pqc = graphs["qc"]
    rng = np.random.default_rng(10)
    y = torch.from_numpy(_channel(rng, 12, pc.n, SIGMA_2DB))
    cfg = pg.preset(name, num_iterations=15, theta=-0.9, noise_scale=0.9,
                    lam=0.98, alpha=1.5, **kw)
    one = pg.decode_gdbf(pc, y, SIGMA_2DB, cfg, key=NoiseKey(7, 100),
                         qc=pqc)
    a = pg.decode_gdbf(pc, y[:5], SIGMA_2DB, cfg, key=NoiseKey(7, 100),
                       qc=pqc)
    b = pg.decode_gdbf(pc, y[5:], SIGMA_2DB, cfg, key=NoiseKey(7, 105))
    for f in FIELDS:
        assert torch.equal(getattr(one, f),
                           torch.cat([getattr(a, f), getattr(b, f)])), f
    pert, unif = pg.keyed_draws(cfg, SIGMA_2DB, NoiseKey(7, 100), pc.n, 12,
                                15, "cpu")
    inj = pg.decode_gdbf(pc, y, SIGMA_2DB, cfg, perturbations=pert,
                         stoch_uniforms=unif, qc=pqc)
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(inj, f)), f
    other = pg.decode_gdbf(pc, y, SIGMA_2DB, cfg, key=NoiseKey(8, 100))
    assert not torch.equal(one.hard, other.hard)


def test_uniform_noise_transform_equals_jax():
    """The --uniform-noise perturbation is the JAX transform of B3's
    uniforms, bit for bit."""
    sigma, cfg = SIGMA_2DB, pg.preset("MNGDBF", 10, -0.9, noise_scale=0.9,
                                      uniform_noise=True)
    ns = np.float32(sigma * 0.9)
    got = pg._keyed_perturbation(cfg, NoiseKey(3, 50), 40, 24, 6, float(ns),
                                 "cpu")
    u = uniform_philox_plain(3, 50, 24, 40, 1 + 2 * 6)
    want = (jnp.sqrt(3.0).astype(jnp.float32) * jnp.asarray(ns) * 2.0
            * (jnp.asarray(u.numpy()) - 0.5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_guards(graphs):
    _, _, pc, pqc = graphs["qc"]
    y = torch.ones((2, pc.n))
    cfg = pg.preset("SMNGDBF", 5, -0.9)
    res, d_steps = pg.decode_gdbf(pc, y, 0.5, cfg, key=NoiseKey(0, 0),
                                  trace=True)  # the replay tool's trace mode
    assert d_steps.shape == (5, pc.n, 2) and res.steps == 5
    with pytest.raises(ValueError, match="noise key"):
        pg.decode_gdbf(pc, y, 0.5, cfg)
    with pytest.raises(ValueError, match="noise key"):
        pg.decode_gdbf(pc, y, 0.5, cfg, trace=True)
    with pytest.raises(ValueError, match="does not match"):
        pg.decode_gdbf(graphs["generic"][2], torch.ones((2, 48)), 0.5,
                       pg.preset("GDBF", 5, -0.9), qc=pqc)
    res = pg.decode_gdbf(pc, y, 0.5, pg.preset("GDBF", 5, -0.9))
    assert res.steps <= pg.DONE_CHECK_EVERY and res.satisfied.all()
    assert (res.iterations == 0).all()


def _mc_moments(stats, n):
    """(BER, its standard error, FER, its s.e., mean iterations, its s.e.)
    from a run's histograms."""
    f = stats.total_words
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = np.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    ith = stats.iteration_hist
    it = np.arange(len(ith))
    mean_i = (it * ith).sum() / f
    it_se = np.sqrt(((it**2 * ith).sum() / f - mean_i**2) / (f - 1))
    fer_se = np.sqrt(stats.fer * (1 - stats.fer) / f)
    return stats.ber, ber_se, stats.fer, fer_se, mean_i, it_se


def test_simulate_smngdbf_within_mc_bounds():
    """A (192, 96) QC code, SMNGDBF at 3 dB, T=30, 1024 frames per
    package: BER, FER and average iterations within 4 joint standard
    errors, and the smoothing and phase extras surfaced."""
    jqc = jqc_mod.qc_peg(12, 6, 3, z=16)
    pqc = QCCode.from_reference(jqc)
    kw = dict(num_iterations=30, theta=-0.9, noise_scale=0.975, lam=0.988,
              alpha=0.75, window_size=16)
    jcfg = jg.preset("SMNGDBF", **kw)
    pcfg = pg.preset("SMNGDBF", **kw)
    sigma = snr_to_sigma(3.0, 0.5)
    jcode, pcode = jqc.to_code(), pqc.to_code()
    jst = jmc.simulate(
        jcode,
        lambda yq, key: jg.decode_gdbf(jcode, yq, sigma, jcfg, key=key,
                                       qc=jqc),
        3.0, stop=jmc.StopRule.fixed_frames(1024), batch_size=512, seed=1,
        preprocess=lambda y: jsaturate(y, 2.5),
    )
    pst = mc.simulate(
        pcode,
        lambda yq, key: pg.decode_gdbf(pcode, yq, sigma, pcfg, key=key,
                                       qc=pqc),
        3.0, stop=mc.StopRule.fixed_frames(1024), batch_size=512, seed=1,
        preprocess=lambda y: saturate(y, 2.5), device="cpu",
    )
    jm, pm = _mc_moments(jst, jqc.n), _mc_moments(pst, jqc.n)
    for i in (0, 2, 4):
        bound = 4 * np.hypot(jm[i + 1], pm[i + 1])
        assert abs(jm[i] - pm[i]) < bound, (i, jm, pm)
    assert 0.0 < pst.fer < 1.0
    assert pst.extra["smoothing_used"] > 0
    np.testing.assert_array_equal(pst.extra["phase_hist"], [1024])


# The two step paths of decode_gdbf: the chunk path (the parallel rule on
# a QC or slot-array graph with keyed Gaussian noise or none; on the CPU its
# chunks are its plain twin, the per-step body run over the same steps)
# against the per-step loop, forced by replacing the path's predicate.
PARALLEL = ["GDBF", "SMGDBF", "ATGDBF", "SATGDBF", "MNGDBF", "SMNGDBF",
            "RSMNGDBF"]


def _paths():
    return {k[1]: v for k, v in build.PATHS.items() if k[0] == "gdbf_step"}


def _both_paths(monkeypatch, pc, y, sigma, cfg, key, **kw):
    """(chunked result, per-step loop result), each with the step paths it
    counted."""
    build.PATHS.clear()
    chunked = pg.decode_gdbf(pc, y, sigma, cfg, key=key, **kw)
    chunk_paths = _paths()
    with monkeypatch.context() as m:
        m.setattr(pg, "_takes_chunks", lambda *a: False)
        build.PATHS.clear()
        loop = pg.decode_gdbf(pc, y, sigma, cfg, key=key, **kw)
        loop_paths = _paths()
    return (chunked, chunk_paths), (loop, loop_paths)


@pytest.mark.parametrize("graph", ["qc", "generic"])
@pytest.mark.parametrize("T", [10, 7])
@pytest.mark.parametrize("name", PARALLEL)
def test_chunked_steps_equal_per_step_loop(graphs, monkeypatch, name, T,
                                           graph):
    """Every parallel preset on the QC and the slot-array graph, T a
    multiple of no chunk (10) or smaller than two (7): redecode phase
    starts inside chunks, frames that check out mid-chunk; decisions,
    counters and steps equal, each path counted."""
    _, _, pc, pqc = graphs[graph]
    rng = np.random.default_rng(PARALLEL.index(name) + 20)
    sigma = snr_to_sigma(2.5, 0.5)
    y = torch.from_numpy(_channel(rng, 24, pc.n, sigma))
    extra = dict(max_phases=3) if name == "RSMNGDBF" else {}
    cfg = pg.preset(name, T, -0.9, noise_scale=0.9, lam=0.98, alpha=1.5,
                    window_size=4, **extra)
    (c, cp), (lo, lp) = _both_paths(monkeypatch, pc, y, sigma, cfg,
                                    NoiseKey(5, 1000), qc=pqc)
    for f in FIELDS:
        assert torch.equal(getattr(c, f), getattr(lo, f)), f
    assert c.steps == lo.steps
    assert cp == {"chunk": c.steps} and lp == {"loop": lo.steps}
    # frames checked out at steps inside a chunk
    its = c.iterations[c.satisfied]
    assert (its % pg.DONE_CHECK_EVERY != 0).any()
    if name == "RSMNGDBF":
        assert c.phases.max() > 1


@pytest.mark.parametrize("T,phases,want", [
    (7, 3, [(0, 4), (4, 3), (7, 1), (8, 4), (12, 2), (14, 2), (16, 4),
            (20, 1)]),
    (10, 1, [(0, 4), (4, 4), (8, 2)]),
    (300, 1, [(s, 4) for s in range(0, 300, 4)]),
])
def test_chunks_end_at_exit_checks_and_phase_starts(T, phases, want):
    """A chunk runs up to the next multiple of DONE_CHECK_EVERY, the next
    phase start or the budget, whichever comes first."""
    got, step = [], 0
    while step < T * phases:
        stop = pg._chunk_end(step, T, T * phases)
        got.append((step, stop - step))
        step = stop
    assert got == want


@pytest.mark.parametrize("in_window", [False, True])
def test_lanes_twin_equals_inline_ops(in_window):
    """The bookkeeping's plain twin against the decoder's former inline
    ops, on random done and satisfied flags."""
    gen = torch.Generator().manual_seed(int(in_window))
    b, step, phase = 257, 13, 2
    done = torch.rand(b, generator=gen) < 0.4
    sat = torch.rand(b, generator=gen) < 0.5
    iters = torch.randint(0, 50, (b,), generator=gen, dtype=torch.int32)
    phases = torch.randint(1, 4, (b,), generator=gen, dtype=torch.int32)
    used = torch.randint(0, 3, (b,), generator=gen, dtype=torch.int32)
    at_exit = torch.rand(b, generator=gen) < 0.3

    act = ~done
    newly = act & sat
    want_iters = torch.where(newly, step, iters)
    want_phases = torch.where(newly, phase + 1, phases)
    want_used = used + newly.to(torch.int32) if in_window else used
    want_done = done | sat
    want_exit = at_exit | newly

    got = [t.clone() for t in (sat, done, act, iters, phases, used,
                               at_exit)]
    kernels.gdbf_lanes_plain(*got, step, phase, in_window)
    g_sat, g_done, g_act, g_iters, g_phases, g_used, g_exit = got
    assert torch.equal(g_iters, want_iters)
    assert torch.equal(g_phases, want_phases)
    assert torch.equal(g_used, want_used)
    assert torch.equal(g_done, want_done)
    assert torch.equal(g_exit, want_exit)
    assert torch.equal(g_act, ~want_done)
    assert g_sat.all()  # ready for the next check
    assert [t.dtype for t in got] == [t.dtype for t in (
        sat, done, act, iters, phases, used, at_exit)]


def test_step_path_counters(graphs):
    """Which decodes take the chunks: the keyed parallel rule and the
    noiseless one; injection, trace, uniform noise, noise shaping, the
    stochastic rule and the dense route keep the per-step loop.  On the
    CPU no kernel is launched."""
    _, _, pc, pqc = graphs["qc"]
    y = torch.from_numpy(_channel(np.random.default_rng(2), 8, pc.n,
                                  SIGMA_2DB))
    key = NoiseKey(4, 0)
    smn = pg.preset("SMNGDBF", 6, -0.9)
    pert, _ = pg.keyed_draws(smn, SIGMA_2DB, key, pc.n, 8, 6, "cpu")
    cases = [
        ("chunk", smn, {}),
        ("chunk", pg.preset("ATGDBF", 6, -0.9), {}),
        ("loop", smn, dict(perturbations=pert)),
        ("loop", smn, dict(trace=True)),
        ("loop", pg.preset("MNGDBF", 6, -0.9, uniform_noise=True), {}),
        ("loop", pg.preset("MNGDBF", 6, -0.9, noise_shaping=True), {}),
        ("loop", pg.preset("StochasticNGDBF", 6, -0.9), {}),
        ("loop", pg.preset("MGDBF", 6, -0.9), {}),
    ]
    for path, cfg, kw in cases:
        build.PATHS.clear()
        build.LAUNCHES.clear()
        res = pg.decode_gdbf(pc, y, SIGMA_2DB, cfg, key=key, qc=pqc, **kw)
        if kw.get("trace"):
            res = res[0]
        assert _paths() == {path: res.steps} and res.steps > 0, (path, cfg)
        assert not build.LAUNCHES
    build.PATHS.clear()
    res = pg.decode_gdbf(pc, y, SIGMA_2DB, smn, key=key,
                         dense=DenseGraph.from_code(pc, "cpu"))
    assert _paths() == {"loop": res.steps}


def test_chunk_plan_guards(graphs):
    _, _, pc, pqc = graphs["qc"]
    g = qc_ops.qc_graph(pqc, "cpu")
    n, b = pc.n, 4
    d = torch.ones((n, b), dtype=torch.int8)
    y = torch.ones((n, b))
    planes = dict(thetas=torch.zeros((n, b)),
                  dsum=torch.zeros((n, b), dtype=torch.int32),
                  done=torch.zeros(b, dtype=torch.bool),
                  act=torch.ones(b, dtype=torch.bool),
                  iters=torch.zeros(b, dtype=torch.int32),
                  phases=torch.zeros(b, dtype=torch.int32),
                  smooth_used=torch.zeros(b, dtype=torch.int32),
                  sat_at_exit=torch.zeros(b, dtype=torch.bool))

    def plan(**over):
        kw = {**planes, **over}
        return kernels.gdbf_chunk_plan(
            g.check_cols, g.vn_checks, d, y, kw["thetas"], kw["dsum"],
            kw["done"], kw["act"], kw["iters"], kw["phases"],
            kw["smooth_used"], kw["sat_at_exit"], 5, 3, 10, 1.0,
            noise=kw.get("noise"))

    p = plan(noise=(0, 0, 0.5))
    assert p.syn.shape == (pc.m, b) and p.syn.dtype == torch.int8
    assert p.sat.all() and p.pert.shape == (n, b)
    assert plan().pert is None
    with pytest.raises(ValueError, match="iters"):
        plan(iters=torch.zeros(b, dtype=torch.int64))
    with pytest.raises(ValueError, match="done"):
        plan(done=torch.zeros(b + 1, dtype=torch.bool))
    with pytest.raises(ValueError, match="act"):
        plan(act=torch.ones(b, dtype=torch.int32))
    with pytest.raises(ValueError, match="thetas"):
        plan(thetas=torch.zeros((n, b), dtype=torch.float64))
    with pytest.raises(ValueError, match="outside"):
        plan(noise=(1 << 64, 0, 0.5))
