"""The port's fixed-point NGDBFhw against the JAX package, bit for bit on
the same samples and the same injected noise ring: ``hard``, ``iterations``,
``satisfied``, ``least_errors`` and ``qpointer`` on a small PEG code
(generic graph operations), a small QC code and qc_1008_504 (QC row
gathers), with one and three phases, with and without ``qpointer0`` and
``true_bits``; the quantizer and the config integers over a w/Ymax grid;
a ring holding infinite draws.  The keyed ring (kernel B4 through its plain
twin) replays a frame in any batch, and the harness carry threads the ring
pointer across ``simulate`` batches as chaining ``qpointer0`` by hand does.
The trace tool writes the JAX tool's records byte for byte.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import ngdbf_hw as jhw
from ldpcsimulation_tpu.tools import hw_trace as jtrace
from ldpcsimulation_tpu_torch.channel import awgn_all_zero, snr_to_sigma
from ldpcsimulation_tpu_torch.codes import Code, QCCode
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import ngdbf_hw as phw
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.harness import montecarlo as mc
from ldpcsimulation_tpu_torch.tools import hw_trace as ptrace
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hard", "iterations", "satisfied", "least_errors", "qpointer")
SIGMA = snr_to_sigma(5.0, 0.75)
SMALL = dict(num_iterations=25, w=0.25, ymax=1.5, noise_scale=0.9,
             theta0=-0.5, nq=5, ring_len=200)


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def graphs():
    """(JAX code, JAX qc or None, port code, port qc or None) by name."""
    out = {}
    jc = jbuild_code(jpeg(64, 16, 2, seed=31))
    out["generic"] = (jc, None, _port_code(jc), None)
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8, seed=3)
    pqc = QCCode.from_reference(jqc)
    out["qc"] = (jqc.to_code(), jqc, pqc.to_code(), pqc)
    return out


def _channel(rng, b, n):
    return (1.0 + SIGMA * rng.standard_normal((b, n))).astype(np.float32)


def _decode_both(graph, y, jcfg, ring, qpointer0=None, true_bits=None):
    jc, jqc, pc, pqc = graph
    jres = jhw.decode_ngdbf_hw(
        jc, jnp.asarray(y), SIGMA, jcfg, key=jax.random.key(0), qc=jqc,
        ring_noise=jnp.asarray(ring),
        qpointer0=None if qpointer0 is None else jnp.asarray(qpointer0),
        true_bits=None if true_bits is None else jnp.asarray(true_bits),
    )
    pres = phw.decode_ngdbf_hw(
        pc, torch.from_numpy(y), SIGMA,
        phw.NGDBFHwConfig.from_reference(jcfg), qc=pqc,
        ring_noise=torch.from_numpy(ring),
        qpointer0=None if qpointer0 is None else torch.from_numpy(qpointer0),
        true_bits=None if true_bits is None else torch.from_numpy(true_bits),
    )
    return jres, pres


def _assert_equal(jres, pres):
    for f in FIELDS:
        want = np.asarray(getattr(jres, f))
        got = getattr(pres, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert got.dtype == want.dtype, f


def test_config_integers_equal_jax_on_a_grid():
    """lmax, NL, theta and Smult (C round, half away from zero) over a grid
    of w, Ymax and NQ, including the 802.3an defaults."""
    assert phw.NGDBFHwConfig() == phw.NGDBFHwConfig.from_reference(
        jhw.NGDBFHwConfig())
    seen = set()
    for w in (0.125, 0.185, 0.2, 0.25, 0.3125, 0.4):
        for ymax in (1.0, 1.5, 1.625, 2.0, 2.5, 3.0):
            for nq in (4, 5, 6, 8):
                j = jhw.NGDBFHwConfig(w=w, ymax=ymax, nq=nq)
                p = phw.NGDBFHwConfig.from_reference(j)
                got = (p.lmax, p.nl, p.theta_int, p.smult)
                assert got == (j.lmax, j.nl, j.theta_int, j.smult)
                assert all(type(v) is int for v in got[1:])
                seen.add(got[2:])
    assert len(seen) > 20
    d = phw.NGDBFHwConfig()
    assert (d.nl, d.theta_int, d.smult) == (31, 15, 7)
    # NL/lmax = 2.5 exactly: C round gives 3 where half-to-even gives 2
    assert phw.NGDBFHwConfig(w=0.25, ymax=3.0, nq=4).smult == 3


@pytest.mark.parametrize("nl,lmax", [(31, 4.0), (31, 1.625 / 0.37),
                                     (15, 3.0), (255, 2.5)])
def test_hw_quantize_int_equals_jax(nl, lmax):
    rng = np.random.default_rng(nl)
    x = rng.uniform(-lmax, lmax, 4000).astype(np.float32)
    # the quantizer's steps, zero (sgn(0) = -1) and the clip edges
    step = 2.0 * lmax / nl
    edges = np.arange(-nl // 2 - 1, nl // 2 + 2) * step
    x = np.concatenate([x, edges.astype(np.float32),
                        np.float32([0.0, -0.0, lmax, -lmax])])
    got = phw.hw_quantize_int(torch.from_numpy(x), nl, lmax).numpy()
    want = np.asarray(jhw.hw_quantize_int(jnp.asarray(x), nl, lmax))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (np.abs(got) % 2 == 1).all()
    assert got[-4] == -1 and got[-3] == -1


@pytest.mark.parametrize("graph", ["generic", "qc"])
@pytest.mark.parametrize("max_phases", [1, 3])
@pytest.mark.parametrize("hooks", [False, True])
def test_decode_equals_jax_on_injected_rings(graphs, graph, max_phases,
                                             hooks):
    """hooks: per-lane ``qpointer0`` and ``true_bits`` (bits other than
    the sent word's, so the least-errors selection across phases is
    exercised)."""
    rng = np.random.default_rng(max_phases + 2 * hooks)
    jc = graphs[graph][0]
    b, n = 12, jc.n
    jcfg = jhw.NGDBFHwConfig(max_phases=max_phases, **SMALL)
    bits = qp = None
    if hooks:
        bits = (rng.random((b, n)) < 0.05).astype(np.int32)
        qp = rng.integers(0, SMALL["ring_len"] - n, b).astype(np.int32)
    y = _channel(rng, b, n)
    ring = rng.normal(0.0, SIGMA * 0.9, (SMALL["ring_len"], b)).astype(
        np.float32)
    jres, pres = _decode_both(graphs[graph], y, jcfg, ring, qp, bits)
    _assert_equal(jres, pres)
    assert 0 < pres.satisfied.sum() < b  # some frames fail, some decode


def test_full_width_qc_code_equals_jax():
    """qc_1008_504 with QC row gathers, 8 frames, T=30, two phases, the
    802.3an constants and ring length."""
    jqc = jlib.load_named_qc("qc_1008_504")
    pqc = QCCode.from_reference(jqc)
    sigma = snr_to_sigma(2.5, 0.5)
    rng = np.random.default_rng(5)
    y = (1.0 + sigma * rng.standard_normal((8, jqc.n))).astype(np.float32)
    jcfg = jhw.NGDBFHwConfig(num_iterations=30, max_phases=2)
    ring = rng.normal(0.0, sigma * 0.95, (jcfg.ring_len, 8)).astype(
        np.float32)
    qp = rng.integers(0, jcfg.ring_len - jqc.n, 8).astype(np.int32)
    jres, pres = _decode_both((jqc.to_code(), jqc, pqc.to_code(), pqc), y,
                              jcfg, ring, qp)
    _assert_equal(jres, pres)


@pytest.mark.parametrize("nq", [8, 15])
def test_wide_quantizers_equal_jax(graphs, nq):
    """NQ 8 keeps the int16 metric; NQ 15 (|E| past 2^15) takes int32."""
    rng = np.random.default_rng(nq)
    jc = graphs["qc"][0]
    jcfg = jhw.NGDBFHwConfig(**dict(SMALL, nq=nq, max_phases=2))
    y = _channel(rng, 10, jc.n)
    ring = rng.normal(0.0, SIGMA * 0.9, (SMALL["ring_len"], 10)).astype(
        np.float32)
    jres, pres = _decode_both(graphs["qc"], y, jcfg, ring)
    _assert_equal(jres, pres)


def test_ring_with_infinite_draws_equals_jax(graphs):
    """B4 gives +inf once in 2^24 draws: the ring's clip maps it to lmax
    (and -inf to -lmax), in both packages."""
    rng = np.random.default_rng(8)
    jc = graphs["generic"][0]
    b = 6
    jcfg = jhw.NGDBFHwConfig(max_phases=2, **SMALL)
    y = _channel(rng, b, jc.n)
    ring = rng.normal(0.0, SIGMA * 0.9, (SMALL["ring_len"], b)).astype(
        np.float32)
    ring[rng.integers(0, SMALL["ring_len"], 40), rng.integers(0, b, 40)] = (
        np.inf)
    ring[3, 2] = -np.inf
    jres, pres = _decode_both(graphs["generic"], y, jcfg, ring)
    _assert_equal(jres, pres)
    pcfg = phw.NGDBFHwConfig.from_reference(jcfg)
    q = phw._ring_integers(pcfg, torch.from_numpy(ring))
    top = 2 * (pcfg.nl // 2) + 1
    assert (q[torch.from_numpy(np.isposinf(ring))] == top).all()
    assert int(q[3, 2]) == -top


def test_keyed_ring_replays_across_batches(graphs):
    """A frame decodes the same in any batch, a keyed decode equals the
    decode of its own ring injected, and another seed decodes otherwise."""
    _, _, pc, pqc = graphs["qc"]
    cfg = phw.NGDBFHwConfig(max_phases=2, **SMALL)
    y = torch.from_numpy(_channel(np.random.default_rng(10), 12, pc.n))
    one = phw.decode_ngdbf_hw(pc, y, SIGMA, cfg, key=NoiseKey(7, 100),
                              qc=pqc)
    a = phw.decode_ngdbf_hw(pc, y[:5], SIGMA, cfg, key=NoiseKey(7, 100))
    b = phw.decode_ngdbf_hw(pc, y[5:], SIGMA, cfg, key=NoiseKey(7, 105),
                            qc=pqc)
    for f in FIELDS:
        assert torch.equal(getattr(one, f),
                           torch.cat([getattr(a, f), getattr(b, f)])), f
    ring = phw.keyed_ring(cfg, SIGMA, NoiseKey(7, 100), 12, "cpu")
    assert ring.shape == (cfg.ring_len, 12)
    inj = phw.decode_ngdbf_hw(pc, y, SIGMA, cfg, ring_noise=ring, qc=pqc)
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(inj, f)), f
    other = phw.decode_ngdbf_hw(pc, y, SIGMA, cfg, key=NoiseKey(8, 100))
    assert not torch.equal(one.qpointer, other.qpointer)


def test_carry_threads_the_ring_pointer_across_batches(graphs):
    """``simulate(decode_carry0=)``: each batch starts from the pointers the
    last one returned, as chaining ``qpointer0`` by hand does; a short final
    batch takes the carry's head; ``least_errors_sum`` is the total of the
    decodes' least errors."""
    _, _, pc, pqc = graphs["qc"]
    cfg = phw.NGDBFHwConfig(**SMALL)
    seen = []

    def dec(y, key, carry):
        res = phw.decode_ngdbf_hw(pc, y, SIGMA, cfg, key=key, qc=pqc,
                                  qpointer0=carry)
        seen.append((key.frame0, carry.clone(), res))
        return res, res.qpointer

    stats = mc.simulate(
        pc, dec, 5.0, rate=0.75, stop=mc.StopRule.fixed_frames(40),
        batch_size=16, seed=4, device="cpu",
        decode_carry0=torch.zeros(16, dtype=torch.int32),
    )
    assert [s[0] for s in seen] == [0, 16, 32] and len(seen[2][1]) == 8
    qp = torch.zeros(16, dtype=torch.int32)
    for frame0, carry, res in seen:
        b = len(carry)
        assert torch.equal(carry, qp[:b])
        y = awgn_all_zero(4, frame0, b, pc.n, SIGMA, "cpu")
        ref = phw.decode_ngdbf_hw(pc, y, SIGMA, cfg, key=NoiseKey(4, frame0),
                                  qpointer0=qp[:b])
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(ref, f)), f
        qp = torch.cat([ref.qpointer, qp[b:]])
    assert (qp != 0).any()
    assert stats.extra["least_errors_sum"] == sum(
        int(r.least_errors.sum()) for _, _, r in seen)
    assert stats.extra["least_errors_sum"] == stats.errors  # one phase


def test_decode_guards(graphs):
    _, _, pc, pqc = graphs["qc"]
    y = torch.ones((2, pc.n))
    cfg = phw.NGDBFHwConfig(**SMALL)
    with pytest.raises(ValueError, match="noise key"):
        phw.decode_ngdbf_hw(pc, y, 0.5, cfg)
    with pytest.raises(ValueError, match="does not match"):
        phw.decode_ngdbf_hw(graphs["generic"][2], torch.ones((2, 64)), 0.5,
                            cfg, key=NoiseKey(0, 0), qc=pqc)
    with pytest.raises(ValueError, match="ring_len"):
        phw.decode_ngdbf_hw(pc, y, 0.5, phw.NGDBFHwConfig(ring_len=pc.n),
                            key=NoiseKey(0, 0))
    res = phw.decode_ngdbf_hw(pc, y, 0.5, cfg, key=NoiseKey(0, 0))
    assert res.satisfied.all() and (res.iterations == 0).all()
    assert res.steps == phw.DONE_CHECK_EVERY and (res.qpointer == 0).all()


@pytest.mark.parametrize("qpointer0,sigma", [(0, 0.45), (100, 0.55)])
def test_hw_trace_records_equal_jax_tool(graphs, qpointer0, sigma):
    """Byte-identical records and returns from the two tools, and the
    decisions of the port's decoder on the same frame and ring."""
    jc, _, pc, _ = graphs["generic"]
    rng = np.random.default_rng(qpointer0)
    jcfg = jhw.NGDBFHwConfig(num_iterations=30, w=0.25, ymax=1.5,
                             noise_scale=0.9, theta0=-0.5, nq=5,
                             ring_len=200)
    pcfg = phw.NGDBFHwConfig.from_reference(jcfg)
    y = 1.0 + sigma * rng.standard_normal(jc.n)
    ring = rng.normal(0.0, sigma * 0.9, jcfg.ring_len)
    jbuf, pbuf = io.StringIO(), io.StringIO()
    jout = jtrace.trace_ngdbf_hw(jc, y, sigma, jcfg, ring, jbuf,
                                 qpointer0=qpointer0)
    pout = ptrace.trace_ngdbf_hw(pc, y, sigma, pcfg, ring, pbuf,
                                 qpointer0=qpointer0)
    assert pbuf.getvalue() == jbuf.getvalue()
    assert "IT 0" in pbuf.getvalue() and "\tflip: 1" in pbuf.getvalue()
    np.testing.assert_array_equal(pout[0], jout[0])
    assert pout[1:] == jout[1:]
    res = phw.decode_ngdbf_hw(
        pc, torch.from_numpy(y.astype(np.float32))[None, :], sigma, pcfg,
        ring_noise=torch.from_numpy(ring.astype(np.float32))[:, None],
        qpointer0=torch.tensor([qpointer0], dtype=torch.int32),
    )
    np.testing.assert_array_equal(1 - 2 * pout[0], res.hard[0].numpy())
    assert (int(res.iterations[0]), bool(res.satisfied[0]),
            int(res.qpointer[0])) == pout[1:]
    # a replay of captured integers writes the same records too
    yint = 2 * rng.integers(-16, 16, jc.n) + 1
    qint = 2 * rng.integers(-16, 16, jcfg.ring_len) + 1
    jbuf, pbuf = io.StringIO(), io.StringIO()
    kw = dict(yint_override=yint, qint_override=qint, max_iterations=5)
    jout = jtrace.trace_ngdbf_hw(jc, None, sigma, jcfg, None, jbuf, **kw)
    pout = ptrace.trace_ngdbf_hw(pc, None, sigma, pcfg, None, pbuf, **kw)
    assert pbuf.getvalue() == jbuf.getvalue() and pout[1:] == jout[1:]
