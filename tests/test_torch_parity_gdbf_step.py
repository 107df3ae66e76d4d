"""Kernels B6 (the parity check) and B7 (the parallel GDBF step) on the CPU
(the CUDA kernels themselves run only on the card), bit for bit against the
JAX package: B6's twin against ``qc_check_satisfied``, ``check_satisfied``,
``syndrome_from_hard`` and ``qc_syndrome_bipolar`` with int8 and int32
decisions, on a generic code, a QC code and the QC codes with multi-edge
blocks and defect edges; B7's twin against the JAX step's VN side composed
op by op, for the flag combinations of the seven parallel presets; and
``decode_gdbf`` on the B6 + B7 route against the JAX decoder (GDBF, ATGDBF,
MNGDBF with injected perturbations, on both graphs), with the route's
choice of presets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.decoders import base as jbase
from ldpcsimulation_tpu.decoders import gdbf as jg
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu.decoders import qc_ops as jqc_ops
from ldpcsimulation_tpu_torch.codes import QCCode
from ldpcsimulation_tpu_torch.decoders import gdbf as pg
from ldpcsimulation_tpu_torch.decoders import qc_ops
from ldpcsimulation_tpu_torch.decoders.base import (
    check_satisfied,
    syndrome_from_hard,
)
from ldpcsimulation_tpu_torch.decoders.dense_ops import DenseGraph
from ldpcsimulation_tpu_torch.decoders.minsum_qc import qc_check_satisfied
from ldpcsimulation_tpu_torch.kernels import check as kcheck
from ldpcsimulation_tpu_torch.kernels import gdbf as kgdbf
from tests.test_torch_gdbf import (  # noqa: F401  (graphs: a fixture)
    SIGMA_2DB,
    SIGMA_4DB,
    _assert_equal,
    _channel,
    _decode_both,
    _edge_codes,
    graphs,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
B = 37  # not a multiple of the kernels' 4 lanes
DTYPES = {"int8": (np.int8, torch.int8), "int32": (np.int32, torch.int32)}
PARALLEL = ["GDBF", "SMGDBF", "ATGDBF", "SATGDBF", "MNGDBF", "SMNGDBF",
            "RSMNGDBF"]


def _codes(graphs):
    """(JAX code, JAX qc or None, port code, port qc or None) by name: the
    fixture's generic and QC graphs and the two edge codes."""
    out = dict(graphs)
    for i, jqc in enumerate(_edge_codes()):
        pqc = QCCode.from_reference(jqc)
        out[f"edges{i}"] = (jqc.to_code(), jqc, pqc.to_code(), pqc)
    return out


def _decisions(rng, n, ndt):
    """±1 decisions [N, B] with a few all-(+1) lanes (codewords)."""
    d = np.where(rng.random((n, B)) < 0.85, 1, -1).astype(ndt)
    d[:, ::9] = 1
    return d


# ------------------------------------------------------------------ B6


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["generic", "qc", "edges0", "edges1"])
def test_b6_twin_equals_the_jax_checks(graphs, name, dtype):
    """The parity check's satisfied flags and bipolar syndrome, through
    every table that feeds B6 (the slot arrays', ``QCGraph.check_cols``,
    ``QCPlan.check_cols``), equal the JAX checks."""
    ndt, tdt = DTYPES[dtype]
    jc, jqc, pc, pqc = _codes(graphs)[name]
    rng = np.random.default_rng(16)
    d = _decisions(rng, jc.n, ndt)
    dt = torch.from_numpy(d)
    want_syn = np.asarray(jbase.syndrome_from_hard(jc, jnp.asarray(d)))
    want_sat = np.asarray(jbase.check_satisfied(jc, jnp.asarray(d)))
    assert want_sat.any() and not want_sat.all()
    tables = [qc_ops.slot_graph(pc, CPU).check_cols]
    if jqc is not None:
        jd = jnp.asarray(d).reshape(jqc.nb, jqc.z, B)
        np.testing.assert_array_equal(
            np.asarray(jmsqc.qc_check_satisfied(jqc, jd)), want_sat)
        np.testing.assert_array_equal(
            np.asarray(jqc_ops.qc_syndrome_bipolar(jqc, jnp.asarray(d))),
            want_syn)
        tables.append(qc_ops.qc_graph(pqc, CPU).check_cols)
        np.testing.assert_array_equal(
            qc_check_satisfied(pqc, dt).numpy(), want_sat)
        syn = qc_ops.qc_syndrome_bipolar(pqc, dt)
        assert syn.dtype == tdt
        np.testing.assert_array_equal(syn.numpy(), want_syn)
    for cols in tables:
        sat, syn = kcheck.parity_check_plain(cols, dt, syndrome=True)
        assert syn.dtype == tdt and sat.dtype == torch.bool
        np.testing.assert_array_equal(syn.numpy(), want_syn)
        np.testing.assert_array_equal(sat.numpy(), want_sat)
        assert torch.equal(kcheck.parity_check(cols, dt), sat)
    np.testing.assert_array_equal(check_satisfied(pc, dt).numpy(), want_sat)
    np.testing.assert_array_equal(syndrome_from_hard(pc, dt).numpy(),
                                  want_syn)


def test_b6_wrapper_checks_its_inputs(graphs):
    """The table must be int64 and the decisions int8/int32 and
    contiguous; a device that is neither the CPU nor CUDA raises."""
    cols = qc_ops.slot_graph(graphs["generic"][2], CPU).check_cols
    d = torch.ones((graphs["generic"][2].n, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="cols"):
        kcheck.parity_check(cols.int(), d)
    with pytest.raises(ValueError, match="int8/int32"):
        kcheck.parity_check(cols, d.float())
    with pytest.raises(ValueError, match="contiguous"):
        kcheck.parity_check(cols, torch.ones((8, d.shape[0]),
                                             dtype=torch.int32).t())
    with pytest.raises(ValueError, match="unsupported device"):
        kcheck.parity_check(cols.to("meta"), d.to("meta"))


@pytest.mark.parametrize("dtype,batch,ptr_off,want", [
    (torch.int32, 32768, 0, 4), (torch.int32, 32770, 0, 1),
    (torch.int32, 32768, 1, 1), (torch.int8, 32768, 0, 16),
    (torch.int8, 32776, 0, 1), (torch.int8, 32768, 4, 1),
])
def test_b6_lane_width(dtype, batch, ptr_off, want):
    """B6's instance: one 16-byte load a row (4 int32 or 16 int8 lanes a
    thread) where the batch and d's address allow it, else 1."""
    n = 10
    buf = torch.zeros(n * batch + 16, dtype=dtype)
    assert kcheck.check_lane_width(
        buf[ptr_off:ptr_off + n * batch].view(n, batch)) == want


# ------------------------------------------------------------------ B7


def _jax_vn_side(jcfg, jc, jqc, d, y_t, syn, thetas, dsum, act, pert,
                 in_window):
    """The JAX decoder's step after its CN update, run op by op."""
    dtype = jnp.float32
    n, b = y_t.shape
    if jcfg.weight_syndromes and jcfg.legacy_weight:
        w = (jcfg.alpha * jcfg.weight_ymax
             / jc.vn_deg.astype(dtype))[:, None]
    else:
        w = jnp.asarray(jcfg.alpha if jcfg.weight_syndromes else 1.0, dtype)
    with jax.disable_jit():
        syn = jnp.asarray(syn)
        if jqc is not None:
            ssum = jqc_ops.qc_syndrome_sum_per_vn(jqc, syn.astype(dtype))
        else:
            ssum = jg._syndrome_sum_per_vn(jc, syn)
        p = jnp.zeros((n, b), dtype) if pert is None else jnp.asarray(pert)
        d = jnp.asarray(d)
        e = d.astype(dtype) * jnp.asarray(y_t) + w * ssum + p
        th = jnp.asarray(thetas)
        flip, ffa = jg.flip_decisions(
            jcfg, e, th, jnp.ones((b,), jnp.int32),
            jnp.asarray(1.0, dtype), None)
        a = jnp.asarray(act)[None, :]
        d = jnp.where(a & flip, -d, d)
        if jcfg.threshold_adaptation:
            th = jnp.where(a & ~ffa, th * jcfg.lam, th)
        ds = jnp.asarray(dsum)
        if jcfg.output_smoothing and in_window:
            ds = jnp.where(a, ds + d, ds)
    return np.asarray(d), np.asarray(th), np.asarray(ds)


@pytest.mark.parametrize("graph,dtype", [("generic", "int32"),
                                         ("qc", "int8"), ("edges1", "int8")])
@pytest.mark.parametrize("name,in_window", [
    (name, w) for name in PARALLEL
    for w in ((True, False) if pg.PRESETS[name].get("output_smoothing")
              else (False,))
])
def test_b7_twin_equals_the_jax_vn_side(graphs, name, graph, dtype,
                                        in_window):
    """The twin's d, θ and dsum after one step equal the JAX step's VN side
    (neighbour sum, metric, parallel flip rule, adaptation, smoothing),
    with some lanes inactive and θ already adapted in places."""
    ndt, _ = DTYPES[dtype]
    jc, jqc, pc, pqc = _codes(graphs)[graph]
    jcfg = jg.preset(name, num_iterations=10, theta=-0.6, lam=0.98,
                     alpha=1.5, window_size=4)
    cfg = pg.GDBFConfig.from_reference(jcfg)
    n = jc.n
    rng = np.random.default_rng(PARALLEL.index(name))
    y_t = _channel(rng, B, n, SIGMA_2DB).T.copy()
    d = _decisions(rng, n, ndt)
    syn = np.asarray(jbase.syndrome_from_hard(jc, jnp.asarray(d))).astype(
        ndt)
    thetas = (np.float32(-0.6) * np.float32(0.98) ** rng.integers(
        0, 4, (n, B))).astype(np.float32)
    dsum = rng.integers(-3, 4, (n, B)).astype(np.int32)
    act = rng.random(B) < 0.8
    pert = (rng.normal(0.0, 0.9 * SIGMA_2DB, (n, B)).astype(np.float32)
            if cfg.add_noise else None)
    want = _jax_vn_side(jcfg, jc, jqc, d, y_t, syn, thetas, dsum, act, pert,
                        in_window)

    g = (qc_ops.qc_graph(pqc, CPU) if pqc is not None
         else qc_ops.slot_graph(pc, CPU))
    if cfg.weight_syndromes and cfg.legacy_weight:
        w = torch.tensor(cfg.alpha * cfg.weight_ymax) / pc.vn_deg.float()
    else:
        w = float(np.float32(cfg.alpha if cfg.weight_syndromes else 1.0))
    got = [torch.from_numpy(x.copy()) for x in (d, thetas, dsum)]
    kgdbf.gdbf_parallel_step(
        got[0], torch.from_numpy(y_t), torch.from_numpy(syn), g.vn_checks,
        got[1], got[2], torch.from_numpy(act), w,
        None if pert is None else torch.from_numpy(pert),
        float(np.float32(cfg.lam)) if cfg.threshold_adaptation else None,
        cfg.output_smoothing and in_window)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.int32),
                                  want[1].view(np.int32))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert (got[0].numpy() != d).any()


def test_b7_wrapper_checks_its_inputs(graphs):
    """Shapes, dtypes and devices are checked before anything runs."""
    pc = graphs["generic"][2]
    g = qc_ops.slot_graph(pc, CPU)
    n, m, b = pc.n, pc.m, 8
    args = dict(d=torch.ones((n, b), dtype=torch.int8),
                y=torch.zeros((n, b)),
                syn=torch.ones((m, b), dtype=torch.int8),
                vn_checks=g.vn_checks, thetas=torch.zeros((n, b)),
                dsum=torch.zeros((n, b), dtype=torch.int32),
                act=torch.ones(b, dtype=torch.bool), w=1.0)
    for key, bad, match in (
        ("syn", torch.ones((m, b), dtype=torch.int32), "syn"),
        ("y", torch.zeros((n, b), dtype=torch.float16), "y must"),
        ("act", torch.ones(b + 1, dtype=torch.bool), "act"),
        ("w", torch.ones(n + 1), "w must"),
        ("vn_checks", g.vn_checks.int(), "vn_checks"),
    ):
        with pytest.raises(ValueError, match=match):
            kgdbf.gdbf_parallel_step(**{**args, key: bad})
    with pytest.raises(ValueError, match="unsupported device"):
        kgdbf.gdbf_parallel_step(**{k: v.to("meta") if isinstance(
            v, torch.Tensor) else v for k, v in args.items()})


# ------------------------------------------------------- the whole route


@pytest.mark.parametrize("graph", ["generic", "qc"])
@pytest.mark.parametrize("name,kw", [
    ("GDBF", {}), ("ATGDBF", {}), ("MNGDBF", dict(noise_scale=0.9)),
])
def test_decode_on_b6_and_b7_equals_jax(graphs, graph, name, kw,
                                        monkeypatch):
    """``decode_gdbf`` takes every step's syndrome from B6 and its VN side
    from B7, and equals the JAX decoder (MNGDBF on injected
    perturbations)."""
    calls = {"parity_check": 0, "gdbf_parallel_step": 0}
    for fn in calls:
        real = getattr(pg, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            calls[_fn] += 1
            return _real(*a, **k)

        monkeypatch.setattr(pg, fn, spy)
    rng = np.random.default_rng(7)
    n = graphs[graph][0].n
    sigma = SIGMA_4DB
    y = _channel(rng, 16, n, sigma)
    cfg = jg.preset(name, num_iterations=12, theta=-0.7, lam=0.98,
                    alpha=1.5, **kw)
    pert = (rng.normal(0.0, sigma * 0.9, (12, n, 16)).astype(np.float32)
            if cfg.add_noise else None)
    jres, pres = _decode_both(graphs[graph], y, sigma, cfg, pert=pert)
    _assert_equal(jres, pres)
    assert calls["parity_check"] == calls["gdbf_parallel_step"] == (
        pres.steps) > 0
    assert pres.satisfied.any() and not pres.satisfied.all()


@pytest.mark.parametrize("name,dense,b7", [
    ("SGDBF", False, False), ("MGDBF", False, False),
    ("StochasticNGDBF", False, False), ("SMNGDBF", True, False),
    ("SMNGDBF", False, True),
])
def test_the_route_follows_the_config(graphs, name, dense, b7, monkeypatch):
    """B7 takes the parallel rule on the gather graphs; the sequential,
    mode-switching and stochastic rules and the dense route keep the plain
    VN side (B6 still checks every gather-graph step)."""
    calls = []
    monkeypatch.setattr(pg, "gdbf_parallel_step",
                        lambda *a, **k: calls.append("b7") or
                        kgdbf.gdbf_parallel_step(*a, **k))
    jc, _, pc, _ = graphs["generic"]
    rng = np.random.default_rng(8)
    y = torch.from_numpy(_channel(rng, 8, jc.n, SIGMA_4DB))
    cfg = pg.preset(name, 6, theta=-0.7, window_size=3)
    steps = cfg.max_phases * 6
    pert = torch.from_numpy(rng.normal(0.0, 0.5, (steps, jc.n, 8)).astype(
        np.float32))
    unif = torch.from_numpy(rng.uniform(size=(steps, jc.n, 8)).astype(
        np.float32))
    res = pg.decode_gdbf(pc, y, SIGMA_4DB, cfg, perturbations=pert,
                         stoch_uniforms=unif,
                         dense=DenseGraph.from_code(pc, CPU) if dense else None)
    assert (len(calls) > 0) == b7
    assert res.hard.dtype == torch.int32
