"""The port's dense graph route (``decoders/dense_ops.py``) against the JAX
package's ``dense_ops`` and against the port's slot-gather route, exactly.

The four operations on peg_96_48, highrate_2048_384 (B=64) and a PEG code
with padded check rows: values equal to JAX's and to the gathers', dtypes
equal to the gathers'.  ``decode_gdbf(dense=)`` (deterministic, SMNGDBF and
RSMNGDBF on injected perturbations, StochasticNGDBF on injected uniforms,
``trace=True``) and ``decode_ngdbf_hw(dense=)`` (one and three phases,
``qpointer0``, on injected rings) equal JAX's dense decode and the port's
generic decode.  Both streams with ``dense=``: every frame equals its batch
decode.  ``dense_worthwhile`` at JAX's threshold; the exactness bound of a
graph's dtype.  The sweep's ``gdbf`` and ``ngdbfhw`` routes on a code
without QC structure build a ``DenseGraph`` (batch, ``--stream``,
``--distributed``) and write the generic route's rows.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.decoders import dense_ops as jdense
from ldpcsimulation_tpu.decoders import gdbf as jg
from ldpcsimulation_tpu.decoders import ngdbf_hw as jhw
from ldpcsimulation_tpu_torch.channel import snr_to_sigma
from ldpcsimulation_tpu_torch.codes import Code, load_named_code
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import dense_ops as pdense
from ldpcsimulation_tpu_torch.decoders import gdbf as pg
from ldpcsimulation_tpu_torch.decoders import ngdbf_hw as phw
from ldpcsimulation_tpu_torch.decoders import qc_ops
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness import stream_gdbf as sg
from ldpcsimulation_tpu_torch.harness.stream_ngdbfhw import (
    simulate_stream_ngdbfhw,
)
from ldpcsimulation_tpu_torch.tools import perf_report as pperf
from ldpcsimulation_tpu_torch.tools import sweep
from tests import test_torch_stream_gdbf as tsg
from tests import test_torch_stream_ngdbfhw as tsh
from tests.test_torch_tools import _jax_nested
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

GDBF_FIELDS = ("hard", "iterations", "satisfied", "phases", "smoothing_used")
HW_FIELDS = ("hard", "iterations", "satisfied", "least_errors", "qpointer")


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def codes():
    """(JAX code, port code) by name; ``padded``'s PEG checks have degrees
    2 and 3 (padding slots)."""
    out = {}
    for name in ("peg_96_48", "highrate_2048_384"):
        out[name] = (jlib.load_named_code(name), load_named_code(name))
    jc = jbuild_code(jpeg(120, 40, 3, seed=7))
    out["padded"] = (jc, _port_code(jc))
    return out


def _graphs(codes, name):
    jc, pc = codes[name]
    return jc, pc, jdense.DenseGraph.from_code(jc), pdense.DenseGraph.from_code(
        pc, "cpu")


@pytest.mark.parametrize("name", ["peg_96_48", "highrate_2048_384",
                                  "padded"])
def test_dense_operations_equal_jax_and_the_gathers(codes, name):
    jc, pc, jdg, pdg = _graphs(codes, name)
    for f in _ARRAY_FIELDS:  # both packages built the same H
        np.testing.assert_array_equal(getattr(pc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    if name == "padded":
        assert not bool(pc.cn_mask.all())
    rng = np.random.default_rng(5)
    d = rng.choice(np.array([-1, 1], np.int32), size=(pc.n, 64))
    g = qc_ops.slot_graph(pc, "cpu")
    syndrome01, satsum = phw.hw_graph_ops(pc)
    td = torch.from_numpy(d)

    syn = pdense.dense_syndrome_bipolar(pdg, td)
    want = qc_ops.syndrome_bipolar(g, td)
    assert syn.dtype == want.dtype == torch.int32 and torch.equal(syn, want)
    np.testing.assert_array_equal(
        syn.numpy(), np.asarray(jdense.dense_syndrome_bipolar(jdg, d)))
    for dt in (torch.int32, torch.float32):
        s = syn.to(dt)
        got = pdense.dense_syndrome_sum_per_vn(pdg, s)
        want = qc_ops.syndrome_sum_per_vn(g, s)
        assert got.dtype == want.dtype == dt and torch.equal(got, want)
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jdense.dense_syndrome_sum_per_vn(jdg, syn.numpy())))

    d01 = (td < 0).to(torch.uint8)
    s01 = pdense.dense_syndrome01(pdg, d01)
    want = syndrome01(d01)
    assert s01.dtype == want.dtype == torch.uint8 and torch.equal(s01, want)
    np.testing.assert_array_equal(
        s01.numpy(),
        np.asarray(jdense.dense_syndrome01(jdg, d01.numpy().astype(np.int32))))
    sat = pdense.dense_sat_sum_per_vn(pdg, s01)
    want = satsum(s01)
    assert sat.dtype == want.dtype == torch.int16 and torch.equal(sat, want)
    np.testing.assert_array_equal(
        sat.numpy(), np.asarray(jdense.dense_sat_sum_per_vn(
            jdg, s01.numpy().astype(np.int32))))
    # the hw_graph_ops route with dense= is the same pair of operations
    dsyn, dsat = phw.hw_graph_ops(pc, dense=pdg)
    assert torch.equal(dsyn(d01), s01) and torch.equal(dsat(s01), sat)


def test_dense_worthwhile_at_the_jax_threshold():
    assert pdense.DENSE_MAX_ENTRIES == jdense.DENSE_MAX_ENTRIES
    t = pdense.DENSE_MAX_ENTRIES
    for m, n in ((384, 2048), (32400, 64800), (1024, t // 1024),
                 (1024, t // 1024 + 1)):
        code = types.SimpleNamespace(m=m, n=n)
        assert pdense.dense_worthwhile(code) == jdense.dense_worthwhile(code)
    assert pdense.dense_worthwhile(types.SimpleNamespace(m=1024, n=t // 1024))
    assert not pdense.dense_worthwhile(
        types.SimpleNamespace(m=1024, n=t // 1024 + 1))


def test_graph_device_dtype_and_exactness_bound(codes):
    _, pc, _, pdg = _graphs(codes, "peg_96_48")
    assert pdg.h.dtype == torch.float32 and pdg.h.device.type == "cpu"
    assert pdg.vn_deg.dtype == torch.int16
    assert int(pdg.h.sum()) == pc.num_edges
    # a mesh slot's graph: this one on its own device, none without one
    on = pdense.graphs_by_device(pdg, pc)
    assert on("cpu") is pdg and on(torch.device("cpu")) is pdg
    other = on("meta")  # another device: built there once
    assert other is not pdg and other.h.device.type == "meta"
    assert on("meta") is other
    assert pdense.graphs_by_device(None, pc)("cpu") is None
    # f16 (the card's operands) holds integers exactly up to 2048: a graph
    # of higher degree is refused, never rounded
    h = torch.zeros((1, 1), dtype=torch.float16)
    pdense.DenseGraph(1, 1, 2048, 3, h, torch.ones(1, dtype=torch.int16))
    with pytest.raises(ValueError, match="exact integers"):
        pdense.DenseGraph(1, 1, 2049, 3, h, torch.ones(1, dtype=torch.int16))
    with pytest.raises(ValueError, match="dense graph does not match"):
        pg.decode_gdbf(load_named_code("peg_24_12"), torch.ones((2, 24)), 0.5,
                       pg.preset("GDBF", 4, -0.6), dense=pdg)


def test_from_code_defaults_to_the_card(codes):
    """No device: H goes to the card, in f16 (its tensor-core operands)."""
    _, pc, _, _ = _graphs(codes, "peg_96_48")
    assert pdense._product_dtype(torch.device("cuda")) is torch.float16
    if torch.cuda.is_available():
        g = pdense.DenseGraph.from_code(pc)
        assert g.h.is_cuda and g.h.dtype == torch.float16
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pdense.DenseGraph.from_code(pc)


# -- the decoders ------------------------------------------------------------

def _gdbf_three(jc, pc, jdg, pdg, y, sigma, cfg, pert=None, unif=None,
                trace=False):
    """JAX dense, port dense, port generic decodes of the same inputs."""
    jres = jg.decode_gdbf(
        jc, jnp.asarray(y), sigma, cfg, key=jax.random.key(0), dense=jdg,
        perturbations=None if pert is None else jnp.asarray(pert),
        stoch_uniforms=None if unif is None else jnp.asarray(unif),
        trace=trace)
    pcfg = pg.GDBFConfig.from_reference(cfg)
    kw = dict(
        perturbations=None if pert is None else torch.from_numpy(pert),
        stoch_uniforms=None if unif is None else torch.from_numpy(unif),
        trace=trace)
    dense = pg.decode_gdbf(pc, torch.from_numpy(y), sigma, pcfg, dense=pdg,
                           **kw)
    generic = pg.decode_gdbf(pc, torch.from_numpy(y), sigma, pcfg, **kw)
    return jres, dense, generic


@pytest.mark.parametrize("name,code_name,kw", [
    ("GDBF", "peg_96_48", dict(theta=-0.6)),
    ("MGDBF", "padded", dict(theta=-0.6, t_switch=2)),
    ("SMNGDBF", "peg_96_48", dict(theta=-0.9, noise_scale=0.9, lam=0.98,
                                  alpha=1.5, window_size=6)),
    ("RSMNGDBF", "padded", dict(theta=-0.9, noise_scale=0.9, lam=0.98,
                                alpha=1.5, window_size=4, max_phases=3)),
    ("StochasticNGDBF", "peg_96_48", dict(theta=-0.6, noise_scale=0.9,
                                          alpha=0.8)),
])
def test_decode_gdbf_dense_equals_jax_and_generic(codes, name, code_name,
                                                   kw):
    jc, pc, jdg, pdg = _graphs(codes, code_name)
    sigma = snr_to_sigma(3.0, 0.5)
    rng = np.random.default_rng(7)
    b = 24
    y = np.clip(1.0 + sigma * rng.standard_normal((b, pc.n)), -2.5,
                2.5).astype(np.float32)
    cfg = jg.preset(name, num_iterations=10, **kw)
    steps = cfg.max_phases * cfg.num_iterations
    pert = unif = None
    if cfg.add_noise:
        pert = rng.normal(0.0, sigma * 0.9, (steps, pc.n, b)).astype(
            np.float32)
    if cfg.quantize_probabilities:
        unif = rng.random((steps, pc.n, b), dtype=np.float32)
    jres, dense, generic = _gdbf_three(jc, pc, jdg, pdg, y, sigma, cfg,
                                       pert, unif)
    for f in GDBF_FIELDS:
        got = getattr(dense, f)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jres,
                                                                      f)))
        assert torch.equal(got, getattr(generic, f)), f
    assert dense.steps == generic.steps
    assert 0 < int(dense.satisfied.sum()) < b or name == "GDBF"


def test_decode_gdbf_dense_trace_equals_jax_and_generic(codes):
    """``trace=True``: every step's decisions, dense equal to JAX's dense
    trace and to the port's generic trace."""
    jc, pc, jdg, pdg = _graphs(codes, "padded")
    sigma = snr_to_sigma(3.0, 0.5)
    rng = np.random.default_rng(8)
    y = np.clip(1.0 + sigma * rng.standard_normal((6, pc.n)), -2.5,
                2.5).astype(np.float32)
    cfg = jg.preset("SMNGDBF", num_iterations=8, theta=-0.9, noise_scale=0.9,
                    lam=0.98, alpha=1.5, window_size=4)
    pert = rng.normal(0.0, sigma * 0.9, (8, pc.n, 6)).astype(np.float32)
    (jres, jsteps), (dres, dsteps), (gres, gsteps) = _gdbf_three(
        jc, pc, jdg, pdg, y, sigma, cfg, pert, trace=True)
    np.testing.assert_array_equal(dsteps.numpy(), np.asarray(jsteps))
    assert torch.equal(dsteps, gsteps)
    for f in GDBF_FIELDS:
        assert torch.equal(getattr(dres, f), getattr(gres, f)), f


@pytest.mark.parametrize("name,phases,qp", [
    ("peg_96_48", 1, False), ("padded", 3, True),
    ("highrate_2048_384", 1, True),
])
def test_decode_ngdbf_hw_dense_equals_jax_and_generic(codes, name, phases,
                                                      qp):
    jc, pc, jdg, pdg = _graphs(codes, name)
    rng = np.random.default_rng(9)
    b = 16
    sigma = snr_to_sigma(4.5 if name == "highrate_2048_384" else 7.0,
                         pc.rate)
    cfg = jhw.NGDBFHwConfig(num_iterations=20, w=0.25, ymax=1.5,
                            noise_scale=0.9, theta0=-0.5, max_phases=phases,
                            ring_len=pc.n + 150)
    y = (1.0 + sigma * rng.standard_normal((b, pc.n))).astype(np.float32)
    ring = (sigma * 0.9 * rng.standard_normal((cfg.ring_len, b))).astype(
        np.float32)
    qp0 = (rng.integers(0, 150, b).astype(np.int32) if qp else None)
    jres = jhw.decode_ngdbf_hw(
        jc, jnp.asarray(y), sigma, cfg, key=jax.random.key(0), dense=jdg,
        ring_noise=jnp.asarray(ring),
        qpointer0=None if qp0 is None else jnp.asarray(qp0))
    pcfg = phw.NGDBFHwConfig.from_reference(cfg)
    kw = dict(ring_noise=torch.from_numpy(ring),
              qpointer0=None if qp0 is None else torch.from_numpy(qp0))
    dense = phw.decode_ngdbf_hw(pc, torch.from_numpy(y), sigma, pcfg,
                                dense=pdg, **kw)
    generic = phw.decode_ngdbf_hw(pc, torch.from_numpy(y), sigma, pcfg, **kw)
    for f in HW_FIELDS:
        got = getattr(dense, f)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jres,
                                                                      f)))
        assert torch.equal(got, getattr(generic, f)), f
    assert int(dense.satisfied.sum()) > 0


# -- the streams -------------------------------------------------------------

@pytest.mark.parametrize("family", ["smngdbf", "redecode", "stochastic"])
def test_gdbf_stream_with_dense_equals_its_batch_decode(family):
    """The GDBF stream on the dense graph: every frame equals the batch
    ``decode_gdbf(dense=)`` and the generic batch decode of its row."""
    cfg, pre = tsg.FAMILIES[family]
    code = tsg.CODE
    dg = pdense.DenseGraph.from_code(code, "cpu")
    rows, unc, sat0 = sg.build_channel_pool_gdbf(
        code, tsg.SEED, 0, 96, tsg.SIGMA, pre, dense=dg, device="cpu")
    per = tsg._stream_frames(cfg, [(0, rows[:60], unc[:60], sat0[:60]),
                                   (60, rows[60:], unc[60:], sat0[60:])],
                             16, 60, 2, None, torch.float32, dense=dg)
    assert len(per) >= 70
    key = NoiseKey(tsg.SEED, 0)
    res = pg.decode_gdbf(code, rows, tsg.SIGMA, cfg, key=key, dense=dg)
    tsg._check_frames(per, res)
    generic = pg.decode_gdbf(code, rows, tsg.SIGMA, cfg, key=key)
    for f in GDBF_FIELDS:
        assert torch.equal(getattr(res, f), getattr(generic, f)), f


@pytest.mark.parametrize("phases,refill_every,cap", [(1, 4, None),
                                                      (2, 1, 5)])
def test_ngdbfhw_stream_with_dense_equals_its_batch_decode(phases,
                                                           refill_every, cap):
    """The NGDBFhw stream on the dense graph (the refilled columns'
    neighbour counts too): every frame equals the generic batch decode at
    its recorded ring offset."""
    code, _ = tsh.GRAPHS["generic"]
    dg = pdense.DenseGraph.from_code(code, "cpu")
    cfg = phw.NGDBFHwConfig(max_phases=phases, **tsh.SMALL)
    per = tsh._drive(code, None, cfg, [80, 40], 16, 64 // refill_every,
                     refill_every, cap=cap, dense=dg)
    assert len(per) >= 80
    tsh._assert_frames_equal(per, tsh._batch(code, None, cfg, per, len(per)))


def test_simulate_stream_dense_equals_generic():
    """Whole stream runs: the dense graph's totals equal the gathers'."""
    code, _ = tsh.GRAPHS["generic"]
    dg = pdense.DenseGraph.from_code(code, "cpu")
    cfg = phw.NGDBFHwConfig(**tsh.SMALL)
    runs = [simulate_stream_ngdbfhw(
        code, cfg, tsh.SNR, rate=tsh.RATE, stop=StopRule.fixed_frames(64),
        lanes=16, refill_every=4, seed=tsh.SEED, dense=d, device="cpu")
        for d in (dg, None)]
    a, b = runs
    assert a.total_words == b.total_words >= 64
    assert (a.errors, a.word_errors, a.total_iterations) == (
        b.errors, b.word_errors, b.total_iterations)
    gd = [sg.simulate_stream_gdbf(
        tsg.CODE, tsg.FAMILIES["smngdbf"][0], tsg.SNR, rate=tsg.RATE,
        stop=StopRule.fixed_frames(48), lanes=16, refill_every=2,
        seed=tsg.SEED, preprocess=tsg._sat, dense=d, device="cpu")
        for d in (pdense.DenseGraph.from_code(tsg.CODE, "cpu"), None)]
    assert (gd[0].total_words, gd[0].errors, gd[0].total_iterations) == (
        gd[1].total_words, gd[1].errors, gd[1].total_iterations)


# -- the sweep ---------------------------------------------------------------

class _Counted(pdense.DenseGraph):
    """A DenseGraph that counts its construction and its uses (every dense
    operation reads its graph's ``h``)."""

    built = []
    uses = [0]

    @classmethod
    def from_code(cls, code, device=None):
        g = super().from_code(code, device)
        cls.built.append((code, device))
        return g

    def __getattribute__(self, name):
        if name == "h":
            _Counted.uses[0] += 1
        return super().__getattribute__(name)


def _rows(path):
    return path.read_text().splitlines()


GDBF_SWEEP = ["gdbf", "--preset", "SMNGDBF", "--code", "peg_96_48",
              "--snr", "3.0", "-T", "12", "--theta", "-0.8",
              "--noise-scale", "0.9", "--lam", "0.98", "--alpha", "0.75",
              "--ymax", "2.5", "--window", "4", "--batch", "16",
              "--max-frames", "32"]
HW_SWEEP = ["ngdbfhw", "--code", "peg_96_48", "--snr", "4.0", "-T", "16",
            "--batch", "16", "--frames", "32"]


@pytest.mark.parametrize("args", [GDBF_SWEEP, HW_SWEEP],
                         ids=["gdbf", "ngdbfhw"])
@pytest.mark.parametrize("route", [[], ["--stream"], ["--distributed"],
                                   ["--persistent-qpointer"]],
                         ids=["batch", "stream", "distributed", "carry"])
def test_sweep_takes_the_dense_route_with_the_generic_rows(
        tmp_path, monkeypatch, args, route):
    if "--persistent-qpointer" in route and args[0] != "ngdbfhw":
        route = ["--uniform-noise"]  # a second gdbf batch route
    common = args + route + ["--device", "cpu"]
    monkeypatch.setattr(sweep, "DenseGraph", _Counted)
    _Counted.built.clear()
    _Counted.uses[0] = 0
    assert sweep.main(common + ["--log", str(tmp_path / "d.log")]) == 0
    assert len(_Counted.built) == 1
    code, device = _Counted.built[0]
    assert code.n == 96 and str(device) == "cpu"
    assert _Counted.uses[0] >= 2 * 12  # two operations per step, at least
    # the generic route: no dense graph where dense_worthwhile fails
    monkeypatch.setattr(sweep, "dense_worthwhile", lambda code: False)
    assert sweep.main(common + ["--log", str(tmp_path / "g.log")]) == 0
    assert len(_Counted.built) == 1
    dense, generic = _rows(tmp_path / "d.log"), _rows(tmp_path / "g.log")
    assert len(dense) == 1 and dense == generic
    if args[0] == "ngdbfhw":
        assert (tmp_path / "d.log_4_itdist.dat").read_text() == (
            tmp_path / "g.log_4_itdist.dat").read_text()


def test_sweep_keeps_the_qc_route_on_a_qc_code(tmp_path, monkeypatch):
    """A QC code takes its row gathers: no dense graph, as in the JAX CLI."""
    monkeypatch.setattr(sweep, "DenseGraph", _Counted)
    _Counted.built.clear()
    args = [a if a != "peg_96_48" else "qc_1008_504" for a in HW_SWEEP]
    assert sweep.main(args + ["-T", "4", "--device", "cpu", "--log",
                              str(tmp_path / "q.log")]) == 0
    assert _Counted.built == []



def test_perf_report_dense_row_and_model_equal_jax(tmp_path):
    """The report's dense NGDBFhw row beside the gather baseline, with the
    JAX tool's byte and operation model."""
    jmodel = _jax_nested("dense_hw_models")
    for n, m, b in ((2048, 384, 2048), (1008, 504, 4096)):
        assert pperf.dense_hw_models(n, m, b) == jmodel(n, m, b)
    labels = [r.label for r in pperf.rows()]
    i = labels.index("NGDBFhw T<=200 (2048,1664-class), gather baseline")
    assert labels[i + 1] == (
        "NGDBFhw T<=200 (2048,1664-class), dense ops (sweep default)")
    row = pperf.rows()[i + 1]
    m = row.measure("cpu", batch=4, repeats=1)
    assert m.upper and m.flops_per_s == pytest.approx(
        m.frames * 200 * 4 * 384 * 2048 / m.seconds)
    last = pperf.format_table([m], pperf.card_line("cpu")).splitlines()[-1]
    assert last.startswith(f"- {m.label}: ≤") and "TFLOP/s" in last
    # with a reference checkout, the real 802.3an H gets its dense row and
    # a dense stream (here an alist of the same shape stands in for it)
    from ldpcsimulation_tpu_torch.codes import code_to_alist, save_alist

    path = tmp_path / pperf.REAL_802_3
    path.parent.mkdir(parents=True)
    save_alist(code_to_alist(load_named_code("highrate_2048_384")), path)
    rows = {r.label: r for r in pperf.rows(str(tmp_path))}
    real = rows["NGDBFhw T<=200 REAL 802.3an H, dense ops"]
    m = real.measure("cpu", batch=4, repeats=1)
    assert m.frames == 8 and m.flops_per_s > 0
    s = rows["NGDBFhw T<=200 REAL 802.3an H, STREAM refill (K=16)"]
    assert s.measure("cpu", batch=4, repeats=1).frames >= 0
