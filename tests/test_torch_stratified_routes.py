"""The stratified family's streams, sweep routes and report row.

* ``minsum_stratified_stream`` and ``bp_stratified_stream``: every frame a
  recorded stream call retires equals the JAX package's batch decoder on
  the same numpy pool row (the JAX stream closes over alpha, which XLA may
  turn into a reciprocal multiply, so the batch decoder is the reference,
  as for the layered streams), and the port's batch decoder per gid on
  kernel B2's twin rows; ``simulate_stream`` totals equal ``simulate``'s.
  BP by frame agreement against JAX, bit for bit against the port's batch
  decoder at sizes that are multiples of 64.
* The sweep: a stratifiable ``--alist`` takes the stratified decoder for
  ``bp`` (batch and ``--stream``), with the JAX CLI's stderr line; not
  under ``--schedule layered``, ``gdbf``, ``--distributed``, nor on
  peg_1008_504's alist.  ``minsum``, ``offsetminsum``,
  ``normalizedminsum`` and ``ddbmp`` keep the slot-array decoders, where
  the JAX CLI takes its stratified ones: their rows equal the stratified
  decoders' bit for bit, also on an alist whose structure has more column
  groups than kernel B1 takes.
* ``perf_report``'s stratified row and its byte and operation model
  against the JAX tool's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import stratified as jst
from ldpcsimulation_tpu.decoders import bp_stratified as jbps
from ldpcsimulation_tpu.decoders import minsum_stratified as jms
from ldpcsimulation_tpu.tools.sweep import main as jax_main
from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes import (
    build_code,
    code_to_alist,
    detect_stratified,
    load_named_code,
    save_alist,
)
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp_stratified,
    decode_ddbmp_stratified,
    decode_minsum_stratified,
)
from ldpcsimulation_tpu_torch.harness import StopRule, stream
from ldpcsimulation_tpu_torch.tools import perf_report as pperf
from ldpcsimulation_tpu_torch.tools import sweep
from tests.test_torch_stratified import _jalist, synthetic_stratified
from tests.test_torch_stream import (
    T,
    _port_frames,
    _prefix_totals,
    drive_port,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

ALIST = synthetic_stratified(512, h=64, mb=4, seed=9)
SC = detect_stratified(ALIST)
JSC = jst.detect_stratified(_jalist(ALIST))
CODE = build_code(ALIST)
SNR, RATE = 2.5, 0.5
SIGMA = snr_to_sigma(SNR, RATE)
N0 = snr_to_n0(SNR, RATE)
BP_FRAME_AGREEMENT = 0.97
F16 = (jnp.float16, torch.float16)


def _llr(y):
    return llr_from_channel(y, N0)


#: name -> (port adapter, batch kwargs (port, JAX), preprocess, is BP)
STREAMS = {
    "minsum_plain": (stream.minsum_stratified_stream(SC), ({}, {}), None,
                     False),
    "minsum_offset_f16": (
        stream.minsum_stratified_stream(SC, variant="offset", delta=0.15,
                                        storage_dtype=F16[1]),
        (dict(variant="offset", delta=0.15, storage_dtype=F16[1]),
         dict(variant="offset", delta=0.15, storage_dtype=F16[0])),
        None, False),
    "minsum_normalized": (
        stream.minsum_stratified_stream(SC, variant="normalized", alpha=1.3),
        (dict(variant="normalized", alpha=1.3),) * 2, None, False),
    "bp_f16": (stream.bp_stratified_stream(SC, storage_dtype=F16[1]),
               (dict(storage_dtype=F16[1]), dict(storage_dtype=F16[0])),
               _llr, True),
}


def _batch(name, rows, jax=False):
    """The batch decoder of stream ``name`` (early termination) on
    ``rows``: the port's, or with ``jax=True`` the JAX package's."""
    _, (kw, jkw), _, is_bp = STREAMS[name]
    if jax:
        dec = (jbps.decode_bp_stratified if is_bp
               else jms.decode_minsum_stratified)
        return dec(JSC, jnp.asarray(rows), T, early_termination=True, **jkw)
    dec = decode_bp_stratified if is_bp else decode_minsum_stratified
    return dec(SC, torch.as_tensor(rows), T, early_termination=True, **kw)


def _reference(res):
    """{frame: (iterations, errors, decisions)} of a batch decode."""
    hard = np.asarray(res.hard).astype(np.int8)
    it = np.asarray(res.iterations)
    return {g: (int(it[g]), int((hard[g] != 1).sum()), hard[g].tobytes())
            for g in range(hard.shape[0])}


def _agreement(per, ref):
    return sum(ref[g] == v for g, v in per.items()) / len(per)


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_equals_the_jax_batch_decoder(name):
    """One numpy pool over two calls (frames in flight across the call
    boundary, then the pool exhausted): each retired frame's iterations,
    errors and decisions are the JAX batch decoder's on its row."""
    dec, _, pre, is_bp = STREAMS[name]
    rng = np.random.default_rng(3)
    y = (1.0 + SIGMA * rng.standard_normal((256, SC.n))).astype(np.float32)
    rows = y if pre is None else pre(torch.from_numpy(y)).numpy()
    sat0 = dec.satisfied(stream._sign8(dec.prep(torch.from_numpy(rows))))
    unc = (y <= 0).sum(axis=1).astype(np.int32)
    calls = drive_port(dec, SC.n, [(0, rows[:192], unc[:192], sat0[:192]),
                                   (192, rows[192:], unc[192:], sat0[192:])],
                       64, 30, 2, 256 + 64)
    per = _port_frames(calls)
    assert len(per) == 256
    same = _agreement(per, _reference(_batch(name, rows, jax=True)))
    if is_bp:
        assert same >= BP_FRAME_AGREEMENT, same
    else:
        assert same == 1.0, same
    iters = [v[0] for v in per.values()]
    assert min(iters) < T == max(iters)  # converged and capped frames


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_equals_the_ports_batch_decoder(name):
    """Per gid on kernel B2's twin rows: iterations, errors and decisions
    equal the port's batch decoder's (BP too: 64 lanes, 192 frames)."""
    dec, _, pre, _ = STREAMS[name]
    F, lanes = 192, 64
    rows, unc, sat0 = stream.build_channel_pool(dec, 11, 0, F, SC.n, SIGMA,
                                                pre, device="cpu")
    calls = drive_port(dec, SC.n, [(0, rows[:128], unc[:128], sat0[:128]),
                                   (128, rows[128:], unc[128:], sat0[128:])],
                       lanes, 40, 1, F + lanes)
    per = _port_frames(calls)
    assert len(per) == F
    assert _agreement(per, _reference(_batch(name, rows))) == 1.0


@pytest.mark.parametrize("name", ["minsum_offset_f16", "bp_f16"])
def test_simulate_stream_totals_equal_simulate(name):
    dec, _, pre, _ = STREAMS[name]
    stats = stream.simulate_stream(
        SC.n, dec, SNR, RATE, T, stop=StopRule.fixed_frames(256), lanes=64,
        refill_every=2, seed=7, preprocess=pre, device="cpu")
    assert stats.total_words >= 256
    _prefix_totals(stats, lambda y: _batch(name, y), pre, stats.total_words,
                   7, code=CODE)


# ------------------------------------------------------------------- sweep


class _Spy:
    """Counts the calls of the sweep's decoder and stream entry points."""

    NAMES = ("decode_bp_stratified", "bp_stratified_stream",
             "decode_minsum", "decode_bp", "decode_ddbmp", "minsum_stream",
             "bp_stream")

    def __init__(self, monkeypatch):
        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(sweep, name)

            def counted(*a, _name=name, _real=real, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(sweep, name, counted)

    def used(self):
        return {k for k, v in self.calls.items() if v}


@pytest.fixture(scope="module")
def alist_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("strat") / "irr.alist"
    save_alist(ALIST, str(path))
    return str(path)


def _args(dec, path, log, extra=()):
    return [dec, "--alist", path, "--snr", "2.5", "-T", "4", "--log",
            str(log), "--batch", "64", "--max-frames", "64", "--min-errors",
            "0", "--min-word-errors", "0", *extra]


LINE = "sweep: detected stratified structure (4x64 strata, 13 column groups)"
USED = {"minsum": "decode_minsum", "offsetminsum": "decode_minsum",
        "normalizedminsum": "decode_minsum", "bp": "decode_bp_stratified",
        "ddbmp": "decode_ddbmp"}


def _as_stratified(monkeypatch, sc):
    """The sweep's slot-array min-sum and DD-BMP decoders replaced by the
    stratified ones on ``sc`` (the JAX CLI's route for the same command)."""
    from ldpcsimulation_tpu_torch.decoders import decode_ddbmp_stratified

    monkeypatch.setattr(sweep, "decode_minsum",
                        lambda code, y, T, **kw: decode_minsum_stratified(
                            sc, y, T, **kw))
    monkeypatch.setattr(sweep, "decode_ddbmp",
                        lambda code, yq, T: decode_ddbmp_stratified(sc, yq, T))


@pytest.mark.parametrize("dec", list(USED))
def test_sweep_takes_the_stratified_route(dec, alist_path, tmp_path,
                                          monkeypatch, capsys):
    """The JAX CLI prints the line for every one of these decoders; the
    port prints it for BP and decodes every batch with the stratified BP
    decoder.  Min-sum and DD-BMP stay on the slot arrays (no line), and
    their rows equal those of the stratified decoders the JAX CLI takes."""
    assert jax_main(_args(dec, alist_path, tmp_path / "j.log",
                          ["-T", "1"])) == 0
    assert LINE in capsys.readouterr().err
    spy = _Spy(monkeypatch)
    assert sweep.main(_args(dec, alist_path, tmp_path / "s.log",
                            ["--device", "cpu"])) == 0
    assert (LINE in capsys.readouterr().err) == (dec == "bp")
    assert spy.used() == {USED[dec]}
    if dec == "bp":
        monkeypatch.setattr(sweep, "detect_stratified", lambda alist: None)
    else:
        _as_stratified(monkeypatch, SC)
    assert sweep.main(_args(dec, alist_path, tmp_path / "g.log",
                            ["--device", "cpu"])) == 0
    assert LINE not in capsys.readouterr().err
    if dec == "bp":
        assert spy.used() == {"decode_bp_stratified", "decode_bp"}
    ours = (tmp_path / "s.log").read_text().split("\t")
    other = (tmp_path / "g.log").read_text().split("\t")
    assert ours[-1] == other[-1] == alist_path + "\n"
    if dec != "bp":
        assert ours == other


def test_sweep_minsum_keeps_the_slot_arrays_past_b1s_groups(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """An alist that stratifies into more column groups (66) than kernels
    B1 and B8 take (64) while its rows hold at most 50 edges: ``minsum``
    decodes on the slot arrays, which B1 takes, with the rows of the
    stratified decoder; ``bp`` says why and decodes on the slot arrays too,
    whose rows B8 takes."""
    a = synthetic_stratified(800, h=16, mb=3, p_edge=1.0, seed=1)
    sc = detect_stratified(a)
    assert max(len(r) for r in a.mlist) == 50
    assert sc is not None and sc.kg == 66 > 64
    assert jst.detect_stratified(_jalist(a)).kg == sc.kg
    path = str(tmp_path / "wide.alist")
    save_alist(a, path)
    spy = _Spy(monkeypatch)
    for dec, want in (("minsum", "decode_minsum"), ("bp", "decode_bp")):
        spy.calls = dict.fromkeys(spy.NAMES, 0)
        assert sweep.main(_args(dec, path, tmp_path / f"{dec}.log",
                                ["--device", "cpu"])) == 0
        err = capsys.readouterr().err
        assert "detected stratified structure" not in err
        assert ("(3x16 strata, 66 column groups) wider than kernel B8's 64 "
                "slots" in err) == (dec == "bp")
        assert spy.used() == {want}
    _as_stratified(monkeypatch, sc)
    assert sweep.main(_args("minsum", path, tmp_path / "s.log",
                            ["--device", "cpu"])) == 0
    assert ((tmp_path / "s.log").read_text()
            == (tmp_path / "minsum.log").read_text())


@pytest.mark.parametrize("dec,adapter", [
    ("minsum", "minsum_stream"),
    ("offsetminsum", "minsum_stream"),
    ("bp", "bp_stratified_stream")])
def test_sweep_stream_takes_the_stratified_adapter(dec, adapter, alist_path,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    """``--stream bp`` takes the stratified adapter; the min-sum streams
    keep the slot-array adapter, as their batch routes do."""
    spy = _Spy(monkeypatch)
    assert sweep.main(_args(dec, alist_path, tmp_path / "s.log",
                            ["--device", "cpu", "--stream",
                             "--early-termination"])) == 0
    assert (LINE in capsys.readouterr().err) == (dec == "bp")
    assert spy.used() == {adapter}
    assert len((tmp_path / "s.log").read_text().splitlines()) == 1


@pytest.mark.parametrize("case", ["layered", "gdbf", "distributed",
                                  "peg_1008_504"])
def test_sweep_keeps_the_other_routes(case, alist_path, tmp_path,
                                      monkeypatch, capsys):
    """``--schedule layered`` needs a QC code (no detection, as in JAX);
    ``gdbf`` never looks for strata; ``bp --distributed`` detects (the JAX
    CLI prints the line too) but decodes on the slot arrays, as JAX's
    ``_run_distributed`` does; peg_1008_504's alist does not stratify."""
    spy = _Spy(monkeypatch)
    log = tmp_path / "p.log"
    if case == "layered":
        with pytest.raises(SystemExit, match="QC-structured"):
            sweep.main(_args("bp", alist_path, log,
                             ["--schedule", "layered", "--device", "cpu"]))
        assert LINE not in capsys.readouterr().err
        return
    if case == "gdbf":
        args = ["gdbf", "--preset", "SMNGDBF", "--alist", alist_path,
                "--snr", "3.0", "-T", "4", "--batch", "16", "--max-frames",
                "16", "--log", str(log), "--device", "cpu"]
    elif case == "distributed":
        args = _args("bp", alist_path, log,
                     ["--device", "cpu", "--distributed"])
    else:
        path = str(tmp_path / "peg.alist")
        save_alist(code_to_alist(load_named_code("peg_1008_504")), path)
        args = _args("bp", path, log, ["--device", "cpu"])
    assert sweep.main(args) == 0
    err = capsys.readouterr().err
    assert (LINE in err) == (case == "distributed")
    assert not spy.used() & {"decode_bp_stratified", "bp_stratified_stream"}
    if case == "peg_1008_504":
        assert spy.used() == {"decode_bp"}
    assert len(log.read_text().splitlines()) == 1


# ------------------------------------------------------------ perf_report


def test_perf_report_stratified_row_and_model_equal_jax(tmp_path):
    """The report's stratified row beside the real H's generic row, and the
    JAX tool's byte and operation model (written inline in its main) for
    the 802.3an geometry's structure."""
    a = synthetic_stratified(2048, h=64, mb=6, p_edge=1.0, seed=0)
    js = jst.detect_stratified(_jalist(a))
    for b_strat in (16384, 4):
        s_vn = js.mb * js.kg * js.w
        s_cn = js.mb * js.h * js.kg
        oh = js.mb * js.kg * js.w * js.h
        want = (s_vn * (2 * 2 + 2 * 4) + s_cn * 4 * 4 + 8 * js.n
                + 2 * oh * 4 / b_strat, 2 * 2 * oh)
        assert pperf.stratified_models(detect_stratified(a), b_strat) == want
    # with a reference checkout the real H gets both rows; here an alist of
    # its geometry stands in for it
    path = tmp_path / pperf.REAL_802_3
    path.parent.mkdir(parents=True)
    save_alist(a, str(path))
    rows = {r.label: r for r in pperf.rows(str(tmp_path))}
    labels = list(rows)
    i = labels.index("min-sum T=10, REAL 802.3an H, generic f16")
    assert labels[i + 1] == (
        "min-sum T=10, REAL 802.3an H, stratified f16 (cost 1.62598)")
    row = rows[labels[i + 1]]
    assert row.batch == 16384
    m = row.measure("cpu", batch=4, repeats=1)
    assert m.frames == 8 and m.flops_per_s is None
    assert m.bytes_per_s == pytest.approx(
        m.frames * 10 * pperf.stratified_models(detect_stratified(a),
                                                16384)[0] / m.seconds)
    assert not any("stratified" in r.label for r in pperf.rows())
