"""The port's profiler spans (``ldpcsimulation_tpu_torch/spans.py``).

Under a CPU ``torch.profiler``: ``simulate`` opens one ``ldpc.batch`` a
batch holding its five phases, disjoint, on the calling thread; SM-NGDBF
reads its all-done flag every 4 steps and a fixed-T flooding decode never;
a flooding decode with early termination merges each executed round's
decisions under ``ldpc.decode.et_merge``, after the round's exit check;
the grid opens one round a round, its slots (each with one decode), the
all-reduce, the host copy and the tally.  With no profiler, a span is the
shared null context and ``record_function`` is never reached; the
statistics do not depend on a profiler; every name is in ``SPANS``.
"""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch import spans
from ldpcsimulation_tpu_torch.channel import snr_to_sigma
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.codes import load_named_code
from ldpcsimulation_tpu_torch.codes.qc import qc_peg
from ldpcsimulation_tpu_torch.decoders import decode_minsum, decode_minsum_qc
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.decoders.gdbf import (
    DONE_CHECK_EVERY,
    decode_gdbf,
    preset,
)
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from ldpcsimulation_tpu_torch.parallel import mesh as pmesh
from ldpcsimulation_tpu_torch.parallel.montecarlo import simulate_grid
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

CODE = load_named_code("peg_96_48")
QC = qc_peg(12, 6, 3, z=8, seed=1)
PACKAGE = Path(spans.__file__).resolve().parent
CALL = "test.call"  # the test's own range around the traced call
PHASES = (spans.CHANNEL, spans.DECODE, spans.COUNT, spans.TO_HOST,
          spans.TALLY)


def _minsum(y, key):
    return decode_minsum(CODE, y, 5)


def _smngdbf(sigma, T=10):
    cfg = preset("SMNGDBF", num_iterations=T, theta=-0.9,
                 noise_scale=0.975, lam=0.988, alpha=0.75)
    return lambda y, key: decode_gdbf(CODE, y, sigma, cfg, key=key)


def _minsum_qc_et(rounds):
    """QC min-sum T=6 with early termination and f16 messages; each
    decode's executed rounds (its largest count) go to ``rounds``."""
    def decode(y, key):
        res = decode_minsum_qc(QC, y, 6, early_termination=True,
                               storage_dtype=torch.float16)
        rounds.append(int(res.iterations.max()))
        return res

    return decode


def traced(fn):
    """Run ``fn`` under a CPU profiler inside the test's own range: (its
    result, [(name, start_ns, end_ns, thread)] of the ``ldpc.`` spans, the
    thread of the test's range)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALL):
            out = fn()
    events = prof.profiler.kineto_results.events()
    (call,) = [e for e in events if e.name() == CALL]
    got = sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                  for e in events if e.name().startswith("ldpc.")),
                 key=lambda s: (s[1], -s[2]))
    assert {s[0] for s in got} <= set(spans.SPANS)
    return out, got, call.start_thread_id()


def inside(outer, spans_):
    """The spans that lie within ``outer``."""
    return [s for s in spans_ if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


def children(outer, spans_):
    """The spans directly under ``outer``, in time order."""
    mine = inside(outer, spans_)
    return [s for s in mine if not any(s in inside(o, mine) for o in mine)]


def test_simulate_spans_each_batch():
    _, got, thread = traced(lambda: simulate(
        CODE, _minsum, 2.0, stop=StopRule.fixed_frames(48), batch_size=16,
        seed=7, device="cpu"))
    assert {s[3] for s in got} == {thread}
    batches = [s for s in got if s[0] == spans.BATCH]
    assert len(batches) == 3
    assert batches == children((CALL, 0, 2 ** 63, thread), got)
    for batch in batches:
        kids = children(batch, got)
        assert tuple(s[0] for s in kids) == PHASES
        for a, b in zip(kids, kids[1:]):
            assert a[2] <= b[1]  # disjoint
    covered = {s for b in batches for s in inside(b, got)}
    assert covered | set(batches) == set(got)


def test_exit_checks():
    sigma = snr_to_sigma(-10.0, CODE.rate)  # no frame converges
    y = awgn_all_zero(3, 0, 16, CODE.n, sigma, "cpu")
    T = 10
    res, got, _ = traced(lambda: _smngdbf(sigma, T)(y, NoiseKey(3, 0)))
    total_steps = preset("SMNGDBF", T, -0.9).max_phases * T
    assert not res.satisfied.any() and res.steps == total_steps
    checks = [s for s in got if s[0] == spans.EXIT_CHECK]
    assert len(checks) == math.ceil(total_steps / DONE_CHECK_EVERY)
    _, got, _ = traced(lambda: decode_minsum(CODE, y, T))
    assert got == []
    # the flooding driver with early termination reads it once a round,
    # each round's decision merge after it
    res, got, _ = traced(lambda: decode_minsum(CODE, y, T,
                                               early_termination=True))
    assert not res.satisfied.any()
    assert [s[0] for s in got] == [spans.EXIT_CHECK, spans.ET_MERGE] * T


def test_grid_spans_each_round():
    mesh = pmesh.make_mesh(n_snr=4, devices=["cpu"] * 4)
    points = [{"snr": s} for s in (1.0, 2.0, 3.0, 4.0)]
    stats, got, thread = traced(lambda: simulate_grid(
        CODE, lambda y, sigma, key, point: decode_minsum(CODE, y, 4), points,
        mesh, max_iterations=4, stop=StopRule.fixed_frames(32),
        batch_per_device=16, seed=5))
    assert [s.total_words for s in stats] == [32] * 4
    assert {s[3] for s in got} == {thread}
    rounds = [s for s in got if s[0] == spans.GRID_ROUND]
    assert len(rounds) == 2
    assert rounds == children((CALL, 0, 2 ** 63, thread), got)
    for r in rounds:
        kids = children(r, got)
        assert [s[0] for s in kids] == [spans.GRID_SLOT] * 4 + [
            spans.GRID_ALLREDUCE, spans.GRID_TO_HOST, spans.GRID_TALLY]
        for slot in kids[:4]:
            assert [s[0] for s in inside(slot, got)] == [spans.DECODE]


def test_no_profiler_no_record_function(monkeypatch):
    assert spans.span(spans.BATCH) is spans.span(spans.DECODE)
    assert isinstance(spans.span(spans.BATCH), type(spans._NULL))

    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    stats = simulate(CODE, _smngdbf(snr_to_sigma(3.0, CODE.rate)), 3.0,
                     stop=StopRule.fixed_frames(32), batch_size=16, seed=2,
                     device="cpu")
    assert stats.total_words == 32
    # the one bool check is all that keeps it out
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    with pytest.raises(AssertionError, match="record_function reached"):
        spans.span(spans.BATCH)


@pytest.mark.parametrize("family", ["minsum", "smngdbf", "minsum_qc_et"])
def test_stats_do_not_depend_on_the_profiler(family):
    sigma = snr_to_sigma(2.5, CODE.rate)
    rounds = []
    code = QC.to_code("cpu") if family == "minsum_qc_et" else CODE
    dec = {"minsum": _minsum, "smngdbf": _smngdbf(sigma),
           "minsum_qc_et": _minsum_qc_et(rounds)}[family]

    def run():
        return simulate(code, dec, 2.5, stop=StopRule.fixed_frames(48),
                        batch_size=16, seed=11, device="cpu")

    plain = run()
    rounds.clear()
    with_prof, got, _ = traced(run)
    assert got
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(with_prof, f.name)
        if f.name == "wall_seconds":
            continue
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name == "extra":
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b, f.name
    if family == "smngdbf":
        assert "phase_hist" in plain.extra
    # one decision merge per executed round, inside the batch's decode
    decodes = [s for s in got if s[0] == spans.DECODE]
    merges = [sum(s[0] == spans.ET_MERGE for s in inside(d, got))
              for d in decodes]
    assert merges == (rounds if family == "minsum_qc_et" else [0, 0, 0])
    assert all(rounds)


def _span_arguments():
    """The argument of every ``span(...)`` call in the package's source."""
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr",
                                getattr(node.func, "id", None)) == "span"):
                yield path.relative_to(PACKAGE), node.args[0]


def test_every_name_is_listed():
    assert len(set(spans.SPANS)) == len(spans.SPANS)
    assert all(n.startswith("ldpc.") for n in spans.SPANS)
    sites = list(_span_arguments())
    assert len(sites) >= len(spans.SPANS)
    for where, arg in sites:
        assert (isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "spans"), where
        assert getattr(spans, arg.attr) in spans.SPANS, where
    assert {getattr(spans, a.attr) for _, a in sites} == set(spans.SPANS)
