"""The row-layered min-sum step's span, ``ldpc.decode.layer``, and the
decision merge's, ``ldpc.decode.et_merge``, in ``run_flooding``.

Under a CPU ``torch.profiler``: ``decode_minsum_layered_qc`` with early
termination opens the layer span Mb times per executed round, each inside
the batch's ``ldpc.decode`` and holding no other span, and the merge's span
once per executed round, after the round's exit check and apart from the
layers; without early termination no merge opens; with no profiler the
spans are the shared null context and ``record_function`` is never
reached; the statistics of a layered ``simulate`` do not depend on a
profiler; the names are in ``SPANS``, under ``ldpc.decode.``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch import spans
from ldpcsimulation_tpu_torch.codes.qc import qc_peg
from ldpcsimulation_tpu_torch.decoders import decode_minsum_layered_qc
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from tests.test_torch_spans import inside, traced
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

QC = qc_peg(12, 6, 3, z=8, seed=1)
CODE = QC.to_code("cpu")
SNR = 3.0  # batches stop after different numbers of rounds
T = 6


def _simulate(early=True, rounds=None):
    """A layered normalized min-sum ``simulate`` of three batches of 16
    frames with f16 messages; ``rounds``, given, gets each batch's executed
    rounds (its largest count)."""
    def decode(y, key):
        res = decode_minsum_layered_qc(
            QC, y, T, variant="normalized", alpha=1.25,
            early_termination=early, storage_dtype=torch.float16)
        if rounds is not None:
            rounds.append(int(res.iterations.max()))
        return res

    return simulate(CODE, decode, SNR, stop=StopRule.fixed_frames(48),
                    batch_size=16, seed=17, device="cpu")


def test_names_are_under_the_decode():
    for name in (spans.LAYER_STEP, spans.ET_MERGE):
        assert name in spans.SPANS
        assert name.startswith(spans.DECODE + ".")


def test_layers_and_merges_per_executed_round():
    rounds = []
    stats, got, _ = traced(lambda: _simulate(rounds=rounds))
    assert stats.total_words == 48
    decodes = [s for s in got if s[0] == spans.DECODE]
    assert len(decodes) == len(rounds) == 3
    assert len(set(rounds)) > 1 and min(rounds) < T  # the exit cuts rounds
    layers = [s for s in got if s[0] == spans.LAYER_STEP]
    merges = [s for s in got if s[0] == spans.ET_MERGE]
    assert [sum(s[0] == spans.LAYER_STEP for s in inside(d, got))
            for d in decodes] == [QC.mb * r for r in rounds]
    assert [sum(s[0] == spans.ET_MERGE for s in inside(d, got))
            for d in decodes] == rounds
    # every one lies inside a decode and holds no other span
    assert len(layers) == QC.mb * sum(rounds)
    assert len(merges) == sum(rounds)
    for s in layers + merges:
        assert any(s in inside(d, got) for d in decodes)
        assert inside(s, got) == []
    # a decode's spans: its exit checks, a round's Mb layers then its merge
    for d, r in zip(decodes, rounds):
        names = [s[0] for s in inside(d, got)]
        round_ = [spans.EXIT_CHECK] + [spans.LAYER_STEP] * QC.mb + [
            spans.ET_MERGE]
        tail = [spans.EXIT_CHECK] if r < T else []
        assert names == round_ * r + tail


def test_no_merge_without_early_termination():
    _, got, _ = traced(lambda: _simulate(early=False))
    names = [s[0] for s in got]
    assert spans.ET_MERGE not in names
    assert spans.EXIT_CHECK not in names
    assert names.count(spans.LAYER_STEP) == 3 * QC.mb * T


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span(spans.LAYER_STEP) is spans._NULL
    assert spans.span(spans.ET_MERGE) is spans._NULL
    assert _simulate().total_words == 48


@pytest.mark.parametrize("early", [True, False])
def test_stats_do_not_depend_on_the_profiler(early):
    plain = _simulate(early)
    with_prof, got, _ = traced(lambda: _simulate(early))
    assert any(s[0] == spans.LAYER_STEP for s in got)
    for f in dataclasses.fields(plain):
        if f.name == "wall_seconds":
            continue
        a, b = getattr(plain, f.name), getattr(with_prof, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b, f.name
