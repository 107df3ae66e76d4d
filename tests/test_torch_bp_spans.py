"""The sum-product check update's span, ``ldpc.decode.bp_check``, and the
QC decoder's variable-node update's, ``ldpc.decode.bp_vn``.

Under a CPU ``torch.profiler``: ``decode_bp_qc``, ``decode_bp``,
``decode_bp_stratified`` and ``decode_bp_layered_qc`` with early
termination open the check span once per executed update round (the
layered decoder once per layer: Mb a round), each inside the batch's
``ldpc.decode``; ``decode_bp_qc`` opens the VN span once a round too,
after the round's check update and apart from it, and a min-sum decode
opens neither; all four open the decision merge's span,
``ldpc.decode.et_merge``, once per executed round too (the layered one in
``run_flooding``'s loop); with no profiler the span is the
shared null context and ``record_function`` is never reached; the
statistics of a BP ``simulate`` do not depend on a profiler; the names are
in ``SPANS``, under ``ldpc.decode.``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch import spans
from ldpcsimulation_tpu_torch.channel.awgn import (
    llr_from_channel,
    snr_to_n0,
)
from ldpcsimulation_tpu_torch.codes import (
    code_to_alist,
    load_named_code,
    stratify,
)
from ldpcsimulation_tpu_torch.codes.qc import qc_peg
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp,
    decode_bp_layered_qc,
    decode_bp_qc,
    decode_bp_stratified,
    decode_minsum,
    decode_minsum_qc,
)
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from tests.test_torch_spans import inside, traced
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

CODE = load_named_code("peg_96_48")
STRAT = stratify(code_to_alist(CODE))
QC = qc_peg(12, 6, 3, z=8, seed=1)
KINDS = ["qc", "slots", "stratified", "layered"]
#: decision merges a round: ``run_flooding_soft``'s one, and the layered
#: decoder's in ``run_flooding``'s loop
MERGES = {"qc": 1, "slots": 1, "stratified": 1, "layered": 1}
SNR = 3.5  # batches stop after different numbers of rounds; some frames fail
T = 6


def _decoder(kind):
    """``(decode(llr, key), code, check updates a round)`` of a BP decoder
    with early termination and f16 messages (the layered one has no
    storage type)."""
    f16 = dict(early_termination=True, storage_dtype=torch.float16)
    if kind == "qc":
        dec = lambda llr, key: decode_bp_qc(QC, llr, T, **f16)  # noqa: E731
        return dec, QC.to_code("cpu"), 1
    if kind == "slots":
        dec = lambda llr, key: decode_bp(CODE, llr, T, **f16)  # noqa: E731
        return dec, CODE, 1
    if kind == "stratified":
        dec = lambda llr, key: decode_bp_stratified(  # noqa: E731
            STRAT, llr, T, **f16)
        return dec, CODE, 1
    dec = lambda llr, key: decode_bp_layered_qc(  # noqa: E731
        QC, llr, T, early_termination=True)
    return dec, QC.to_code("cpu"), QC.mb


def _simulate(kind, rounds=None):
    """A BP ``simulate`` of three batches of 16 frames; ``rounds``, given,
    gets each batch's executed update rounds (its largest count)."""
    dec, code, _ = _decoder(kind)
    n0 = snr_to_n0(SNR, code.rate)

    def decode(llr, key):
        res = dec(llr, key)
        if rounds is not None:
            rounds.append(int(res.iterations.max()))
        return res

    return simulate(code, decode, SNR, stop=StopRule.fixed_frames(48),
                    batch_size=16, seed=13, device="cpu",
                    preprocess=lambda y: llr_from_channel(y, n0))


@pytest.mark.parametrize("kind", KINDS)
def test_one_check_span_per_round_inside_the_decode(kind):
    rounds = []
    per_round = _decoder(kind)[2]
    stats, got, _ = traced(lambda: _simulate(kind, rounds))
    decodes = [s for s in got if s[0] == spans.DECODE]
    checks = [s for s in got if s[0] == spans.BP_CHECK]
    assert len(decodes) == len(rounds) == 3
    assert len(set(rounds)) > 1 and min(rounds) < T  # the exit cuts rounds
    assert [sum(s[0] == spans.BP_CHECK for s in inside(d, got))
            for d in decodes] == [per_round * r for r in rounds]
    assert len(checks) == per_round * sum(rounds)
    # a check update holds no other span: the exit checks lie between them
    for c in checks:
        assert inside(c, got) == []
    assert [sum(s[0] == spans.ET_MERGE for s in inside(d, got))
            for d in decodes] == [MERGES[kind] * r for r in rounds]
    for m in (s for s in got if s[0] == spans.ET_MERGE):
        assert inside(m, got) == []
    assert stats.total_words == 48


@pytest.mark.parametrize("kind", KINDS)
def test_no_profiler_no_record_function(monkeypatch, kind):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function reached with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert spans.span(spans.BP_CHECK) is spans._NULL
    assert _simulate(kind).total_words == 48


@pytest.mark.parametrize("kind", KINDS)
def test_stats_do_not_depend_on_the_profiler(kind):
    plain = _simulate(kind)
    with_prof, got, _ = traced(lambda: _simulate(kind))
    assert any(s[0] == spans.BP_CHECK for s in got)
    assert any(s[0] == spans.ET_MERGE for s in got) == bool(MERGES[kind])
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
    assert 0 < plain.word_errors < plain.total_words


def test_the_name_is_listed_under_the_decoder():
    assert spans.BP_CHECK in spans.SPANS
    assert spans.BP_CHECK.startswith(spans.DECODE + ".")
    assert len(set(spans.SPANS)) == len(spans.SPANS)


def test_one_vn_span_per_round_in_the_qc_decode():
    """``decode_bp_qc`` opens ``ldpc.decode.bp_vn`` once per executed
    round inside the batch's ``ldpc.decode``, each after its round's check
    update and holding no other span."""
    rounds = []
    _, got, _ = traced(lambda: _simulate("qc", rounds))
    decodes = [s for s in got if s[0] == spans.DECODE]
    vns = [s for s in got if s[0] == spans.BP_VN]
    checks = [s for s in got if s[0] == spans.BP_CHECK]
    assert len(set(rounds)) > 1
    assert [sum(s[0] == spans.BP_VN for s in inside(d, got))
            for d in decodes] == rounds
    assert len(vns) == len(checks) == sum(rounds)
    for c, v in zip(checks, vns):
        assert c[2] <= v[1] and inside(v, got) == []


@pytest.mark.parametrize("kind", ["minsum_qc", "minsum_slots"])
def test_min_sum_decodes_open_no_bp_span(kind):
    """A min-sum decode opens neither BP span: its VN update is B5's."""
    if kind == "minsum_qc":
        code = QC.to_code("cpu")
        dec = lambda y, key: decode_minsum_qc(  # noqa: E731
            QC, y, T, early_termination=True, storage_dtype=torch.float16)
    else:
        code = CODE
        dec = lambda y, key: decode_minsum(CODE, y, T)  # noqa: E731
    stats, got, _ = traced(lambda: simulate(
        code, dec, SNR, stop=StopRule.fixed_frames(32), batch_size=16,
        seed=13, device="cpu"))
    assert sum(s[0] == spans.DECODE for s in got) == 2
    assert not [s for s in got if s[0] in (spans.BP_VN, spans.BP_CHECK)]
    assert stats.total_words == 32


def test_the_vn_name_is_listed_under_the_decoder():
    assert spans.BP_VN in spans.SPANS
    assert spans.BP_VN.startswith(spans.DECODE + ".")
    assert spans.BP_VN != spans.BP_CHECK
