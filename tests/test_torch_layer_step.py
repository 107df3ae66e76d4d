"""Kernel B11, one layer of row-layered min-sum (``csrc/minsum_layer_step.cu``),
on the CPU: the CUDA kernel runs only on the card (``chip_smoke.py`` holds
it to its twin there, bit for bit, and counts its launches), so here its
twin ``kernels/layered.py::minsum_layer_step_plain``, and
``qc_minsum_layered_step`` built on it, are pinned bit for bit (int views:
signed zeros and NaN count) to the step as it was before the kernel
(``tests/frozen_layered.py``): three variants, f16 and f32 storage, absent
edges, ±0.0, NaN, ±inf, messages past f16's range, an odd batch; the
layered decodes and the layered stream equal their runs on the frozen
step; pair layers keep the old body, chosen by structure; the route is
taken once a layer inside the layer's span; and the wrapper's refusals."""

import dataclasses

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch import spans
from ldpcsimulation_tpu_torch.codes import load_named_qc, qc_peg
from ldpcsimulation_tpu_torch.codes.qc import build_qc_code_edges
from ldpcsimulation_tpu_torch.decoders import (
    decode_minsum_layered_qc,
    layered_l0,
    minsum_layered,
    qc_minsum_layered_step,
    qc_plan,
)
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from ldpcsimulation_tpu_torch.harness.stream import (
    minsum_layered_qc_stream,
    simulate_stream,
)
from ldpcsimulation_tpu_torch.kernels import build
from ldpcsimulation_tpu_torch.kernels import layered as klayered
from ldpcsimulation_tpu_torch.kernels import minsum as kminsum
from tests import frozen_layered
from tests.test_torch_spans import inside, traced
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

F16, F32 = torch.float16, torch.float32

CODES = {
    "wifi_1944_972": lambda: load_named_qc("wifi_1944_972"),
    "qc_1008_504": lambda: load_named_qc("qc_1008_504"),
    "qc_peg_z8": lambda: qc_peg(12, 6, 3, z=8, seed=1),
    # no pair, two absent edges in one layer and one in another
    "absent_z5": lambda: build_qc_code_edges(
        [(0, 0, 1), (0, 1, 0), (0, 2, 2), (1, 0, 2), (1, 1, 3), (1, 2, 4)],
        5, 2, 3, minus_edges=((0, 1, 0, 2), (0, 1, 0, 4), (1, 2, 4, 1))),
    # layer 0 a pair (the old body), layer 1 an absent edge (B11)
    "pair_absent_z5": lambda: build_qc_code_edges(
        [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2), (1, 0, 2), (1, 1, 2),
         (1, 2, 4)], 5, 2, 3, minus_edges=((1, 2, 4, 1),)),
}

VARIANTS = [
    pytest.param("plain", {}, id="plain"),
    pytest.param("normalized", dict(alpha=1.25), id="normalized"),
    pytest.param("offset", dict(delta=0.15), id="offset"),
]


@pytest.fixture(scope="module")
def codes():
    return {name: make() for name, make in CODES.items()}


def _bits(x):
    return x.view(torch.int16 if x.dtype == F16 else torch.int32)


def _same_bits(got, want):
    return got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


def _hazards(rng, shape, scale):
    """scale·N(0, 1) with 3 % +0.0, 3 % −0.0, 0.5 % NaN, 0.5 % ±inf and
    1 % ±1e5 (past f16's 65504), every lane of column 0 −0.0."""
    x = scale * rng.normal(size=shape)
    u = rng.random(shape)
    x[u < 0.03] = 0.0
    x[u > 0.97] = -0.0
    x[(u > 0.5) & (u < 0.505)] = np.nan
    x[(u > 0.6) & (u < 0.6025)] = np.inf
    x[(u > 0.6025) & (u < 0.605)] = -np.inf
    x[(u > 0.7) & (u < 0.71)] = 1e5 * np.sign(rng.normal(size=shape))[
        (u > 0.7) & (u < 0.71)]
    x[:, 0] = -0.0
    return x


def _state(rng, qc, batch, sdt):
    """A posterior [N, B] f32 and per-layer stored messages in ``sdt`` with
    the hazards (+0.0 in the rows of absent edges, as the decoder keeps
    them); in lane 1 every posterior ±1e5 (outputs past f16's range), in
    lane 2 ±inf (infinite outputs, inf − inf posteriors), in lane 3 +0.0 or
    −1 over zero messages (zero minima under either sign product)."""
    signs = lambda: np.sign(rng.normal(size=qc.n))  # noqa: E731
    q = _hazards(rng, (qc.n, batch), 6.0)
    q[:, 1] = 1e5 * signs()
    q[:, 2] = np.inf * signs()
    q[:, 3] = np.minimum(signs(), 0.0)
    q = torch.from_numpy(q.astype(np.float32))
    L = []
    for lp in qc_plan(qc, "cpu").layers:
        m = _hazards(rng, (lp.dc * qc.z, batch), 3.0)
        m[:, 3] = 0.0
        m = torch.from_numpy(m.astype(np.float32))
        if lp.absent is not None:
            m.index_fill_(0, lp.absent, 0.0)
        L.append(m.to(sdt))
    return q, L


FORMS = [
    pytest.param("wifi_1944_972", 8, id="wifi_1944_972"),
    pytest.param("wifi_1944_972", 33, id="wifi_1944_972-odd"),
    pytest.param("qc_peg_z8", 24, id="qc_peg_z8"),
    pytest.param("absent_z5", 37, id="absent_z5"),
    pytest.param("pair_absent_z5", 16, id="pair_absent_z5"),
]


@pytest.mark.parametrize("name,batch", FORMS)
@pytest.mark.parametrize("sdt", [F16, F32])
@pytest.mark.parametrize("variant,kw", VARIANTS)
def test_twin_equals_the_frozen_layer(codes, name, batch, sdt, variant, kw):
    """Each pair-free layer on the twin gives the frozen layer's posterior
    (written in place) and new messages bit for bit, from the same state;
    NaN, signed zeros, infinities and the f16 clamp all reached; l_old is
    not written; nothing launched (the CPU takes the twin)."""
    qc = codes[name]
    q, L = _state(np.random.default_rng(28), qc, batch, sdt)
    layers = [(lp, l) for lp, l in zip(qc_plan(qc, "cpu").layers, L)
              if lp.pair_first is None]
    assert layers
    build.LAUNCHES.clear()
    seen = dict(nan=False, neg_zero=False, pos_zero=False, top=0.0)
    for lp, l_old in layers:
        keep = l_old.clone()
        q_want, q_got = q.clone(), q.clone()
        want = frozen_layered.layer(q_want, lp, l_old, variant, sdt=sdt, **kw)
        got = klayered.minsum_layer_step(q_got, l_old, lp, variant, sdt=sdt,
                                         **kw)
        assert _same_bits(got, want) and _same_bits(q_got, q_want)
        assert _same_bits(l_old, keep)
        if lp.absent is not None:  # +0.0 stored, the column untouched
            assert not got[lp.absent].any()
            assert not torch.signbit(got[lp.absent]).any()
            cols = lp.cols[lp.absent]
            assert _same_bits(q_got[cols], q[cols])
        zero = got == 0
        seen["nan"] |= bool(torch.isnan(q_got).any())
        seen["neg_zero"] |= bool((zero & torch.signbit(got)).any())
        seen["pos_zero"] |= bool((zero & ~torch.signbit(got)).any())
        seen["top"] = max(seen["top"], float(
            got[~torch.isnan(got)].float().abs().max()))
    assert seen["nan"] and seen["pos_zero"]
    # offset's zeros are +0.0 (a clamped or zero output); the others keep
    # the sign product's
    assert seen["neg_zero"] == (variant != "offset")
    assert seen["top"] == (65504.0 if sdt == F16 else float("inf"))
    assert not build.LAUNCHES


def _as_the_kernel(q, l_old, lp, variant, alpha, delta, sdt):
    """B11's arithmetic written out in torch as the kernel takes it: the
    extrinsics of the named slots, the scan on the magnitudes' bit
    patterns (``<=`` toward min1), a sign bit where ``!(x >= 0)``, the
    post-op on the two minima alone, each output p1 or p2 with the other
    slots' sign parity XORed in (offset: only where its post-op keeps the
    sign), ``q`` updated in place, +0.0 stored in absent slots."""
    z, dc = lp.slot_cols.shape
    b = q.shape[1]
    rows = torch.arange(z)
    a = torch.tensor(alpha, dtype=F32)
    d = torch.tensor(delta, dtype=F32)
    inf = 0x7F800000
    mag1 = torch.full((z, b), inf, dtype=torch.int64)
    mag2 = mag1.clone()
    idx = torch.full((z, b), -1, dtype=torch.int64)
    par = torch.zeros((z, b), dtype=torch.int64)
    xs, negs = [], []
    for t in range(dc):
        ok = (lp.slot_cols[:, t] >= 0)[:, None]
        col = lp.slot_cols[:, t].clamp(min=0).long()
        x = q[col] - l_old[t * z + rows].to(F32)
        mag = x.view(torch.int32).long() & 0x7FFFFFFF
        neg = (ok & ~(x >= 0)).long()
        idx = torch.where(ok & (mag <= mag1), t, idx)
        mag2 = torch.where(ok, torch.minimum(mag2, torch.maximum(mag1, mag)),
                           mag2)
        mag1 = torch.where(ok, torch.minimum(mag1, mag), mag1)
        par ^= neg
        xs.append(x)
        negs.append(neg)

    def post(bits):
        v = bits.to(torch.int32).view(F32)
        if variant == "normalized":
            return (v / a).view(torch.int32).long() & 0xFFFFFFFF, True
        if variant == "offset":
            m = v - d
            keep = (m > 0) & (v != 0)
            return torch.where(m > 0, m.view(torch.int32).long()
                               & 0xFFFFFFFF, 0), keep
        return bits, True

    (p1, s1), (p2, s2) = post(mag1), post(mag2)
    l_new = torch.zeros(l_old.shape, dtype=sdt)
    for t in range(dc):
        ok = (lp.slot_cols[:, t] >= 0)[:, None]
        at = idx == t
        keep = torch.where(at, s2, s1) if variant == "offset" else True
        sign = torch.where(torch.as_tensor(keep), (par ^ negs[t]) << 31, 0)
        bits = torch.where(at, p2, p1) ^ sign
        out = (bits & 0xFFFFFFFF).to(torch.uint32).view(torch.int32).view(F32)
        col = lp.slot_cols[:, t].clamp(min=0).long()
        qn = xs[t] + out
        q[col] = torch.where(ok, qn, q[col])
        if sdt == F16:
            out = torch.clamp(out, -65504.0, 65504.0)
        l_new[t * z + rows] = torch.where(ok, out, 0.0).to(sdt)
    return l_new


@pytest.mark.parametrize("name,batch", FORMS[:4])
@pytest.mark.parametrize("sdt", [F16, F32])
@pytest.mark.parametrize("variant,kw", VARIANTS)
def test_the_kernels_arithmetic_equals_the_twin(codes, name, batch, sdt,
                                                variant, kw):
    """The design written out (:func:`_as_the_kernel`) gives the twin's
    posterior and messages bit for bit on the hazardous states, NaN's
    payload aside: the CPU's vector and scalar loops give NaNs other bits
    (the card gives every NaN one pattern, and ``chip_smoke.py`` holds the
    kernel to the twin's bits there)."""
    qc = codes[name]
    q, L = _state(np.random.default_rng(44), qc, batch, sdt)
    kw = dict(dict(alpha=1.0, delta=0.0), **kw)
    for lp, l_old in zip(qc_plan(qc, "cpu").layers, L):
        q_want, q_got = q.clone(), q.clone()
        want = klayered.minsum_layer_step_plain(q_want, l_old, lp, variant,
                                                sdt=sdt, **kw)
        got = _as_the_kernel(q_got, l_old, lp, variant, sdt=sdt, **kw)
        assert _same_bits(got, want)
        nan = torch.isnan(q_want)
        assert torch.equal(torch.isnan(q_got), nan)
        assert _same_bits(q_got[~nan], q_want[~nan])


@pytest.mark.parametrize("name,batch,rounds", [
    pytest.param("wifi_1944_972", 8, 3, id="wifi_1944_972"),
    pytest.param("qc_1008_504", 5, 2, id="qc_1008_504-odd"),
    pytest.param("absent_z5", 12, 4, id="absent_z5"),
    pytest.param("pair_absent_z5", 12, 4, id="pair_absent_z5"),
])
@pytest.mark.parametrize("storage", [F16, None])
@pytest.mark.parametrize("variant,kw", VARIANTS)
def test_step_equals_the_frozen_step(codes, name, batch, rounds, storage,
                                     variant, kw):
    """``qc_minsum_layered_step`` (B11's route where a layer has no pair)
    equals the frozen step round after round from a hazardous state,
    posterior, total and every layer's messages; the state given is left
    unchanged."""
    qc = codes[name]
    q, L = _state(np.random.default_rng(5), qc, batch, storage or F32)
    state = want_state = (q, tuple(L))
    kept = (q.clone(), [l.clone() for l in L])
    step = qc_minsum_layered_step(qc, variant, storage_dtype=storage, **kw)
    frozen = frozen_layered.qc_minsum_layered_step(
        qc, variant, storage_dtype=storage, **kw)
    for r in range(rounds):
        state, total = step(state)
        want_state, want_total = frozen(want_state)
        assert _same_bits(total, want_total) and total is state[0]
        assert _same_bits(state[0], want_state[0]), r
        assert all(_same_bits(g, w) for g, w in zip(state[1], want_state[1]))
    assert _same_bits(q, kept[0])
    assert all(_same_bits(a, b) for a, b in zip(L, kept[1]))


def _quantized(rng, batch, n, sigma):
    """The all-(+1) word over AWGN on eight levels (ties in most checks)."""
    y = 1.0 + sigma * rng.normal(size=(batch, n))
    return torch.from_numpy(np.clip(np.round(y * 2.0) / 2.0, -2.0, 2.0)
                            .astype(np.float32))


def _on_both(monkeypatch, run):
    """``run()`` on the port's step, then on the frozen one in its
    place."""
    got = run()
    monkeypatch.setattr(minsum_layered, "qc_minsum_layered_step",
                        frozen_layered.qc_minsum_layered_step)
    want = run()
    monkeypatch.undo()
    return got, want


@pytest.mark.parametrize("name,batch,sigma,T", [
    pytest.param("wifi_1944_972", 32, 0.8414, 6, id="wifi_1944_972"),
    pytest.param("qc_peg_z8", 96, 0.7, 8, id="qc_peg_z8"),
    pytest.param("absent_z5", 96, 0.7, 8, id="absent_z5"),
    pytest.param("pair_absent_z5", 96, 0.7, 8, id="pair_absent_z5"),
])
@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("variant,kw,storage", [
    pytest.param("normalized", dict(alpha=1.25), F16, id="normalized-f16"),
    pytest.param("plain", {}, None, id="plain-f32"),
    pytest.param("offset", dict(delta=0.15), F16, id="offset-f16"),
])
def test_decode_equals_the_decode_on_the_frozen_step(
        monkeypatch, codes, name, batch, sigma, T, et, variant, kw, storage):
    """``decode_minsum_layered_qc`` with fixed T and with early
    termination: decisions, iterations and flags equal to the decode on
    the frozen step, on Gaussian and on quantized samples."""
    qc = codes[name]
    rng = np.random.default_rng(17)
    for y in (torch.from_numpy((1.0 + sigma * rng.normal(
            size=(batch, qc.n))).astype(np.float32)),
              _quantized(rng, batch, qc.n, sigma)):
        got, want = _on_both(monkeypatch, lambda: decode_minsum_layered_qc(
            qc, y, T, variant=variant, early_termination=et,
            storage_dtype=storage, **kw))
        for f in ("hard", "iterations", "satisfied"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("name", ["qc_peg_z8", "pair_absent_z5"])
def test_layered_stream_equals_its_run_on_the_frozen_step(monkeypatch, codes,
                                                          name):
    """A layered min-sum stream (normalized, f16 messages and pool, refill
    every round) counts the same errors, words and iterations as on the
    frozen step."""
    qc = codes[name]

    def run():
        return simulate_stream(
            qc.n, minsum_layered_qc_stream(qc, "normalized", alpha=1.25,
                                           storage_dtype=F16),
            2.5, 0.5, 8, stop=StopRule.fixed_frames(96), lanes=16, seed=11,
            pool_dtype=F16, device="cpu")

    got, want = _on_both(monkeypatch, run)
    for f in dataclasses.fields(got):
        if f.name == "wall_seconds":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b, f.name
    assert 0 < got.word_errors < got.total_words


class _Routes:
    """Counts the calls of B11's twin and of B1's twin (the CPU's stand-ins
    for their launches) by patching the names the wrapper and the body
    call."""

    def __init__(self, monkeypatch):
        self.b11 = self.b1 = 0
        b11, b1 = klayered.minsum_layer_step_plain, kminsum.minsum_cn_scan_plain

        def count_b11(*a, **kw):
            self.b11 += 1
            return b11(*a, **kw)

        def count_b1(*a, **kw):
            self.b1 += 1
            return b1(*a, **kw)

        # the wrapper's twin, and B1's twin as B1's wrapper calls it (the
        # twin's own scan keeps its reference)
        monkeypatch.setattr(klayered, "minsum_layer_step_plain", count_b11)
        monkeypatch.setattr(kminsum, "minsum_cn_scan_plain", count_b1)


@pytest.mark.parametrize("name,pairs", [
    pytest.param("wifi_1944_972", 0, id="wifi_1944_972"),
    pytest.param("absent_z5", 0, id="absent_z5"),
    pytest.param("pair_absent_z5", 1, id="pair_absent_z5"),
    pytest.param("dvbs2_1_2_qc", 8, id="dvbs2_1_2_qc"),
])
def test_the_route_follows_the_structure(monkeypatch, codes, name, pairs):
    """A round takes B11 once per layer without a pair and B1 once per pair
    layer, and on a pair-free code B1 never: the route is the layer's
    structure alone.  The pair layers' outputs equal the frozen step's
    (DVB-S2: the tied blocks beside the absent edge, one round at B=2)."""
    qc = codes[name] if name in codes else load_named_qc(name)
    plan = qc_plan(qc, "cpu")
    assert sum(lp.pair_first is not None for lp in plan.layers) == pairs
    batch = 2
    rng = np.random.default_rng(3)
    q = torch.from_numpy((1.0 + 0.8 * rng.normal(size=(qc.n, batch)))
                         .astype(np.float32))
    state = (q, layered_l0(qc, batch, F16, "cpu"))
    routes = _Routes(monkeypatch)
    step = qc_minsum_layered_step(qc, "offset", delta=0.15,
                                  storage_dtype=F16)
    got, _ = step(state)
    got, _ = step(got)
    assert (routes.b11, routes.b1) == (2 * (qc.mb - pairs), 2 * pairs)
    monkeypatch.undo()
    frozen = frozen_layered.qc_minsum_layered_step(qc, "offset", delta=0.15,
                                                   storage_dtype=F16)
    want, _ = frozen(frozen(state)[0])
    assert _same_bits(got[0], want[0])
    assert all(_same_bits(g, w) for g, w in zip(got[1], want[1]))


def test_one_route_call_a_layer_inside_its_span(monkeypatch, codes):
    """Under a CPU profiler an early-terminating layered ``simulate`` on a
    pair-free code opens ``ldpc.decode.layer`` Mb times per executed round
    inside each ``ldpc.decode``, holding no other span, and the route is
    taken exactly once a span: B11's twin Mb times a round, B1's never."""
    qc = codes["qc_peg_z8"]
    rounds = []

    def decode(y, key):
        res = decode_minsum_layered_qc(
            qc, y, 6, variant="normalized", alpha=1.25,
            early_termination=True, storage_dtype=F16)
        rounds.append(int(res.iterations.max()))
        return res

    routes = _Routes(monkeypatch)
    stats, got, _ = traced(lambda: simulate(
        qc.to_code("cpu"), decode, 3.0, stop=StopRule.fixed_frames(48),
        batch_size=16, seed=17, device="cpu"))
    assert stats.total_words == 48 and len(rounds) == 3
    decodes = [s for s in got if s[0] == spans.DECODE]
    layers = [s for s in got if s[0] == spans.LAYER_STEP]
    assert len(decodes) == 3
    assert [sum(s[0] == spans.LAYER_STEP for s in inside(d, got))
            for d in decodes] == [qc.mb * r for r in rounds]
    assert len(layers) == qc.mb * sum(rounds)
    assert all(inside(s, got) == [] for s in layers)
    assert (routes.b11, routes.b1) == (qc.mb * sum(rounds), 0)


# --------------------------------------------------- the wrapper's contract


def test_layer_plan_slot_cols(codes):
    """``LayerPlan.slot_cols`` is the column of each routing-table slot,
    −1 exactly where the slot is absent."""
    for name in ("wifi_1944_972", "absent_z5", "pair_absent_z5"):
        for lp in qc_plan(codes[name], "cpu").layers:
            assert lp.slot_cols.dtype == torch.int32
            assert lp.slot_cols.is_contiguous()
            named = lp.scan_rows >= 0
            assert torch.equal(lp.slot_cols < 0, ~named)
            assert torch.equal(lp.slot_cols[named].long(),
                               lp.cols[lp.scan_rows[named].long()])


def test_wrapper_refuses_by_name(codes):
    """A pair layer, more than 64 slots, a posterior other than f32,
    messages other than f16/f32 or not in the storage type, shapes that
    disagree, strided views, tensors on two devices and a device that is
    neither the CPU nor CUDA raise; the CPU runs the twin."""
    qc = codes["pair_absent_z5"]
    pair, single = qc_plan(qc, "cpu").layers
    q = torch.ones(qc.n, 8)
    l_old = torch.zeros(single.dc * qc.z, 8, dtype=F16)
    got = klayered.minsum_layer_step(q, l_old, single, sdt=F16)
    assert got.dtype == F16 and got.shape == l_old.shape
    with pytest.raises(ValueError, match="pair"):
        klayered.minsum_layer_step(q, torch.zeros(pair.dc * qc.z, 8), pair)
    wide = dataclasses.replace(
        single, slot_cols=torch.zeros((1, 65), dtype=torch.int32))
    with pytest.raises(ValueError, match="dc <= 64"):
        klayered.minsum_layer_step(torch.ones(qc.n, 8),
                                   torch.zeros(65, 8), wide)
    with pytest.raises(ValueError, match="dc <= 64"):
        klayered.layer_instance(65, q, l_old, l_old)
    for bad in (q.double(), q.half(), torch.ones(qc.n, 8, 1)):
        with pytest.raises(ValueError, match="q must be"):
            klayered.minsum_layer_step(bad, l_old, single, sdt=F16)
    for bad, sdt in ((l_old.bfloat16(), torch.bfloat16), (l_old, F32),
                     (l_old.float(), F16), (l_old.double(), torch.float64)):
        with pytest.raises(ValueError, match="f16 or f32"):
            klayered.minsum_layer_step(q, bad, single, sdt=sdt)
    with pytest.raises(ValueError, match="l_old must be"):
        klayered.minsum_layer_step(q, l_old[1:], single, sdt=F16)
    with pytest.raises(ValueError, match="contiguous"):
        klayered.minsum_layer_step(torch.ones(qc.n, 16)[:, ::2], l_old,
                                   single, sdt=F16)
    with pytest.raises(ValueError, match="variant"):
        klayered.minsum_layer_step(q, l_old, single, "bogus", sdt=F16)
    with pytest.raises(ValueError, match="l_old on meta"):
        klayered.minsum_layer_step(q, l_old.to("meta"), single, sdt=F16)
    with pytest.raises(ValueError, match="unsupported device"):
        klayered.minsum_layer_step(q.to("meta"), l_old.to("meta"), single,
                                   sdt=F16)


def test_layer_instance():
    """The cap is the smallest of 8/16/32/64 that holds dc; the lanes the
    widest under the cap's budget that the batch and the three planes'
    alignment allow."""
    def planes(batch, offset=0):
        q = torch.empty(64 * batch + offset)[offset:].view(64, batch)
        return q, torch.empty(16, batch, dtype=F16)

    q, l_old = planes(32)
    assert klayered.layer_instance(7, q, l_old, l_old) == (8, 4)
    assert klayered.layer_instance(8, q, l_old, l_old) == (8, 4)
    assert klayered.layer_instance(9, q, l_old, l_old) == (16, 2)
    assert klayered.layer_instance(17, q, l_old, l_old) == (32, 1)
    assert klayered.layer_instance(64, q, l_old, l_old) == (64, 1)
    q, l_old = planes(33)
    assert klayered.layer_instance(7, q, l_old, l_old) == (8, 1)
    q, l_old = planes(34)
    assert klayered.layer_instance(7, q, l_old, l_old) == (8, 2)
    q, _ = planes(32, offset=2)  # 8-byte aligned
    assert klayered.layer_instance(7, q, l_old[:, :32], l_old[:, :32]) == (
        8, 2)


def test_the_library_builds_the_kernel():
    """The build compiles B11's source, whose C entry the wrapper binds,
    without fast math and with B1's lane header as it is."""
    assert "minsum_layer_step.cu" in build.SOURCES
    assert "minsum_cn_scan.cu" in build.SOURCES
    src = (build.CSRC / "minsum_layer_step.cu").read_text()
    assert 'extern "C" int ldpc_minsum_layer_step(' in src
    assert '#include "lanes.cuh"' in src
    for op in ("__fsub_rn(", "__fadd_rn(", "__fdiv_rn("):
        assert op in src
    assert "fast_math" not in " ".join(build.NVCC_FLAGS)
