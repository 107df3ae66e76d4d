"""The port's streaming refill harness against the JAX package's and against
the port's own batch decoders.

* Each binary adapter's recorded stream call equals the JAX package's
  ``make_stream_call(record=True)`` on the same numpy pool, over two calls
  (the second exhausting its pool): the retire-order records (gid,
  iterations, errors) entry by entry and every counter and histogram —
  sum-product BP by frame agreement, since XLA's and PyTorch's ``exp``/``log``
  differ by ulps.
* Each adapter's stream equals the port's batch decoder per frame (kernel
  B2's twin rows, decisions included).
* ``simulate_stream`` totals equal ``simulate``'s over the counted frame
  prefix; the drain outlasts a small call budget; ``pool_policy`` equals the
  JAX function; int64 frame ids pass 2^31; f16 pools; a normal call reads
  nothing back to the host.

JAX inputs are f32 arrays (``tests/conftest.py`` enables x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.harness import stream as jstream
from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    quantize_no_zero,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_code
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp,
    decode_bp_layered_qc,
    decode_bp_qc,
    decode_ddbmp,
    decode_ddbmp_qc,
    decode_minsum,
    decode_minsum_layered_qc,
    decode_minsum_qc,
)
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from ldpcsimulation_tpu_torch.harness import stream
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

QC_J = jqc_mod.qc_peg(8, 4, 3, z=16, seed=0)  # (128, 64)
QC = QCCode.from_reference(QC_J)
CODE = QC.to_code()
SNR, RATE = 2.5, 0.5
SIGMA = snr_to_sigma(SNR, RATE)
N0 = snr_to_n0(SNR, RATE)
T = 12
#: sum-product BP: share of frames whose (iterations, errors) must agree
BP_FRAME_AGREEMENT = 0.97
F16 = (jnp.float16, torch.float16)


def _llr(y):
    return llr_from_channel(y, N0)


def _quant(y):
    return quantize_no_zero(y, 1.5, 8.0)


#: adapter name -> (JAX adapter, port adapter, preprocess, code n, is BP)
def _adapters():
    peg = load_named_code("peg_96_48")
    jpeg = jlib.load_named_code("peg_96_48")
    return {
        "minsum_qc_f32": (jstream.minsum_qc_stream(QC_J),
                          stream.minsum_qc_stream(QC), None, QC.n, False),
        "minsum_qc_f16": (
            jstream.minsum_qc_stream(QC_J, storage_dtype=F16[0]),
            stream.minsum_qc_stream(QC, storage_dtype=F16[1]), None, QC.n,
            False),
        "minsum_slot_array": (
            jstream.minsum_stream(jpeg, variant="offset", delta=0.125),
            stream.minsum_stream(peg, variant="offset", delta=0.125), _quant,
            peg.n, False),
        "bp_qc": (jstream.bp_qc_stream(QC_J, storage_dtype=F16[0]),
                  stream.bp_qc_stream(QC, storage_dtype=F16[1]), _llr, QC.n,
                  True),
        "minsum_layered_plain": (
            jstream.minsum_layered_qc_stream(QC_J),
            stream.minsum_layered_qc_stream(QC), None, QC.n, False),
        "minsum_layered_offset": (
            jstream.minsum_layered_qc_stream(QC_J, variant="offset",
                                             delta=0.15,
                                             storage_dtype=F16[0]),
            stream.minsum_layered_qc_stream(QC, variant="offset", delta=0.15,
                                            storage_dtype=F16[1]),
            None, QC.n, False),
        "bp_layered": (jstream.bp_layered_qc_stream(QC_J),
                       stream.bp_layered_qc_stream(QC), _llr, QC.n, True),
        "ddbmp": (jstream.ddbmp_qc_stream(QC_J), stream.ddbmp_qc_stream(QC),
                  _quant, QC.n, False),
    }


ADAPTERS = _adapters()

ACC_KEYS = ("frames", "bit_errs", "word_errs", "iter_sum", "sat", "unc_sum",
            "consumed", "rc")


def numpy_pool(dec, jdec, seed, frames, n, pre, sigma=SIGMA):
    """(rows, unc, sat0) in numpy: y = 1 + σ·n from numpy's generator,
    mapped by ``pre``; sat0 from the port's adapter, checked against the
    JAX adapter's."""
    rng = np.random.default_rng(seed)
    y = (1.0 + sigma * rng.standard_normal((frames, n))).astype(np.float32)
    unc = (y <= 0).sum(axis=1).astype(np.int32)
    rows = y if pre is None else pre(torch.from_numpy(y)).numpy()
    rows_t = torch.from_numpy(rows)
    if dec.check_at_injection:
        sat0 = dec.satisfied(stream._sign8(dec.prep(rows_t))).numpy()
        jsat0 = np.asarray(jdec.satisfied(jstream._sign8(
            jdec.prep(jnp.asarray(rows)))))
        np.testing.assert_array_equal(sat0, jsat0)
    else:
        sat0 = np.zeros(frames, bool)
    return rows, unc, sat0


def drive_port(dec, n, pools, lanes, rounds, refill_every, rec_cap,
               dtype=torch.float32):
    """Run the port's recorded call over [(base, rows, unc, sat0)]; per call
    (acc as host values, rec as numpy)."""
    state = stream.stream_init(dec, lanes, n, dtype, device="cpu")
    call = stream.make_stream_call(dec, n, T, rounds, refill_every,
                                   record=True, rec_cap=rec_cap)
    out = []
    for base, rows, unc, sat0 in pools:
        state, acc, rec = call(state, torch.as_tensor(rows),
                               torch.as_tensor(unc), torch.as_tensor(sat0),
                               base)
        out.append((stream.fetch(acc), {k: v.numpy() for k, v in
                                        rec.items()}))
    return out


def drive_jax(jdec, n, pools, lanes, rounds, refill_every, rec_cap):
    state = jstream.stream_init(jdec, lanes, n)
    call = jstream.make_stream_call(jdec, n, T, rounds, refill_every,
                                    record=True, rec_cap=rec_cap)
    out = []
    for base, rows, unc, sat0 in pools:
        state, acc, rec = call(state, jnp.asarray(rows), jnp.asarray(unc),
                               jnp.asarray(sat0), jnp.int32(base))
        a, r = jax.device_get((acc, rec))
        out.append(({k: np.asarray(v) for k, v in a.items()},
                    {k: np.asarray(v) for k, v in r.items()}))
    return out


def _frames(calls):
    """{gid: (iters, errs)} over the calls' records, each gid once."""
    per = {}
    for a, r in calls:
        rc = int(a["rc"])
        for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
            assert int(g) >= 0 and int(g) not in per, "a frame retired twice"
            per[int(g)] = (int(it), int(er))
    return per


@pytest.mark.parametrize("name,refill_every", [
    ("minsum_qc_f32", 1), ("minsum_qc_f16", 2), ("minsum_slot_array", 1),
    ("bp_qc", 2), ("minsum_layered_plain", 1), ("minsum_layered_offset", 2),
    ("bp_layered", 1), ("ddbmp", 1), ("ddbmp", 3),
])
def test_recorded_call_equals_jax(name, refill_every):
    """Two calls: the first leaves frames in flight across the call
    boundary, the second exhausts its pool (idle lanes).  Records in retire
    order and every counter equal the JAX call's; BP by frame
    agreement."""
    jdec, dec, pre, n, is_bp = ADAPTERS[name]
    sigma = snr_to_sigma(3.9, RATE) if name == "ddbmp" else SIGMA
    lanes, rounds = 32, 10
    pools = [(0, *numpy_pool(dec, jdec, 3, 400, n, pre, sigma)),
             (400, *numpy_pool(dec, jdec, 4, 24, n, pre, sigma))]
    cap = 400 + lanes
    got = drive_port(dec, n, pools, lanes, rounds, refill_every, cap)
    want = drive_jax(jdec, n, pools, lanes, rounds, refill_every, cap)
    assert int(got[1][0]["consumed"]) == 24  # the second pool ran out
    assert int(got[0][0]["consumed"]) < 400
    if is_bp:
        per, jper = _frames(got), _frames(want)
        both = set(per) & set(jper)
        agree = (sum(per[g] == jper[g] for g in both)
                 / len(set(per) | set(jper)))
        assert len(both) >= 100 and agree >= BP_FRAME_AGREEMENT, agree
        return
    for (a, r), (ja, jr) in zip(got, want):
        for k in ACC_KEYS:
            assert int(a[k]) == int(ja[k]), k
        np.testing.assert_array_equal(a["iter_hist"], ja["iter_hist"])
        np.testing.assert_array_equal(a["weight_hist"], ja["weight_hist"])
        rc = int(a["rc"])
        assert rc > 0
        for k in ("gid", "iters", "errs"):
            np.testing.assert_array_equal(r[k][:rc], jr[k][:rc], err_msg=k)
    if name == "ddbmp":
        # the break index: channel-satisfied frames still run one round
        assert any(it == 0 for it, _ in _frames(got).values())


def _batch(name, rows):
    """The port's batch decoder of adapter ``name`` (early termination)."""
    et = dict(early_termination=True)
    return {
        "minsum_qc_f32": lambda: decode_minsum_qc(QC, rows, T, **et),
        "minsum_qc_f16": lambda: decode_minsum_qc(
            QC, rows, T, storage_dtype=torch.float16, **et),
        "minsum_slot_array": lambda: decode_minsum(
            load_named_code("peg_96_48"), rows, T, variant="offset",
            delta=0.125, **et),
        "bp_qc": lambda: decode_bp_qc(QC, rows, T,
                                      storage_dtype=torch.float16, **et),
        "bp_slot_array": lambda: decode_bp(load_named_code("peg_96_48"),
                                           rows, T, **et),
        "minsum_layered_plain": lambda: decode_minsum_layered_qc(
            QC, rows, T, **et),
        "minsum_layered_offset": lambda: decode_minsum_layered_qc(
            QC, rows, T, variant="offset", delta=0.15,
            storage_dtype=torch.float16, **et),
        "bp_layered": lambda: decode_bp_layered_qc(QC, rows, T, **et),
        "ddbmp": lambda: decode_ddbmp_qc(QC, rows, T),
        "ddbmp_slot_array": lambda: decode_ddbmp(
            load_named_code("peg_96_48"), rows, T),
    }[name]()


def _port_frames(calls):
    """{gid: (iters, errs, hard bytes)} over the port's records."""
    per = {}
    for a, r in calls:
        rc = int(a["rc"])
        for i in range(rc):
            g = int(r["gid"][i])
            assert g >= 0 and g not in per, "a frame retired twice"
            per[g] = (int(r["iters"][i]), int(r["errs"][i]),
                      r["hard"][i].tobytes())
    return per


@pytest.mark.parametrize("name,refill_every", [
    ("minsum_qc_f32", 3), ("minsum_qc_f16", 1), ("minsum_slot_array", 2),
    ("bp_qc", 1), ("bp_slot_array", 2), ("minsum_layered_plain", 2),
    ("minsum_layered_offset", 1), ("bp_layered", 2), ("ddbmp", 2),
    ("ddbmp_slot_array", 1),
])
def test_stream_equals_the_ports_batch_decoder(name, refill_every):
    """Per gid on kernel B2's twin rows: iterations, errors and every
    decision equal the batch decoder's (BP by frame agreement)."""
    if name == "bp_slot_array":
        dec, pre, n = stream.bp_stream(load_named_code("peg_96_48")), _llr, 96
    elif name == "ddbmp_slot_array":
        dec = stream.ddbmp_stream(load_named_code("peg_96_48"))
        pre, n = _quant, 96
    else:
        _, dec, pre, n, _ = ADAPTERS[name]
    sigma = snr_to_sigma(3.9, RATE) if "ddbmp" in name else SIGMA
    F, lanes = 160, 24
    rows, unc, sat0 = stream.build_channel_pool(dec, 11, 0, F, n, sigma, pre,
                                                device="cpu")
    calls = drive_port(dec, n, [(0, rows[:96], unc[:96], sat0[:96]),
                                (96, rows[96:], unc[96:], sat0[96:])],
                       lanes, 40, refill_every, F + lanes)
    per = _port_frames(calls)
    assert len(per) >= 120
    res = _batch(name, rows)
    hard = res.hard.to(torch.int8).numpy()
    ref = {g: (int(res.iterations[g]), int((hard[g] != 1).sum()),
               hard[g].tobytes()) for g in range(F)}
    same = sum(ref[g] == v for g, v in per.items()) / len(per)
    if name.startswith("bp"):
        assert same >= BP_FRAME_AGREEMENT, same
    else:
        assert same == 1.0, [(g, ref[g][:2], v[:2]) for g, v in per.items()
                             if ref[g] != v][:5]


def _prefix_totals(stats, decode_fn, pre, n_frames, seed, code=CODE):
    """``simulate``'s totals over frames 0 … n_frames−1 with a batch
    decoder, against the stream's."""
    b = simulate(code, lambda y, key: decode_fn(y), SNR, rate=RATE,
                 stop=StopRule.fixed_frames(n_frames), batch_size=n_frames,
                 seed=seed, preprocess=pre, device="cpu")
    assert b.total_words == stats.total_words
    for k in ("errors", "word_errors", "total_iterations", "uncoded_errors",
              "satisfied_words"):
        assert getattr(stats, k) == getattr(b, k), k
    np.testing.assert_array_equal(stats.error_weight_hist,
                                  b.error_weight_hist)
    hist = np.zeros(T + 1, np.int64)
    hist[:len(b.iteration_hist)] = b.iteration_hist
    np.testing.assert_array_equal(stats.iteration_hist, hist)


@pytest.mark.parametrize("name", ["minsum_qc_f16", "ddbmp"])
def test_pool_budget_totals_equal_the_prefix(name):
    """A tiny pool budget shrinks the calls, never the statistics: the
    totals equal ``simulate``'s with the batch decoder over the counted gid
    prefix (frames are consumed in gid order and the drain retires every
    injected frame)."""
    _, dec, pre, n, _ = ADAPTERS[name]
    stats = stream.simulate_stream(
        n, dec, SNR, RATE, T, stop=StopRule.fixed_frames(300), lanes=32,
        refill_every=1, seed=7, preprocess=pre, pool_bytes=n * 4 * 80,
        device="cpu")
    assert stats.total_words >= 300
    assert stats.iteration_hist.sum() == stats.total_words
    _prefix_totals(stats, lambda y: _batch(name, y), pre, stats.total_words,
                   7)


def test_drain_outlasts_single_call_budget():
    """At −20 dB nothing converges: every frame runs all T=20 iterations,
    far past a call's budget of 2, and the drain still counts every
    injected frame — the same population as with a large budget."""
    dec = stream.minsum_qc_stream(QC)
    kw = dict(stop=StopRule.fixed_frames(4), lanes=4, seed=2,
              refill_every=1, device="cpu")
    small = stream.simulate_stream(QC.n, dec, -20.0, RATE, 20,
                                   rounds_per_call=2, **kw)
    big = stream.simulate_stream(QC.n, dec, -20.0, RATE, 20,
                                 rounds_per_call=32, **kw)
    assert small.total_words == big.total_words >= 4
    assert small.errors == big.errors
    assert small.iteration_hist[20] == small.total_words


@pytest.mark.parametrize("lanes,refill,rounds,hint,row,budget", [
    (16384, 2, None, 2.86, 1008 * 2, None),
    (16384, 2, 96, 2.86, 1008 * 2, None),
    (4096, 1, None, 8.0, 1008 * 4, None),
    (64, 1, None, 1.0, 10**6, 1),
    (256, 1, None, 2.0, 1000, 2**20),
    (32768, 2, None, 9.9, 1008 * 2, None),
    (32768, 8, None, 73.4, 1008 * 4, 2**28),
    (1000, 3, 7, 0.5, 4000, 10**7),
])
def test_pool_policy_equals_jax(lanes, refill, rounds, hint, row, budget):
    got = stream.pool_policy(lanes, refill, rounds, hint, row, budget)
    assert got == jstream.pool_policy(lanes, refill, rounds, hint, row,
                                      budget)
    assert stream.DEFAULT_POOL_BYTES == jstream.DEFAULT_POOL_BYTES


def test_int64_frame_ids_past_2_31():
    """Frame ids are int64: a pool at base 2^31 + 5 holds the channel that
    ``simulate`` draws for those frames (kernel B2's twin), the records
    carry the ids, and each frame equals its batch decode."""
    base = 2**31 + 5
    dec = stream.minsum_qc_stream(QC)
    rows, unc, sat0 = stream.build_channel_pool(dec, 3, base, 96, QC.n,
                                                SIGMA, device="cpu")
    assert torch.equal(rows, awgn_all_zero(3, base, 96, QC.n, SIGMA, "cpu"))
    calls = drive_port(dec, QC.n, [(base, rows, unc, sat0)], 16, 60, 1, 112)
    per = _port_frames(calls)
    assert len(per) == 96 and min(per) == base and max(per) == base + 95
    res = decode_minsum_qc(QC, rows, T, early_termination=True)
    for g, (it, er, _h) in per.items():
        assert (it, er) == (int(res.iterations[g - base]),
                            int((res.hard[g - base] != 1).sum()))


def test_f16_pool_equals_the_batch_decode_of_its_rows():
    """An f16 pool's rows are the channel the decoder sees (upcast exactly
    at the step): the stream equals a batch decode of those rows."""
    dec = stream.minsum_layered_qc_stream(QC, storage_dtype=torch.float16)
    rows, unc, sat0 = stream.build_channel_pool(
        dec, 5, 0, 128, QC.n, SIGMA, pool_dtype=torch.float16, device="cpu")
    assert rows.dtype == torch.float16
    calls = drive_port(dec, QC.n, [(0, rows, unc, sat0)], 32, 40, 1, 160,
                       torch.float16)
    per = _port_frames(calls)
    assert len(per) >= 100
    res = decode_minsum_layered_qc(QC, rows.float(), T,
                                   early_termination=True,
                                   storage_dtype=torch.float16)
    for g, (it, er, _h) in per.items():
        assert (it, er) == (int(res.iterations[g]),
                            int((res.hard[g] != 1).sum()))


class _HostReads:
    """Counts the reads of tensor values back to the host (``bool``,
    ``item``, ``tolist``, ``cpu``, ``nonzero``) — on the card each is a
    sync."""

    NAMES = ("__bool__", "item", "tolist", "cpu", "nonzero")

    def __init__(self, monkeypatch):
        self.count = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **kw):
                self.count += 1
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("name", ["minsum_qc_f16", "bp_qc", "ddbmp",
                                  "minsum_layered_plain"])
def test_a_normal_call_reads_nothing_back(name, monkeypatch):
    """A normal call keeps the pool pointer, the counters and the records
    on the device (no host read); a drain call reads "all idle" once per
    round, and ``fetch`` reads the counters once."""
    _, dec, pre, n, _ = ADAPTERS[name]
    rows, unc, sat0 = stream.build_channel_pool(dec, 1, 0, 128, n, SIGMA,
                                                pre, device="cpu")
    state = stream.stream_init(dec, 16, n, device="cpu")
    call = stream.make_stream_call(dec, n, T, 6, 2, record=True, rec_cap=64)
    reads = _HostReads(monkeypatch)
    state, acc, _ = call(state, rows, unc, sat0, 0)
    assert reads.count == 0
    stream.fetch(acc)
    assert reads.count == 1
    reads.count = 0
    state, acc, _ = call(state, rows, unc, sat0, 0, rows.shape[0])
    assert 1 <= reads.count <= 5


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, the stream drivers raise unless the caller asks for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dec = stream.minsum_qc_stream(QC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.simulate_stream(QC.n, dec, SNR, RATE, T,
                               stop=StopRule.fixed_frames(8), lanes=8)
