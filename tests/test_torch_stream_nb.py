"""The non-binary FFT-QSPA stream against the JAX package's and against the
port's batch decoder.

* The port's recorded ``nb_qspa_stream`` call on one numpy pool (log-prior
  rows made by the JAX adapter's ``prep_raw``) agrees with the JAX
  ``make_stream_call(record=True)`` frame by frame (iterations and bit
  errors) on ≥ 97 % of frames: exp and log differ by ulps between XLA and
  PyTorch, as in BP.
* Every streamed frame equals the port's batch ``decode_nb_qspa`` of the
  same channel rows (kernel B2's twin): symbols, iterations and errors,
  bit for bit.  The ops are the same; on the CPU PyTorch's vectorized
  ``exp``/``log`` take a scalar path at a tensor's tail, so lanes, pools,
  batches and the code length (64 symbols) are multiples of 64 here (on
  the card no such tail exists, and ``chip_smoke.py`` holds whole runs).
* ``simulate_stream_nb`` counts the frame prefix 0 … total−1 with the
  batch decoder's totals; a normal call reads nothing back to the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import build_code as j_build_code
from ldpcsimulation_tpu.codes.construct import nb_regular as j_nb_regular
from ldpcsimulation_tpu.harness import stream as jstream
from ldpcsimulation_tpu_torch.channel import snr_to_n0
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.channel.nb import symbol_priors, symbols_to_bits
from ldpcsimulation_tpu_torch.codes import build_code, nb_regular
from ldpcsimulation_tpu_torch.decoders.nb_qspa import decode_nb_qspa
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness import stream
from tests.test_torch_stream import _HostReads
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FRAME_AGREEMENT = 0.97
T = 10
SEED = 9
#: (q, SNR dB): points where most frames check out within T, some not
POINTS = {4: 2.0, 8: 1.6, 16: 1.4}


def _codes(q):
    return (build_code(nb_regular(64, 32, 3, q, seed=2)),
            j_build_code(j_nb_regular(64, 32, 3, q, seed=2)))


def _n0(code, q):
    return float(snr_to_n0(POINTS[q], code.rate))


def _records(calls):
    """{gid: (iters, errs)} over (acc, rec) pairs of host arrays."""
    per = {}
    for a, r in calls:
        rc = int(a["rc"])
        for g, it, er in zip(r["gid"][:rc], r["iters"][:rc], r["errs"][:rc]):
            assert int(g) >= 0 and int(g) not in per, "a frame retired twice"
            per[int(g)] = (int(it), int(er))
    return per


@pytest.mark.parametrize("q,f16", [(4, False), (8, True), (16, False)])
def test_recorded_call_agrees_with_jax(q, f16):
    code, jcode = _codes(q)
    n0 = _n0(code, q)
    m = q.bit_length() - 1
    sdt = torch.float16 if f16 else None
    dec = stream.nb_qspa_stream(code, n0, q, sdt)
    jdec = jstream.nb_qspa_stream(jcode, n0, q, jnp.float16 if f16 else None)
    rng = np.random.default_rng(q)
    sigma = np.sqrt(n0 / 2.0)
    pools = []
    for base, frames in ((0, 192), (192, 32)):
        y = (1.0 + sigma * rng.standard_normal((frames, code.n * m))).astype(
            np.float32)
        rows = np.array(jdec.prep_raw(jnp.asarray(y)))
        d0 = dec.d_of(dec.prep(torch.from_numpy(rows)))
        sat0 = dec.satisfied(d0).numpy()
        jsat0 = np.asarray(jdec.satisfied(jdec.d_of(jdec.prep(
            jnp.asarray(rows)))))
        np.testing.assert_array_equal(sat0, jsat0)
        unc = (d0 != 0).sum(dim=0, dtype=torch.int32).numpy()
        pools.append((base, rows, unc, sat0))
    lanes, rounds, cap = 32, 24, 224 + 32
    state = stream.stream_init(dec, lanes, code.n * q, device="cpu")
    call = stream.make_stream_call(dec, code.n, T, rounds, 1, record=True,
                                   rec_cap=cap, max_weight=code.n * m)
    jstate = jstream.stream_init(jdec, lanes, code.n * q)
    jcall = jstream.make_stream_call(jdec, code.n, T, rounds, 1, record=True,
                                     rec_cap=cap, max_weight=code.n * m)
    got, want = [], []
    for base, rows, unc, sat0 in pools:
        state, acc, rec = call(state, torch.from_numpy(rows),
                               torch.from_numpy(unc), torch.from_numpy(sat0),
                               base)
        got.append((stream.fetch(acc), {k: v.numpy() for k, v in
                                        rec.items()}))
        jstate, jacc, jrec = jcall(jstate, jnp.asarray(rows),
                                   jnp.asarray(unc), jnp.asarray(sat0),
                                   jnp.int32(base))
        want.append(jax.device_get((jacc, jrec)))
    per, jper = _records(got), _records(want)
    both = set(per) & set(jper)
    agree = sum(per[g] == jper[g] for g in both) / len(set(per) | set(jper))
    assert len(both) >= 100 and agree >= FRAME_AGREEMENT, agree
    assert any(it < T for it, _ in per.values())
    assert any(er > 0 for _, er in per.values())
    a = got[0][0]
    assert a["weight2_hist"].sum() == a["word_errs"]
    assert (np.arange(code.n + 1) * a["weight2_hist"]).sum() == a["errs2"]


def _batch(code, q, n0, frames, sdt):
    """The batch decode of frames 0 … frames−1 (B2's twin rows)."""
    m = q.bit_length() - 1
    sigma = float(np.sqrt(n0 / 2.0))
    y = awgn_all_zero(SEED, 0, frames, code.n * m, sigma, "cpu")
    return decode_nb_qspa(code, symbol_priors(y.reshape(frames, code.n, m),
                                              n0, q), T, storage_dtype=sdt)


@pytest.mark.parametrize("q,f16,refill_every", [
    (4, False, 1), (8, True, 1), (8, False, 2), (16, True, 1)])
def test_stream_equals_the_ports_batch_decoder(q, f16, refill_every):
    code, _ = _codes(q)
    n0 = _n0(code, q)
    m = q.bit_length() - 1
    sdt = torch.float16 if f16 else None
    dec = stream.nb_qspa_stream(code, n0, q, sdt)
    frames, lanes = 192, 64
    sigma = float(np.sqrt(n0 / 2.0))
    rows, unc, sat0 = stream.build_channel_pool_nb(dec, SEED, 0, frames,
                                                   code.n, q, sigma, "cpu")
    state = stream.stream_init(dec, lanes, code.n * q, device="cpu")
    call = stream.make_stream_call(dec, code.n, T, 40 // refill_every,
                                   refill_every, record=True,
                                   rec_cap=frames + lanes,
                                   max_weight=code.n * m)
    state, acc, rec = call(state, rows, unc, sat0, 0)
    a = stream.fetch(acc)
    assert a["rc"] >= 128
    res = _batch(code, q, n0, frames, sdt)
    for i in range(a["rc"]):
        g = int(rec["gid"][i])
        sym = res.symbols[g]
        assert int(rec["iters"][i]) == int(res.iterations[g]), g
        assert torch.equal(rec["hard"][i], sym.to(torch.int8)), g
        assert int(rec["errs"][i]) == int(symbols_to_bits(sym, q).sum()), g
    # the pool's iteration-0 decisions: the priors' uncoded symbol errors
    y = awgn_all_zero(SEED, 0, frames, code.n * m, sigma, "cpu")
    pri = symbol_priors(y.reshape(frames, code.n, m), n0, q)
    assert int(unc.sum()) == int((pri.argmax(dim=-1) != 0).sum())


def test_simulate_stream_nb_totals_equal_the_batch_decoder():
    """The drain counts every injected frame once: the totals are the batch
    decoder's over the gid prefix (decoded here in batches of 64)."""
    q = 8
    code, _ = _codes(q)
    n0 = _n0(code, q)
    stats = stream.simulate_stream_nb(
        code, POINTS[q], T, stop=StopRule.fixed_frames(150), lanes=64,
        seed=SEED, pool_bytes=code.n * q * 4 * 128, device="cpu")
    assert stats.total_words >= 150
    f = stats.total_words
    res = _batch(code, q, n0, -(-f // 64) * 64, None)
    sym = res.symbols[:f]
    sym_errs = (sym != 0).sum(dim=1)
    assert stats.symbol_errors == int(sym_errs.sum())
    assert stats.bit_errors == int(symbols_to_bits(sym, q).sum())
    assert stats.word_errors == int((sym_errs > 0).sum())
    assert stats.total_iterations == int(res.iterations[:f].sum())
    assert stats.total_bits == f * code.n * 3
    assert stats.iteration_hist.sum() == f
    assert stats.symbol_weight_hist.sum() == stats.word_errors
    w = np.arange(1, len(stats.bit_weight_hist) + 1)
    assert (w * stats.bit_weight_hist).sum() == stats.bit_errors


def test_a_normal_call_reads_nothing_back(monkeypatch):
    q = 4
    code, _ = _codes(q)
    n0 = _n0(code, q)
    dec = stream.nb_qspa_stream(code, n0, q)
    pool = stream.build_channel_pool_nb(dec, SEED, 0, 128, code.n, q,
                                        float(np.sqrt(n0 / 2.0)), "cpu")
    state = stream.stream_init(dec, 64, code.n * q, device="cpu")
    call = stream.make_stream_call(dec, code.n, T, 4, 1, record=True,
                                   rec_cap=64)
    reads = _HostReads(monkeypatch)
    state, acc, _ = call(state, *pool, 0)
    assert reads.count == 0
    stream.fetch(acc)
    assert reads.count == 1


def test_simulate_stream_nb_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, _ = _codes(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.simulate_stream_nb(code, 2.0, T, stop=StopRule.fixed_frames(4))
