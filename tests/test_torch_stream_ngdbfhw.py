"""The port's NGDBFhw streaming harness against the port's batch decoder.

A lane injected when the shared ring counter is at ``g0`` decodes its frame
exactly as ``decode_ngdbf_hw`` does with ``qpointer0 = g0`` and the frame's
keyed ring: the stream draws each refilled lane's ring with B4's per-lane
entry on the ring's stream, the bits ``keyed_ring`` draws (the JAX package's
own criterion, ``tests/test_stream_ngdbfhw.py``, there with injected
rings).  Every recorded frame's least-error decisions, least errors, least
iterations and exit-satisfied flag equal the batch decode's, for one and
several phases, refill every 1, 4 and 16 steps, a refill cap below the lane
count, QC and generic graph operations; ``simulate_stream_ngdbfhw``'s
totals equal the batch decoder's over the counted frames; a normal call
reads nothing back to the host.  (The batch decoder equals the JAX
package's on injected rings: ``tests/test_torch_ngdbf_hw.py``.)
"""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu_torch.channel import snr_to_sigma
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.codes import QCCode, build_code, peg
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import (
    NGDBFHwConfig,
    decode_ngdbf_hw,
    keyed_ring,
    lane_rings,
)
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness import stream
from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
from tests.test_torch_stream import _HostReads
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

QC = QCCode.from_reference(jqc_mod.qc_peg(12, 6, 3, z=8, seed=3))  # (96, 48)
GRAPHS = {"qc": (QC.to_code(), QC), "generic": (build_code(peg(96, 48, 3,
                                                               seed=7)), None)}
SNR, RATE = 5.0, 0.75
SIGMA = snr_to_sigma(SNR, RATE)
SEED = 17
#: frames here: a quarter satisfied at injection, most of the rest checking
#: out within T, later phases rescuing some of the failures
SMALL = dict(num_iterations=16, w=0.25, ymax=1.5, noise_scale=0.9,
             theta0=-0.5, ring_len=200)
FIELDS = ("iters", "errs", "sat", "hard")


def _drive(code, qc, cfg, pools, lanes, rounds, k, cap=None, dense=None):
    """Records of a recorded stream over pools of the given frame counts,
    each at the gid its predecessors consumed up to, drained at the end, as
    {gid: {field: value}}; the counters checked against them."""
    rec_cap = sum(pools) + lanes
    state = sh.hw_stream_init(code, cfg, lanes, "cpu", record=True)
    call = sh.make_hw_stream_call(code, cfg, rounds, k, qc=qc, dense=dense,
                                  record=True, rec_cap=rec_cap,
                                  refill_cap=cap)
    per = {}

    def take(acc, rec):
        a = stream.fetch(acc)
        rc = a["rc"]
        r = {f: v[:rc] for f, v in rec.items()}
        assert a["frames"] == rc
        assert a["bit_errs"] == int(r["errs"].sum())
        assert a["iter_sum"] == int(r["iters"].sum())
        assert a["sat"] == int(r["sat"].sum())
        assert int(a["iter_hist"].sum()) == rc
        for i in range(rc):
            g = int(r["gid"][i])
            assert g >= 0 and g not in per, "a frame retired twice"
            per[g] = {f: r[f][i] for f in (*FIELDS, "qp0")}
        return a

    pool, base = None, 0
    for frames in pools:
        pool = sh.build_channel_pool_hw(code, SEED, base, frames, SIGMA, qc,
                                        dense, device="cpu")
        state, acc, rec = call(state, *pool, base, SEED, SIGMA)
        base += take(acc, rec)["consumed"]
    for _ in range(40):  # drain
        if bool(state["idle"].all()):
            break
        state, acc, rec = call(state, *pool, base, SEED, SIGMA,
                               pool[0].shape[0])
        take(acc, rec)
    assert bool(state["idle"].all())
    assert sorted(per) == list(range(base))
    return per


def _batch(code, qc, cfg, per, frames):
    """The batch decode of frames 0 … frames−1 with each recorded frame's
    ring offset (their keyed rings, nothing injected)."""
    qp0 = torch.zeros(frames, dtype=torch.int32)
    for g, r in per.items():
        qp0[g] = int(r["qp0"])
    y = awgn_all_zero(SEED, 0, frames, code.n, SIGMA, "cpu")
    return decode_ngdbf_hw(code, y, SIGMA, cfg, key=NoiseKey(SEED, 0),
                           qc=qc, qpointer0=qp0)


def _assert_frames_equal(per, res):
    for g, r in per.items():
        want = (int(res.iterations[g]), int(res.least_errors[g]),
                bool(res.satisfied[g]), res.hard[g].to(torch.int8))
        got = (int(r["iters"]), int(r["errs"]), bool(r["sat"]), r["hard"])
        assert got[:3] == want[:3], (g, got[:3], want[:3])
        assert torch.equal(got[3], want[3]), g


@pytest.mark.parametrize("graph", ["qc", "generic"])
@pytest.mark.parametrize("phases", [1, 2])
@pytest.mark.parametrize("refill_every", [1, 4, 16])
def test_streamed_frames_equal_the_batch_decode(graph, phases, refill_every):
    """Two pools (frames in flight across the call boundary), then the
    drain: every frame equals ``decode_ngdbf_hw`` with its recorded
    ``qpointer0``, and the offsets vary from frame to frame."""
    code, qc = GRAPHS[graph]
    cfg = NGDBFHwConfig(max_phases=phases, **SMALL)
    rounds = 96 // refill_every
    per = _drive(code, qc, cfg, [80, 40], 16, rounds, refill_every)
    assert len(per) >= 80
    res = _batch(code, qc, cfg, per, len(per))
    _assert_frames_equal(per, res)
    qp0 = {int(r["qp0"]) for r in per.values()}
    iters = [int(r["iters"]) for r in per.values()]
    assert len(qp0) >= 3 and 0 in iters and max(iters) > 1
    if phases == 2:
        # some frame checked out in its second phase only
        assert any(int(r["iters"]) > 0 and bool(r["sat"])
                   and int(r["errs"]) == 0 for r in per.values())


def test_three_phases_and_a_refill_cap():
    """At most 5 refills per boundary on 16 lanes (the others wait, idle):
    the frames still equal their batch decodes, three phases each."""
    code, qc = GRAPHS["qc"]
    cfg = NGDBFHwConfig(max_phases=3, **SMALL)
    per = _drive(code, qc, cfg, [96], 16, 30, 4, cap=5)
    assert len(per) >= 60
    _assert_frames_equal(per, _batch(code, qc, cfg, per, len(per)))
    assert sh.default_refill_cap(32768, 16, 48.5) == 21621
    assert sh.default_refill_cap(16, 16, 8.0) == 16


def test_simulate_stream_totals_equal_the_batch_decode():
    """``simulate_stream_ngdbfhw`` counts the frame prefix 0 … total−1, each
    as its batch decode at its ring offset: the totals equal those of the
    recorded stream of the same geometry and of the batch decode."""
    code, qc = GRAPHS["generic"]
    cfg = NGDBFHwConfig(**SMALL)
    kw = dict(lanes=16, refill_every=4, rounds_per_call=6, pool_frames=40)
    stats = sh.simulate_stream_ngdbfhw(
        code, cfg, SNR, rate=RATE, stop=StopRule.fixed_frames(100),
        seed=SEED, qc=qc, avg_iters_hint=16.0, device="cpu", **kw)
    # the same calls, recorded: pools of 40 frames at the consumed bases,
    # the default refill cap (8 of 16 lanes)
    state = sh.hw_stream_init(code, cfg, 16, "cpu", record=True)
    cap = sh.default_refill_cap(16, 4, 16.0)
    call = sh.make_hw_stream_call(code, cfg, 6, 4, qc=qc, record=True,
                                  rec_cap=56, refill_cap=cap)
    per, base, pool = {}, 0, None
    while len(per) < 100:
        pool = sh.build_channel_pool_hw(code, SEED, base, 40, SIGMA, qc,
                                        device="cpu")
        state, acc, rec = call(state, *pool, base, SEED, SIGMA)
        a = stream.fetch(acc)
        for i in range(a["rc"]):
            per[int(rec["gid"][i])] = {f: rec[f][i] for f in (*FIELDS, "qp0")}
        base += a["consumed"]
    while not bool(state["idle"].all()):
        state, acc, rec = call(state, *pool, base, SEED, SIGMA, 40)
        for i in range(stream.fetch(acc)["rc"]):
            per[int(rec["gid"][i])] = {f: rec[f][i] for f in (*FIELDS, "qp0")}
    assert sorted(per) == list(range(stats.total_words))
    res = _batch(code, qc, cfg, per, stats.total_words)
    _assert_frames_equal(per, res)
    errs = res.least_errors.long()
    assert stats.errors == int(errs.sum())
    assert stats.word_errors == int((errs > 0).sum())
    assert stats.total_iterations == int(res.iterations.sum())
    assert stats.satisfied_words == int(res.satisfied.sum())
    y = awgn_all_zero(SEED, 0, stats.total_words, code.n, SIGMA, "cpu")
    assert stats.uncoded_errors == int((y <= 0).sum())
    assert stats.iteration_hist.sum() == stats.total_words
    w = np.arange(1, code.n + 1)
    assert (w * stats.error_weight_hist).sum() == stats.errors


def test_a_normal_call_reads_nothing_back(monkeypatch):
    """The pool pointer, the counters and the records stay on the device and
    the shared ring position is a host integer: no host read in a normal
    call; a drain call reads "all idle" once per round."""
    code, qc = GRAPHS["qc"]
    cfg = NGDBFHwConfig(max_phases=2, **SMALL)
    pool = sh.build_channel_pool_hw(code, SEED, 0, 64, SIGMA, qc,
                                    device="cpu")
    state = sh.hw_stream_init(code, cfg, 16, "cpu", record=True)
    call = sh.make_hw_stream_call(code, cfg, 5, 4, qc=qc, record=True,
                                  rec_cap=80, refill_cap=8)
    reads = _HostReads(monkeypatch)
    state, acc, _ = call(state, *pool, 0, SEED, SIGMA)
    assert reads.count == 0
    stream.fetch(acc)
    assert reads.count == 1
    reads.count = 0
    state, acc, _ = call(state, *pool, 0, SEED, SIGMA, 64)
    assert 1 <= reads.count <= 5


@pytest.mark.parametrize("frame0", [0, 2**31 - 5, 2**33 + 3])
def test_lane_rings_equal_keyed_ring(frame0):
    """B4's per-lane twin on the ring's stream draws ``keyed_ring``'s bits
    on contiguous frame ids (past 2^31 too), and each column is its frame's
    whatever the order."""
    cfg = NGDBFHwConfig(ring_len=300)
    gid = frame0 + torch.arange(12)
    want = keyed_ring(cfg, SIGMA, NoiseKey(SEED, frame0), 12, "cpu")
    assert torch.equal(lane_rings(cfg, SIGMA, SEED, gid), want)
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(lane_rings(cfg, SIGMA, SEED, gid[perm]), want[:, perm])


def test_entry_points_default_to_the_card(monkeypatch):
    code, qc = GRAPHS["qc"]
    cfg = NGDBFHwConfig(**SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sh.simulate_stream_ngdbfhw(code, cfg, SNR,
                                   stop=StopRule.fixed_frames(8), lanes=8)
    call = sh.make_hw_stream_call(code, cfg, 2, 1, record=True, rec_cap=8)
    pool = sh.build_channel_pool_hw(code, SEED, 0, 8, SIGMA, device="cpu")
    with pytest.raises(ValueError, match="record=True"):
        call(sh.hw_stream_init(code, cfg, 4, "cpu"), *pool, 0, SEED, SIGMA)
