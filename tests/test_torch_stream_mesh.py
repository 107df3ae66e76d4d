"""The port's streams sharded over a mesh (``mesh=``): the binary stream,
the GDBF stream and the NGDBFhw stream on 2 and 4 CPU slots.

* Every frame a slot retires lies in that slot's gid window (``base +
  di·pool/nd`` onwards: gids never collide) and equals its batch decode —
  the batch decoder over the same keyed rows (GDBF: under the same noise
  key; NGDBFhw: at the frame's recorded ring offset).  The records'
  per-slot counts add up to the all-reduced counters.
* ``simulate_stream``, ``simulate_stream_gdbf`` and
  ``simulate_stream_ngdbfhw`` with ``mesh=`` give the same totals run after
  run, consistent with their histograms; the NGDBFhw slots' ring counters
  end equal.
* A normal mesh call reads nothing back to the host; lanes and pools must
  divide by the slot count.
"""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.codes import build_code, peg, qc_peg
from ldpcsimulation_tpu_torch.decoders import decode_ddbmp_qc
from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
from ldpcsimulation_tpu_torch.channel import quantize_no_zero
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf, preset
from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import (
    NGDBFHwConfig,
    decode_ngdbf_hw,
)
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness import stream
from ldpcsimulation_tpu_torch.harness import stream_gdbf as sg
from ldpcsimulation_tpu_torch.harness import stream_ngdbfhw as sh
from ldpcsimulation_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_stream import _HostReads
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

QC = qc_peg(8, 4, 3, z=16, seed=0)  # (128, 64)
CODE = QC.to_code()
SEED = 29
T = 12
SNR, RATE = 2.5, 0.5
SIGMA = snr_to_sigma(SNR, RATE)


def _mesh(nd):
    return make_mesh(n_snr=1, devices=["cpu"] * nd)


def _drive(nd, lanes, pool_frames, windows, init, make_call, pool_of,
           fields, rest=()):
    """Records of a recorded mesh stream over ``windows`` pool windows,
    drained, as {gid: {field: value}}; each gid checked against its slot's
    window and the counters against the records."""
    mesh = _mesh(nd)
    _, _, state = stream.mesh_setup(mesh, lanes, pool_frames, False,
                                    init)
    call = make_call(mesh)
    local = pool_frames // nd
    per = {}

    def take(acc, recs):
        a = stream.fetch(acc)
        assert a["rc"] == a["frames"] == sum(int(r["rc_local"])
                                             for r in recs)
        for di, r in enumerate(recs):
            for i in range(int(r["rc_local"])):
                g = int(r["gid"][i])
                assert g >= 0 and g not in per, "a frame retired twice"
                assert (g % pool_frames) // local == di, (g, di)
                per[g] = {f: r[f][i] for f in fields}

    base, pools = 0, None
    for _ in range(windows):
        pools = stream.mesh_pools(mesh, base, local, pool_of)
        state, acc, recs = call(state, *pools, base, *rest)
        take(acc, recs)
        base += pool_frames
    for _ in range(60):  # drain
        if stream._all_idle(state):
            break
        state, acc, recs = call(state, *pools, base, *rest, local)
        take(acc, recs)
    assert stream._all_idle(state)
    return per, state


def _quant(y):
    return quantize_no_zero(y, 1.5, 8.0)


BINARY = {
    "minsum_qc": (lambda: stream.minsum_qc_stream(QC), None,
                  lambda rows: decode_minsum_qc(QC, rows, T,
                                                early_termination=True)),
    "ddbmp_qc": (lambda: stream.ddbmp_qc_stream(QC), _quant,
                 lambda rows: decode_ddbmp_qc(QC, rows, T)),
}


@pytest.mark.parametrize("nd", [2, 4])
@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_mesh_frames_equal_the_batch_decode(name, nd):
    make_dec, pre, batch = BINARY[name]
    dec = make_dec()
    pool_frames, windows = 64, 2

    def pool_of(base, frames, dev):
        return stream.build_channel_pool(dec, SEED, base, frames, QC.n, SIGMA,
                                         pre, device=dev)

    per, _ = _drive(
        nd, 8 * nd, pool_frames, windows,
        lambda lanes, dev: stream.stream_init(dec, lanes, QC.n, device=dev),
        lambda mesh: stream.make_stream_call(
            dec, QC.n, T, 24, 2, record=True, rec_cap=pool_frames,
            mesh=mesh),
        pool_of, ("iters", "errs", "hard"))
    assert len(per) >= windows * pool_frames // 2
    rows, _, _ = stream.build_channel_pool(dec, SEED, 0,
                                           windows * pool_frames, QC.n,
                                           SIGMA, pre, device="cpu")
    res = batch(rows)
    for g, r in per.items():
        hard = res.hard[g].to(torch.int8)
        assert (int(r["iters"]), int(r["errs"])) == (
            int(res.iterations[g]), int((hard != 1).sum())), g
        assert torch.equal(r["hard"], hard), g


GDBF_CFG = preset("SMNGDBF", num_iterations=16, theta=-0.7, noise_scale=0.9,
                  lam=0.98, alpha=0.8, window_size=10)


def _sat(y):
    return saturate(y, 2.5)


@pytest.mark.parametrize("nd", [2, 4])
def test_gdbf_mesh_frames_equal_the_batch_decode(nd):
    """Each lane's noise is keyed by its own gid and step: a slot's frame
    equals ``decode_gdbf`` of its row under the run's noise key."""
    sigma = snr_to_sigma(3.5, RATE)
    pool_frames, windows = 48, 2

    def pool_of(base, frames, dev):
        return sg.build_channel_pool_gdbf(CODE, SEED, base, frames, sigma,
                                          _sat, qc=QC, device=dev)

    per, _ = _drive(
        nd, 6 * nd, pool_frames, windows,
        lambda lanes, dev: sg.gdbf_stream_init(CODE, GDBF_CFG, lanes,
                                               device=dev),
        lambda mesh: sg.make_gdbf_stream_call(
            CODE, 40, 1, qc=QC, record=True, rec_cap=pool_frames,
            mesh=mesh),
        pool_of, ("iters", "sat", "phases", "smooth", "hard"),
        rest=(SEED, sigma, GDBF_CFG))
    assert len(per) >= windows * pool_frames // 2
    rows, _, _ = sg.build_channel_pool_gdbf(CODE, SEED, 0,
                                            windows * pool_frames, sigma,
                                            _sat, qc=QC, device="cpu")
    res = decode_gdbf(CODE, rows, sigma, GDBF_CFG, key=NoiseKey(SEED, 0),
                      qc=QC)
    for g, r in per.items():
        assert (int(r["iters"]), bool(r["sat"]), int(r["phases"]),
                int(r["smooth"])) == (
            int(res.iterations[g]), bool(res.satisfied[g]),
            int(res.phases[g]), int(res.smoothing_used[g])), g
        assert torch.equal(r["hard"].to(torch.int32), res.hard[g]), g


HW_CODE = build_code(peg(96, 48, 3, seed=7))
HW_CFG = NGDBFHwConfig(num_iterations=16, w=0.25, ymax=1.5, noise_scale=0.9,
                       theta0=-0.5, ring_len=200, max_phases=2)
HW_SIGMA = snr_to_sigma(5.0, 0.75)


@pytest.mark.parametrize("nd", [2, 4])
def test_ngdbfhw_mesh_frames_equal_the_batch_decode(nd):
    """Every slot's frame equals ``decode_ngdbf_hw`` at its recorded ring
    offset (its keyed ring, nothing injected); the slots' shared ring
    counters end equal."""
    pool_frames, windows = 48, 2

    def pool_of(base, frames, dev):
        return sh.build_channel_pool_hw(HW_CODE, SEED, base, frames,
                                        HW_SIGMA, device=dev)

    per, state = _drive(
        nd, 8 * nd, pool_frames, windows,
        lambda lanes, dev: sh.hw_stream_init(HW_CODE, HW_CFG, lanes, dev,
                                             record=True),
        lambda mesh: sh.make_hw_stream_call(
            HW_CODE, HW_CFG, 24, 2, record=True, rec_cap=pool_frames,
            mesh=mesh),
        pool_of, ("iters", "errs", "sat", "qp0", "hard"),
        rest=(SEED, HW_SIGMA))
    assert len({st["gstep"] for st in state}) == 1
    frames = windows * pool_frames
    qp0 = torch.zeros(frames, dtype=torch.int32)
    for g, r in per.items():
        qp0[g] = int(r["qp0"])
    y = awgn_all_zero(SEED, 0, frames, HW_CODE.n, HW_SIGMA, "cpu")
    res = decode_ngdbf_hw(HW_CODE, y, HW_SIGMA, HW_CFG,
                          key=NoiseKey(SEED, 0), qpointer0=qp0)
    assert len(per) >= frames // 2 and len(set(qp0.tolist())) >= 3
    for g, r in per.items():
        assert (int(r["iters"]), int(r["errs"]), bool(r["sat"])) == (
            int(res.iterations[g]), int(res.least_errors[g]),
            bool(res.satisfied[g])), g
        assert torch.equal(r["hard"], res.hard[g].to(torch.int8)), g


def _totals(st):
    assert int(st.iteration_hist.sum()) == st.total_words
    assert (np.arange(1, len(st.error_weight_hist) + 1)
            * st.error_weight_hist).sum() == st.errors
    return (st.total_words, st.errors, st.word_errors, st.total_iterations,
            st.satisfied_words, st.uncoded_errors,
            st.iteration_hist.tolist())


@pytest.mark.parametrize("driver", ["binary", "gdbf", "ngdbfhw"])
def test_simulate_mesh_totals_are_deterministic(driver):
    """A mesh run gives the same totals run after run (every lane's frames
    and noise are keyed by gid), and covers its stop rule."""
    stop = StopRule.fixed_frames(96)

    def run():
        mesh = _mesh(2)
        if driver == "binary":
            return stream.simulate_stream(
                QC.n, stream.minsum_qc_stream(QC), SNR, RATE, T, stop=stop,
                lanes=16, refill_every=2, rounds_per_call=8, seed=SEED,
                mesh=mesh)
        if driver == "gdbf":
            return sg.simulate_stream_gdbf(
                CODE, GDBF_CFG, 3.5, rate=RATE, stop=stop, lanes=16,
                refill_every=2, rounds_per_call=8, seed=SEED,
                preprocess=_sat, qc=QC, mesh=mesh)
        return sh.simulate_stream_ngdbfhw(
            HW_CODE, HW_CFG, 5.0, rate=0.75, stop=stop, lanes=16,
            refill_every=2, rounds_per_call=8, seed=SEED, mesh=mesh)

    a, b = run(), run()
    assert a.total_words >= 96
    assert _totals(a) == _totals(b)
    if driver == "ngdbfhw":
        assert a.extra["steps"] == b.extra["steps"] > 0


def test_a_normal_mesh_call_reads_nothing_back(monkeypatch):
    dec = stream.minsum_qc_stream(QC)
    mesh = _mesh(2)
    _, _, state = stream.mesh_setup(
        mesh, 16, 64, False,
        lambda lanes, dev: stream.stream_init(dec, lanes, QC.n, device=dev))
    call = stream.make_stream_call(dec, QC.n, T, 6, 2, mesh=mesh)
    pools = stream.mesh_pools(
        mesh, 0, 32,
        lambda base, frames, dev: stream.build_channel_pool(
            dec, SEED, base, frames, QC.n, SIGMA, device=dev))
    reads = _HostReads(monkeypatch)
    state, acc, _ = call(state, *pools, 0)
    assert reads.count == 0
    stream.fetch(acc)
    assert reads.count == 1


def test_mesh_setup_validates_divisibility():
    init = lambda lanes, dev: lanes  # noqa: E731
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="divisible by the 'data' axis"):
        stream.mesh_setup(mesh, 30, 64, False, init)
    with pytest.raises(ValueError, match="divisible"):
        stream.mesh_setup(mesh, 32, 62, False, init)
    # a default pool rounds up to the slot count
    nd, pool, states = stream.mesh_setup(mesh, 32, 62, True, init)
    assert (nd, pool, list(states)) == (4, 64, [8, 8, 8, 8])
