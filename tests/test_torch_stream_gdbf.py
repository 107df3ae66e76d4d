"""The port's GDBF streaming harness against the port's batch decoder.

The stream keys each lane's decoder noise by (run seed, frame id, local
step) through kernels B3/B4's per-lane instances (their plain twins here),
the keys ``decode_gdbf`` gives the same frame under ``simulate``'s
``NoiseKey``.  So every streamed frame equals its batch decode with no
injection: decisions, iterations, satisfied flag, attempted phases and
smoothing uses, for every preset family, at two refill cadences, across
call boundaries and idle lanes; and ``simulate_stream_gdbf``'s totals equal
``simulate``'s with ``decode_gdbf`` over the counted frame prefix.  (The
batch decoder equals the JAX package's on injected draws:
``tests/test_torch_gdbf.py``.)
"""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu_torch.channel import (
    quantize_round,
    saturate,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes import QCCode
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf, preset
from ldpcsimulation_tpu_torch.harness import StopRule, simulate
from ldpcsimulation_tpu_torch.harness import stream_gdbf as sg
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

QC = QCCode.from_reference(jqc_mod.qc_peg(8, 4, 3, z=16, seed=0))  # (128, 64)
CODE = QC.to_code()
SNR, RATE = 3.5, 0.5
SIGMA = snr_to_sigma(SNR, RATE)
SEED = 23


def _sat(y):
    return saturate(y, 2.5)


def _quant(y):
    # signed zeros: the channel decisions must come from the sign bit
    return quantize_round(saturate(y, 1.5), 1.5, 3)


#: preset family -> (config, preprocess)
FAMILIES = {
    "plain": (preset("GDBF", num_iterations=12, theta=-0.6), None),
    "smngdbf": (preset("SMNGDBF", num_iterations=16, theta=-0.7,
                       noise_scale=0.9, lam=0.98, alpha=0.8, window_size=10),
                _sat),
    "redecode": (preset("RSMNGDBF", num_iterations=8, theta=-0.7,
                        noise_scale=0.9, lam=0.98, alpha=0.8, window_size=6,
                        max_phases=3), _sat),
    "mode_switch": (preset("MGDBF", num_iterations=10, theta=-0.6,
                           t_switch=2), None),
    "sequential": (preset("SGDBF", num_iterations=10, theta=-0.6), None),
    "stochastic": (preset("StochasticNGDBF", num_iterations=10, theta=-0.6,
                          noise_scale=0.9, alpha=0.8), _sat),
    "uniform_noise": (preset("MNGDBF", num_iterations=10, theta=-0.7,
                             noise_scale=0.9, lam=0.98, alpha=0.8,
                             uniform_noise=True), None),
    "shaped_noise": (preset("MNGDBF", num_iterations=10, theta=-0.7,
                            noise_scale=0.9, lam=0.98, alpha=0.8,
                            noise_shaping=True), None),
    "quantized": (preset("SMGDBF", num_iterations=12, theta=-0.6,
                         window_size=16), _quant),
}


def _stream_frames(cfg, pools, lanes, rounds, refill_every, qc, dtype,
                   dense=None):
    """{gid: record} of a recorded stream over [(base, rows, unc, sat0)],
    with the counters checked against the records."""
    state = sg.gdbf_stream_init(CODE, cfg, lanes, dtype, device="cpu")
    call = sg.make_gdbf_stream_call(
        CODE, rounds, refill_every, qc=qc, dense=dense, record=True,
        rec_cap=max(len(p[1]) for p in pools) + lanes)
    per = {}
    total_steps = cfg.max_phases * cfg.num_iterations
    for base, rows, unc, sat0 in pools:
        state, acc, rec = call(state, rows, unc, sat0, base, SEED, SIGMA,
                               cfg)
        a = sg.fetch(acc)
        rc = a["rc"]
        r = {k: v[:rc] for k, v in rec.items()}
        for i in range(rc):
            g = int(r["gid"][i])
            assert g >= 0 and g not in per, "a frame retired twice"
            per[g] = (int(r["iters"][i]), bool(r["sat"][i]),
                      int(r["phases"][i]), int(r["smooth"][i]),
                      r["hard"][i].to(torch.int32))
        assert a["frames"] == rc
        assert a["iter_sum"] == int(r["iters"].sum())
        assert a["sat"] == int(r["sat"].sum())
        assert a["smooth_sum"] == int(r["smooth"].sum())
        assert a["bit_errs"] == int((r["hard"] != 1).sum())
        np.testing.assert_array_equal(
            a["iter_hist"], np.bincount(r["iters"].numpy(),
                                        minlength=total_steps + 1))
        np.testing.assert_array_equal(
            a["phase_hist"], np.bincount(r["phases"].numpy(),
                                         minlength=cfg.max_phases + 1))
    return per


def _check_frames(per, res, base=0):
    for g, (it, sat, ph, sm, hard) in per.items():
        i = g - base
        assert (it, sat, ph, sm) == (
            int(res.iterations[i]), bool(res.satisfied[i]),
            int(res.phases[i]), int(res.smoothing_used[i])), g
        assert torch.equal(hard, res.hard[i]), g


@pytest.mark.parametrize("refill_every", [1, 8])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streamed_frame_equals_its_batch_decode(family, refill_every):
    """Two pools (frames in flight across the call boundary, then an
    exhausted pool with idle lanes); every frame equals decode_gdbf of its
    row under the same noise key."""
    cfg, pre = FAMILIES[family]
    qc = QC if family in ("smngdbf", "redecode", "stochastic") else None
    F, lanes = 120, 24
    rows, unc, sat0 = sg.build_channel_pool_gdbf(CODE, SEED, 0, F, SIGMA,
                                                 pre, qc=qc, device="cpu")
    rounds = 80 // refill_every + 4
    per = _stream_frames(cfg, [(0, rows[:72], unc[:72], sat0[:72]),
                               (72, rows[72:], unc[72:], sat0[72:])],
                         lanes, rounds, refill_every, qc, torch.float32)
    assert len(per) >= 90
    res = decode_gdbf(CODE, rows, SIGMA, cfg, key=NoiseKey(SEED, 0), qc=qc)
    _check_frames(per, res)
    if family == "redecode":
        assert any(p[2] > 1 for p in per.values())
    if family == "quantized":
        assert bool((rows == 0).any())


def test_f16_pool_and_a_window_longer_than_a_phase():
    """f16 pool rows (upcast exactly at each iteration) equal the batch
    decode of those rows; with a smoothing window longer than a phase, a
    frame satisfied at injection counts its smoothing as the batch decoder
    does."""
    cfg = preset("SMNGDBF", num_iterations=6, theta=-0.7, noise_scale=0.9,
                 lam=0.98, alpha=0.8, window_size=64)
    rows, unc, sat0 = sg.build_channel_pool_gdbf(
        CODE, SEED, 0, 96, snr_to_sigma(5.0, RATE), _sat,
        pool_dtype=torch.float16, qc=QC, device="cpu")
    assert rows.dtype == torch.float16 and bool(sat0.any())
    per = _stream_frames(cfg, [(0, rows, unc, sat0)], 24, 60, 2, QC,
                         torch.float16)
    assert len(per) == 96
    res = decode_gdbf(CODE, rows.float(), SIGMA, cfg, key=NoiseKey(SEED, 0),
                      qc=QC)
    _check_frames(per, res)
    assert any(p[0] == 0 and p[3] == 1 for p in per.values())


@pytest.mark.parametrize("family,qc", [("smngdbf", QC), ("redecode", None),
                                       ("stochastic", QC)])
def test_simulate_stream_gdbf_totals_equal_simulate(family, qc):
    """Totals over the counted gid prefix equal ``simulate`` with
    ``decode_gdbf``: bit and word errors, iterations, satisfied frames,
    uncoded errors, the smoothing total and the phase histogram."""
    cfg, pre = FAMILIES[family]
    st = sg.simulate_stream_gdbf(
        CODE, cfg, SNR, stop=StopRule.fixed_frames(200), lanes=32,
        refill_every=8, seed=SEED, preprocess=pre, qc=qc,
        pool_bytes=CODE.n * 4 * 72, device="cpu")
    assert st.total_words >= 200
    b = simulate(CODE, lambda yq, key: decode_gdbf(CODE, yq, SIGMA, cfg,
                                                   key=key, qc=qc),
                 SNR, stop=StopRule.fixed_frames(st.total_words),
                 batch_size=st.total_words, seed=SEED, preprocess=pre,
                 device="cpu")
    for k in ("total_words", "errors", "word_errors", "total_iterations",
              "satisfied_words", "uncoded_errors"):
        assert getattr(st, k) == getattr(b, k), k
    np.testing.assert_array_equal(st.error_weight_hist, b.error_weight_hist)
    hist = np.zeros_like(st.iteration_hist)
    hist[:len(b.iteration_hist)] = b.iteration_hist
    np.testing.assert_array_equal(st.iteration_hist, hist)
    ph = np.zeros(cfg.max_phases, np.int64)
    ph[:len(b.extra["phase_hist"])] = b.extra["phase_hist"]
    np.testing.assert_array_equal(st.extra["phase_hist"], ph)
    if cfg.output_smoothing:
        assert st.extra["smoothing_used"] == b.extra["smoothing_used"]


def test_drain_retires_every_injected_frame():
    """A short call leaves frames in flight; drain calls (the pool
    pre-exhausted) consume nothing and retire each of them once."""
    cfg, pre = FAMILIES["smngdbf"]
    F, lanes = 72, 24
    state = sg.gdbf_stream_init(CODE, cfg, lanes, device="cpu")
    call = sg.make_gdbf_stream_call(CODE, 6, 1, record=True, rec_cap=F + 24)
    pool = sg.build_channel_pool_gdbf(CODE, SEED, 0, F, SIGMA, pre,
                                      device="cpu")
    state, acc, rec = call(state, *pool, 0, SEED, SIGMA, cfg)
    a = sg.fetch(acc)
    retired = set(rec["gid"][:a["rc"]].tolist())
    consumed = a["consumed"]
    assert consumed > len(retired)
    for _ in range(8):
        state, acc, rec = call(state, *pool, 0, SEED, SIGMA, cfg, F)
        a = sg.fetch(acc)
        assert a["consumed"] == 0
        got = set(rec["gid"][:a["rc"]].tolist())
        assert not got & retired
        retired |= got
        if bool(state["idle"].all()):
            break
    assert retired == set(range(consumed))


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sg.simulate_stream_gdbf(CODE, FAMILIES["plain"][0], SNR,
                                stop=StopRule.fixed_frames(8), lanes=8)
