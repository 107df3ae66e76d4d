"""The port's slot-mesh Monte-Carlo (``parallel/``) against the JAX
package's mesh engine and against the port's own single-device harness.

* Mesh shapes and errors; ``make_mesh()`` defaults to the card.
* The counters step: consistent totals, equal to a batch decode of the same
  frames, deterministic; codeword fixtures; the int32 guard; the smoothing
  counter; per-slot parameters equal to baked ones (NGDBFhw's derived
  integers equal to the JAX grid's traced f32 arithmetic).
* A point on one slot equals ``simulate`` over the same frames;
  ``simulate_grid`` cycles points over slots, each point equal to
  ``simulate``; ``simulate_distributed`` and ``simulate_nb_distributed``
  within 4 joint standard errors of the JAX drivers.
* 1×4, 2×2 and 4×1 gloo process decompositions of a 4-slot mesh give
  results equal to one process with 4 slots (``tests/
  torch_distributed_worker.py``).

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``.
"""

import json
import math
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders.ngdbf_hw import NGDBFHwConfig as JHwConfig
from ldpcsimulation_tpu.harness import StopRule as JStopRule
from ldpcsimulation_tpu.parallel import mesh as jmesh
from ldpcsimulation_tpu.parallel import montecarlo as jmc
from ldpcsimulation_tpu_torch.channel import snr_to_sigma
from ldpcsimulation_tpu_torch.channel.awgn import awgn_all_zero
from ldpcsimulation_tpu_torch.codes import load_named_code, nb_regular
from ldpcsimulation_tpu_torch.codes.code import build_code
from ldpcsimulation_tpu_torch.decoders import decode_minsum
from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf, preset
from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import NGDBFHwConfig
from ldpcsimulation_tpu_torch.harness import StopRule, simulate, simulate_nb
from ldpcsimulation_tpu_torch.parallel import mesh as pmesh
from ldpcsimulation_tpu_torch.parallel import montecarlo as pmc
from ldpcsimulation_tpu_torch.parallel.montecarlo import (
    simulate_distributed,
    simulate_grid,
)
from ldpcsimulation_tpu_torch.parallel.montecarlo_nb import (
    simulate_nb_distributed,
)
from tests import torch_distributed_worker as worker
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

CPU8 = ["cpu"] * 8
CODE = load_named_code("peg_96_48")
#: counters of a step, compared key by key
KEYS = ("errors", "uncoded_errors", "word_errors", "iteration_sum",
        "satisfied_words", "error_weight_hist", "iteration_hist")


def _decode(code=CODE, T=10):
    return lambda y, sigma, key: decode_minsum(code, y, T,
                                               early_termination=True)


def _batch_counters(sigma, frame0, batch, T=10, seed=0):
    """A direct batch decode of frames frame0 … frame0+batch−1: (errors,
    uncoded errors, word errors, iteration sum)."""
    y = awgn_all_zero(seed, frame0, batch, CODE.n, sigma, "cpu")
    res = _decode(T=T)(y, sigma, None)
    fe = (res.hard != 1).sum(dim=1)
    return (int(fe.sum()), int((y <= 0).sum()), int((fe > 0).sum()),
            int(res.iterations.sum()))


def _same_stats(a, b):
    for k in ("errors", "uncoded_errors", "word_errors", "total_words",
              "total_bits", "total_iterations", "satisfied_words"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.error_weight_hist, b.error_weight_hist)
    hist = np.zeros(len(a.iteration_hist), np.int64)
    hist[:len(b.iteration_hist)] = b.iteration_hist
    np.testing.assert_array_equal(a.iteration_hist, hist)


def _joint_se(port, ref, key):
    """|port − ref| in joint standard errors of a (value, se) pair each."""
    (a, sa), (b, sb) = port[key], ref[key]
    return abs(a - b) / math.hypot(sa, sb)


def _moments(stats):
    """(value, s.e.) of BER (per-frame errors) and FER."""
    f, n = stats.total_words, stats.n
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = math.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    fer_se = math.sqrt(stats.fer * (1 - stats.fer) / f)
    return dict(ber=(stats.ber, ber_se), fer=(stats.fer, fer_se))


def test_mesh_shapes(monkeypatch):
    mesh = pmesh.make_mesh(n_snr=2, devices=CPU8)
    assert mesh.shape == {"snr": 2, "data": 4} == jmesh.make_mesh(
        n_snr=2).shape
    assert len(mesh.local()) == 8 and mesh.home == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by n_snr=3"):
        pmesh.make_mesh(n_snr=3, devices=CPU8)
    with pytest.raises(ValueError):
        jmesh.make_mesh(n_snr=3)
    with pytest.raises(ValueError, match="one 'snr' slot"):
        mesh.data_slots()
    # the default mesh is the card's: without one it raises
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    # under torchrun, each local rank takes its own share of the host's
    # cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pmesh.make_mesh().slots == ((0, torch.device("cuda", 1)),
                                       (0, torch.device("cuda", 3)))


def test_init_distributed_raises_when_the_group_cannot_form():
    """A backend that cannot run here is an error, never a quiet switch to
    another backend or a single-process run."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises((RuntimeError, ValueError)):
        pmesh.init_distributed(backend="nccl",
                               init_method=f"tcp://localhost:{port}",
                               rank=0, world_size=1)
    assert not torch.distributed.is_initialized()


def test_counters_step():
    mesh = pmesh.make_mesh(n_snr=2, devices=CPU8)
    step = pmesh.make_counters_step(CODE, _decode(), mesh, sigmas=[0.8, 0.4],
                                    batch_per_device=8, max_iterations=10)
    out = step(0)
    assert step.batch_global == 32 and step.bits_global == 32 * CODE.n
    errs = out["errors"]
    assert errs[0] > errs[1]
    ewh = out["error_weight_hist"]
    assert ewh.sum(axis=1).tolist() == [32, 32]
    assert ((ewh[:, 1:] * np.arange(1, CODE.n + 1)).sum(axis=1).tolist()
            == errs.tolist())
    assert out["iteration_hist"].sum(axis=1).tolist() == [32, 32]
    # each point decodes its frames 0 … 31, as a batch decode of them
    for si, sigma in enumerate((0.8, 0.4)):
        assert _batch_counters(np.float32(sigma), 0, 32) == (
            int(out["errors"][si]), int(out["uncoded_errors"][si]),
            int(out["word_errors"][si]), int(out["iteration_sum"][si]))


def test_counters_step_deterministic():
    mesh = pmesh.make_mesh(n_snr=1, devices=["cpu"])
    step = pmesh.make_counters_step(CODE, _decode(), mesh, sigmas=[0.6],
                                    batch_per_device=16, max_iterations=10)
    o1, o2, o3 = step(3), step(3), step(4)
    for k in KEYS:
        np.testing.assert_array_equal(o1[k], o2[k])
    assert int(o3["uncoded_errors"][0]) != int(o1["uncoded_errors"][0])
    # a round takes the next B_global frames
    assert _batch_counters(np.float32(0.6), 16, 16, seed=3)[1] == int(
        step(3, 1)["uncoded_errors"][0])


def test_point_on_one_slot_equals_simulate():
    """``simulate_distributed`` on one slot is ``simulate`` with batch
    B_global over the same frames, every counter and histogram."""
    mesh = pmesh.make_mesh(n_snr=1, devices=["cpu"])
    (st,) = simulate_distributed(
        CODE, _decode(), [2.0], mesh, stop=StopRule.fixed_frames(96),
        batch_per_device=32, max_iterations=10, seed=5)
    ref = simulate(CODE, lambda y, key: _decode()(y, None, key), 2.0,
                   stop=StopRule.fixed_frames(96), batch_size=32, seed=5,
                   device="cpu")
    _same_stats(st, ref)


def test_simulate_distributed():
    """The JAX test's checks, then BER and FER within 4 joint s.e. of the
    JAX driver at 2.5 dB (8 devices there, 4 CPU slots here)."""
    mesh = pmesh.make_mesh(n_snr=2, devices=CPU8)
    stats = simulate_distributed(
        CODE, _decode(), snrs_db=[1.0, 4.0], mesh=mesh,
        stop=StopRule(min_bit_errors=30, min_word_errors=3, max_frames=4096),
        batch_per_device=32, max_iterations=10, seed=5)
    lo, hi = stats
    assert lo.ber > hi.ber
    assert lo.errors >= 30 or lo.total_words >= 4096
    for s in stats:
        assert s.total_bits == s.total_words * CODE.n
        assert (np.arange(1, CODE.n + 1) * s.error_weight_hist).sum() == (
            s.errors)
        assert s.iteration_hist.sum() == s.total_words

    jcode = jlib.load_named_code("peg_96_48")
    (jst,) = jmc.simulate_distributed(
        jcode, lambda y, sigma, key: jminsum.decode_minsum(
            jcode, y, 10, early_termination=True),
        [2.5], jmesh.make_mesh(n_snr=1), stop=JStopRule.fixed_frames(4096),
        batch_per_device=128, max_iterations=10, seed=0)
    (pst,) = simulate_distributed(
        CODE, _decode(), [2.5], pmesh.make_mesh(1, ["cpu"] * 4),
        stop=StopRule.fixed_frames(4096), batch_per_device=256,
        max_iterations=10, seed=0)
    assert pst.total_words == jst.total_words == 4096
    port, ref = _moments(pst), _moments(jst)
    for key in ("ber", "fer"):
        assert _joint_se(port, ref, key) < 4.0, (key, port, ref)


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_multiprocess_cluster_matches_single_process(tmp_path, nproc):
    """A real N-process gloo group over a 4-slot CPU mesh (4/N slots per
    rank): every rank's all-reduced counters, grid step, grid run and
    stream totals equal one process running the 4 slots."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "result.json")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(root, "tests",
                                          "torch_distributed_worker.py"),
             str(port), str(nproc), str(rank), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(nproc)
    ]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    local = json.loads(json.dumps(worker.run_cases(["cpu"] * worker.SLOTS)))
    assert local["counters"]["errors"][0] > 0
    for rank in range(nproc):
        with open(f"{out}.{rank}") as f:
            assert json.load(f) == local, f"rank {rank} of {nproc}"


def test_measure_scaling(monkeypatch):
    """Bits/s per device count over this rank's devices (here the CPU
    stands in for one card)."""
    monkeypatch.setattr(pmc, "local_cuda_devices",
                        lambda: [torch.device("cpu")])
    res = pmc.measure_scaling_efficiency(
        CODE, _decode(), snr_db=3.0, device_counts=[1], batch_per_device=16,
        max_iterations=10, repeats=2)
    assert set(res) == {1} and res[1] > 0
    with pytest.raises(ValueError, match="1 distinct"):
        pmc.measure_scaling_efficiency(
            CODE, _decode(), snr_db=3.0, device_counts=[2],
            batch_per_device=16)


def test_mesh_scaling_tool(monkeypatch, capsys):
    """The card tool's rows and its mesh check, with the CPU standing in
    for two cards."""
    from ldpcsimulation_tpu_torch.tools import mesh_scaling

    cpus = [torch.device("cpu")] * 2
    monkeypatch.setattr(mesh_scaling, "local_cuda_devices", lambda: cpus)
    monkeypatch.setattr(pmc, "local_cuda_devices", lambda: cpus)
    assert mesh_scaling.main(["--cards", "1,2", "--batch", "8",
                              "--repeats", "1"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["counters_equal"]
    assert [(r["decoder"], r["cards"]) for r in out["mesh_scaling"]] == [
        ("minsum", 1), ("minsum", 2), ("smngdbf", 1), ("smngdbf", 2)]
    assert all(r["bits_per_s"] > 0 for r in out["mesh_scaling"])


def test_counters_step_codeword_fixture():
    """A fixture cycles by frame index: an all-zero fixture equals the zero
    path, a nonzero one changes the channel input."""
    mesh = pmesh.make_mesh(n_snr=1, devices=["cpu"] * 2)

    def make(cw=None):
        return pmesh.make_counters_step(
            CODE, _decode(), mesh, sigmas=[0.6], batch_per_device=8,
            max_iterations=10, codewords=cw)

    a = make(np.zeros((3, CODE.n), np.uint8))(1, 5)
    b = make()(1, 5)
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])
    c = make(np.ones((3, CODE.n), np.uint8))(1, 5)
    assert int(c["uncoded_errors"][0]) != int(b["uncoded_errors"][0]) or (
        int(c["errors"][0]) != int(b["errors"][0]))


def test_counters_step_overflow_guard():
    """Per-step global bit counts beyond int32 are rejected, as in JAX."""
    mesh = pmesh.make_mesh(n_snr=1, devices=CPU8)
    with pytest.raises(ValueError, match="int32"):
        pmesh.make_counters_step(
            CODE, _decode(), mesh, sigmas=[0.6],
            batch_per_device=2**31 // (8 * CODE.n) + 1, max_iterations=10)


def test_simulate_distributed_smoothing_counter():
    """The GDBF smoothing counter reaches ``extra``, equal to
    ``simulate``'s over the same frames."""
    cfg = preset("SMNGDBF", num_iterations=20, theta=-0.8, noise_scale=0.9,
                 lam=0.98, alpha=0.9, window_size=8)
    sigma = float(np.float32(snr_to_sigma(2.0, CODE.rate)))

    def dec(y, sig, key):
        return decode_gdbf(CODE, y, sig, cfg, key=key)

    (st,) = simulate_distributed(
        CODE, dec, snrs_db=[2.0], mesh=pmesh.make_mesh(1, ["cpu"]),
        stop=StopRule(min_bit_errors=1, min_word_errors=1, max_frames=64),
        batch_per_device=8, max_iterations=20, seed=3)
    assert "smoothing_used" in st.extra
    ref = simulate(CODE, lambda y, key: dec(y, sigma, key), 2.0,
                   stop=StopRule.fixed_frames(st.total_words), batch_size=8,
                   seed=3, device="cpu")
    _same_stats(st, ref)
    assert st.extra["smoothing_used"] == ref.extra["smoothing_used"]


def test_grid_step_params_match_baked():
    """Per-slot decoder scalars give the counters of the same scalars
    baked into the decode (the correctness core of the grid)."""
    mesh = pmesh.make_mesh(n_snr=2, devices=CPU8)
    alphas = [1.0, 1.5]
    gstep = pmesh.make_grid_step(
        CODE, lambda y, sigma, key, point: decode_minsum(
            CODE, y, 8, variant="normalized", alpha=point["alpha"],
            early_termination=True),
        mesh, batch_per_device=8, max_iterations=8, param_names=("alpha",))
    out_g = gstep(11, [0.7, 0.7], {"alpha": alphas})
    for slot, alpha in enumerate(alphas):
        baked = pmesh.make_counters_step(
            CODE, lambda y, sigma, key, a=alpha: decode_minsum(
                CODE, y, 8, variant="normalized", alpha=a,
                early_termination=True),
            mesh, sigmas=[0.7, 0.7], batch_per_device=8, max_iterations=8)
        out_b = baked(11)
        for k in KEYS:
            np.testing.assert_array_equal(out_g[k][slot], out_b[k][slot],
                                          err_msg=f"slot {slot} key {k}")
    assert int(out_g["errors"][0]) != int(out_g["errors"][1])


@pytest.mark.parametrize("w,ymax,theta0", [
    (0.185, 1.625, -0.525), (0.2, 1.5, -0.6), (0.25, 2.0, -0.5),
    (0.15, 1.8, -0.45), (0.3, 1.625, -0.7), (0.1, 1.0, -0.525),
])
def test_ngdbfhw_grid_constants_match_jax_traced_f32(w, ymax, theta0):
    """NGDBFhw's derived integers (theta_int, smult: C ``round`` in double
    on the port's f32-rounded point values) equal the JAX grid's, which
    computes them from traced f32 scalars."""
    f32 = [float(np.float32(v)) for v in (w, ymax, theta0)]
    port = NGDBFHwConfig(w=f32[0], ymax=f32[1], theta0=f32[2])
    jcfg = JHwConfig(w=jnp.float32(w), ymax=jnp.float32(ymax),
                     theta0=jnp.float32(theta0))
    assert port.theta_int == int(jcfg.theta_int)
    assert port.smult == int(jcfg.smult)
    assert np.float32(port.lmax) == np.float32(jcfg.lmax)


def test_simulate_grid_cycles_points_over_slots():
    """6 points on 4 snr slots × 2 data slots: every point reaches its stop
    rule, totals are multiples of B_global, SNR dominates, and each point's
    counters equal ``simulate``'s over its frames 0 … total − 1."""
    mesh = pmesh.make_mesh(n_snr=4, devices=CPU8)
    points = [{"snr": s, "alpha": a} for s in (1.0, 4.0)
              for a in (1.0, 1.25, 1.5)]

    def dec(y, sigma, key, point):
        return decode_minsum(CODE, y, 8, variant="normalized",
                             alpha=point["alpha"], early_termination=True)

    stats = simulate_grid(
        CODE, dec, points, mesh, max_iterations=8,
        stop=StopRule(min_bit_errors=20, min_word_errors=2, max_frames=256),
        batch_per_device=16, seed=3, param_names=("alpha",))
    assert len(stats) == 6
    for s, p in zip(stats, points):
        assert s.total_words > 0 and s.total_words % 32 == 0
        assert (s.errors >= 20 and s.word_errors >= 2) or (
            s.total_words >= 256)
        assert (np.arange(1, CODE.n + 1) * s.error_weight_hist).sum() == (
            s.errors)
        assert s.iteration_hist.sum() == s.total_words
        alpha = float(np.float32(p["alpha"]))
        ref = simulate(
            CODE, lambda y, key: dec(y, None, key, {"alpha": alpha}),
            p["snr"], stop=StopRule.fixed_frames(s.total_words),
            batch_size=32, seed=3, device="cpu")
        _same_stats(s, ref)
    assert min(st.ber for st in stats[:3]) > max(st.ber for st in stats[3:])


def test_simulate_nb_distributed():
    """The NB driver equals ``simulate_nb`` over the same frames (two data
    slots of 64 frames: PyTorch's CPU exp/log are exact only on multiples
    of 64), and agrees with the JAX driver within 4 joint s.e."""
    from ldpcsimulation_tpu.codes.code import build_code as jbuild
    from ldpcsimulation_tpu.codes.construct import nb_regular as jnb
    from ldpcsimulation_tpu.parallel.montecarlo_nb import (
        simulate_nb_distributed as jsim,
    )

    code = build_code(nb_regular(48, 24, 3, q=8, seed=0))
    stop = StopRule.fixed_frames(512)
    (st,) = simulate_nb_distributed(code, [2.0], pmesh.make_mesh(
        1, ["cpu"] * 2), 8, stop=stop, batch_per_device=64, seed=1)
    ref = simulate_nb(code, 2.0, 8, stop=stop, batch_size=128, seed=1,
                      device="cpu")
    for k in ("symbol_errors", "bit_errors", "uncoded_symbol_errors",
              "word_errors", "total_words", "total_bits", "total_symbols",
              "total_iterations"):
        assert getattr(st, k) == getattr(ref, k), k
    with pytest.raises(ValueError, match="GF"):
        simulate_nb_distributed(load_named_code("peg_24_12"), [2.0],
                                pmesh.make_mesh(1, ["cpu"]), 8)

    jcode = jbuild(jnb(48, 24, 3, q=8, seed=0))
    (jst,) = jsim(jcode, [2.0], jmesh.make_mesh(n_snr=1), 8,
                  stop=JStopRule.fixed_frames(512), batch_per_device=64,
                  seed=0)
    f = st.total_words
    assert jst.total_words == f == 512
    # FER: binomial over frames; SER: the drivers keep no per-frame counts,
    # so its s.e. is bounded by sqrt(SER / frames) (X symbol errors in a
    # frame of n symbols: Var X <= n·E[X])
    fer_se = math.sqrt((st.fer * (1 - st.fer) + jst.fer * (1 - jst.fer))
                       / f)
    assert abs(st.fer - jst.fer) <= 4 * fer_se, (st.fer, jst.fer)
    ser_se = math.sqrt((st.ser + jst.ser) / f)
    assert abs(st.ser - jst.ser) <= 4 * ser_se, (st.ser, jst.ser)
