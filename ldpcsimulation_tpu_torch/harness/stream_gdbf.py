"""Streaming refill harness for the GDBF/NGDBF bit-flip family.

Port of ``ldpcsimulation_tpu.harness.stream_gdbf``: :mod:`.stream`'s
persistent lanes (retire the frames that checked out or capped into device
counters, refill from the keyed channel pool) for decoders that draw noise
every iteration.  The family pays the straggler tax worst: its caps are the
largest (T=300 on the SMNGDBF path, ``max_phases``·T with redecode), while
the frames that converge take tens of iterations.

Noise keying.  Lane b holds frame ``gid[b]`` at its own local step
``steps[b]``; its perturbation at that step is drawn by kernel B4's
per-lane instance (:func:`..kernels.channel.gauss_philox_lanes`, or B3's
with ``uniform_noise``) and its stochastic-flip uniforms by B3's, keyed by
(run seed, gid, step) — the keys the batched
:func:`..decoders.gdbf.decode_gdbf` gives that frame at that step under
``simulate``'s :class:`..decoders.base.NoiseKey`.  So a streamed frame
equals its batch decode with no injection, and the JAX package's
``frame_perturbation_sequence`` / ``frame_stoch_uniforms`` have no
counterpart here (:func:`..decoders.gdbf.keyed_draws` gives a frame's
draws).

The decoder's rules, per lane (:mod:`..decoders.gdbf` cites the
reference): the syndrome is checked at the start of each iteration, so a
frame satisfied at injection reports 0 iterations; capped frames report
``max_phases``·T, unsatisfied; output smoothing replaces the decisions by
``sign(Σd)`` only for frames that end unsatisfied; a redecode phase resets
``d``, θ, ``dsum`` and μ from the channel decisions while the shaping
state ``noise_prev`` carries across phases.

``mesh=`` shards the lanes and the pool over a mesh's data slots as
:func:`.stream.simulate_stream` does; each lane's noise is still keyed by
its own gid and step, so the slots' disjoint gid windows keep every draw
the one its batch decode makes.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_sigma
from ..codes.code import Code
from ..codes.qc import QCCode
from ..decoders.dense_ops import (
    DenseGraph,
    dense_syndrome_bipolar,
    dense_syndrome_sum_per_vn,
    graphs_by_device,
)
from ..decoders.gdbf import GDBFConfig, _f32, flip_decisions
from ..decoders.qc_ops import (
    qc_graph,
    slot_graph,
    syndrome_bipolar,
    syndrome_sum_per_vn,
)
from ..kernels.channel import gauss_philox_lanes, uniform_philox_lanes
from .montecarlo import MCStats, StopRule, default_min_word_errors
from .stream import (
    _count,
    _record_slots,
    _refill_plan,
    _zeros,
    fetch,
    mesh_pools,
    mesh_setup,
    next_base,
    pool_policy,
    run_drain,
    shard_call,
    slot_mesh,
)

__all__ = [
    "gdbf_stream_init",
    "build_channel_pool_gdbf",
    "make_gdbf_stream_call",
    "simulate_stream_gdbf",
]

#: the last step a lane may draw at: ``noise_stream``'s limit
_MAX_STEPS = (1 << 31) - 2


def _r_of(y_t):
    """Channel decisions from the sign bit (the quantizers emit signed
    zeros; a ``y > 0`` test would misread −0.0), int32 ±1."""
    return torch.where(torch.signbit(y_t), -1, 1).to(torch.int32)


def _graph_ops(code: Code, qc: Optional[QCCode],
               dense: Optional[DenseGraph], device):
    """(syndrome, neighbour sum), the graph operations on ``device``: row
    gathers on the QC tables, else matrix products on the dense H, else
    row gathers on the slot arrays (the same syndromes and sums, exactly).
    """
    if qc is not None:
        if qc.n != code.n or qc.m != code.m:
            raise ValueError("qc structure does not match code dimensions")
        g = qc_graph(qc, device)
    elif dense is not None:
        if dense.n != code.n or dense.m != code.m:
            raise ValueError("dense graph does not match code dimensions")
        return (functools.partial(dense_syndrome_bipolar, dense),
                functools.partial(dense_syndrome_sum_per_vn, dense))
    else:
        g = slot_graph(code, device)
    return (functools.partial(syndrome_bipolar, g),
            functools.partial(syndrome_sum_per_vn, g))


def gdbf_stream_init(code: Code, cfg: GDBFConfig, lanes: int,
                     dtype=torch.float32, device="cuda"):
    """All-idle lane state (the first boundary fills every lane); ``dtype``
    is the pool rows' type (the carried channel term is upcast exactly at
    each iteration)."""
    device = torch.device(device)
    n = code.n
    total_steps = cfg.max_phases * cfg.num_iterations

    def lane(fill, dt=torch.int32):
        return torch.full((lanes,), fill, dtype=dt, device=device)

    st = dict(
        ych=torch.zeros((n, lanes), dtype=dtype, device=device),
        d=torch.ones((n, lanes), dtype=torch.int32, device=device),
        thetas=torch.zeros((n, lanes), dtype=torch.float32, device=device),
        mu=lane(0),
        steps=lane(0),
        its=lane(total_steps),
        phases=lane(cfg.max_phases),
        done=lane(True, torch.bool),
        idle=lane(True, torch.bool),
        unc=lane(0),
        gid=lane(-1, torch.int64),
        smooth_used=lane(0),
    )
    if cfg.output_smoothing:
        st["dsum"] = torch.zeros((n, lanes), dtype=torch.int32,
                                 device=device)
    if cfg.add_noise and cfg.noise_shaping:
        st["noise_prev"] = torch.zeros((n, lanes), dtype=torch.float32,
                                       device=device)
    return st


def build_channel_pool_gdbf(code: Code, seed: int, base: int,
                            pool_frames: int, sigma: float, preprocess=None,
                            pool_dtype=None, qc: Optional[QCCode] = None,
                            dense: Optional[DenseGraph] = None,
                            device="cuda"):
    """Pool rows ``[F, N]`` of frames base … base+F−1 with ``unc`` and
    ``sat0``, as :func:`.stream.build_channel_pool` (kernel B2 keyed by
    (seed, frame); ``preprocess`` is the variant's saturate/quantize
    chain).  ``sat0`` is the syndrome of each row's channel decisions (the
    sign-bit form), so a frame satisfied at injection retires with 0
    iterations and the channel decisions."""
    y = awgn_all_zero(seed, base, pool_frames, code.n, sigma, device)
    unc = (y <= 0).sum(dim=1).to(torch.int32)
    rows = preprocess(y) if preprocess is not None else y
    if pool_dtype is not None:
        rows = rows.to(pool_dtype)
    d0 = _r_of(rows.float().t())  # [N, F]
    syndrome, _ = _graph_ops(code, qc, dense, d0.device)
    syn = syndrome(d0)
    return rows, unc, (syn > 0).all(dim=0)


def make_gdbf_stream_call(code: Code, rounds: int, refill_every: int = 1,
                          qc: Optional[QCCode] = None,
                          dense: Optional[DenseGraph] = None,
                          record: bool = False, rec_cap: int = 0, mesh=None):
    """The persistent-state call of the GDBF family.

    ``call(state, pool, pool_unc, pool_sat0, base, seed, sigma, cfg,
    ptr0=0) -> (state', acc, rec)``: :func:`.stream.make_stream_call`'s
    call, with the decoder noise keyed by (``seed``, gid, step) — the run
    seed of the channel, on the decoder streams of
    :func:`..kernels.channel.noise_stream` — and ``sigma``/``cfg`` given
    per call.  ``qc``: the QC structure of the same code (row-gather graph
    operations); else ``dense``, its :class:`..decoders.dense_ops.DenseGraph`
    (matrix products); else the slot arrays' row gathers.

    acc adds the family's counters: ``smooth_sum`` (the reference's
    smoothingUsed) and ``phase_hist`` [max_phases + 1] (attempted phases
    per retired frame).  With ``record``, rec holds (gid, iters, errs,
    phases, sat, smooth, hard) per retired frame in retire order.
    ``mesh``: the call sharded over the mesh's data slots
    (:func:`.stream.shard_call`).
    """
    n = code.n
    K = refill_every
    f32 = torch.float32
    vn_deg = {}  # the code's VN degrees on each device, copied once
    dense_on = graphs_by_device(dense, code)  # H on each slot's device

    def derived(sigma, cfg, device):
        """The call's constants: (cfg, T, total_steps, ns, noise_sigma, w,
        theta0, lam, mu0, c_uniform).  Device scalars are fills, not host
        copies."""
        T = cfg.num_iterations
        total_steps = cfg.max_phases * T
        if total_steps > _MAX_STEPS:
            raise ValueError(f"{total_steps} steps: past the noise streams")
        ns = _f32(sigma * cfg.noise_scale)
        noise_sigma = torch.full((), ns, dtype=f32, device=device)
        if cfg.weight_syndromes and cfg.legacy_weight:
            if device not in vn_deg:
                vn_deg[device] = code.vn_deg.to(device=device, dtype=f32)
            w = (torch.full((), cfg.alpha * cfg.weight_ymax, dtype=f32,
                            device=device) / vn_deg[device])[:, None]
        else:
            w = _f32(cfg.alpha if cfg.weight_syndromes else 1.0)
        # ((√3·σ')·2)·(u − 0.5), as decode_gdbf's uniform perturbation
        c_uniform = 2.0 * _f32(np.float32(np.sqrt(3.0)) * np.float32(ns))
        return (cfg, T, total_steps, ns, noise_sigma, w, _f32(cfg.theta),
                _f32(cfg.lam), 0 if cfg.sequential else 1, c_uniform)

    def report_d(st, cfg):
        """Decisions at retire: smoothing gives sign(Σd) to frames that end
        unsatisfied; a frame with 0 iterations keeps the channel's."""
        d = st["d"]
        if cfg.output_smoothing:
            d_sm = torch.where(st["dsum"] > 0, 1, -1).to(torch.int32)
            d = torch.where(st["done"], d, d_sm)
        return d

    def iterate(st, ops, seed, C):
        (cfg, T, total_steps, ns, noise_sigma, w, theta0, lam, mu0,
         c_uniform) = C
        d, thetas, mu = st["d"], st["thetas"], st["mu"]
        steps, its, phases = st["steps"], st["its"], st["phases"]
        smooth_used = st["smooth_used"]
        act = ~st["done"] & (steps < total_steps) & ~st["idle"]
        y_t = st["ych"].float()
        phase = steps // T
        it = steps % T

        # phase start: reset the per-phase state (the refilled lane at step
        # 0 and the redecode boundaries); noise_prev carries across phases
        is_ps = act & (it == 0)
        d = torch.where(is_ps, _r_of(y_t), d)
        thetas = torch.where(is_ps, theta0, thetas)
        mu = torch.where(is_ps, mu0, mu)
        if cfg.output_smoothing:
            dsum = torch.where(is_ps, 0, st["dsum"])
            # a phase that ran all T iterations unsatisfied
            smooth_used = smooth_used + (is_ps & (phase > 0)).to(torch.int32)

        # the syndrome check at the start of the iteration
        syndrome, syn_sum_vn = ops
        syn = syndrome(d)
        satisfied = (syn > 0).all(dim=0)
        newly = act & satisfied
        its = torch.where(newly, steps, its)
        phases = torch.where(newly, phase + 1, phases)
        if cfg.output_smoothing:
            smooth_used = smooth_used + (
                newly & (it > T - cfg.window_size)).to(torch.int32)
        done = st["done"] | newly
        act = act & ~satisfied

        # mode switching: f1 before the flips (stale syndrome)
        if cfg.mode_switching:
            syn_sum = syn.sum(dim=0).to(f32)
            f1 = (d.to(f32) * y_t).sum(dim=0) + syn_sum

        e = d.to(f32) * y_t + w * syn_sum_vn(syn.to(f32))
        out = {}
        if cfg.add_noise:
            if cfg.uniform_noise:
                u = uniform_philox_lanes(seed, st["gid"], steps, n, 0)
                sample = c_uniform * (u - 0.5)
            else:
                sample = gauss_philox_lanes(seed, st["gid"], steps, n, 0,
                                            0.0, ns)
            if cfg.noise_shaping:
                pert = sample - st["noise_prev"]
                out["noise_prev"] = torch.where(act, sample,
                                                st["noise_prev"])
            else:
                pert = sample
            e = e + pert
        rnum = None
        if cfg.quantize_probabilities:
            rnum = uniform_philox_lanes(seed, st["gid"], steps, n, 1)
        flip, flip_for_adapt = flip_decisions(cfg, e, thetas, mu,
                                              noise_sigma, rnum)
        d = torch.where(act & flip, -d, d)
        if cfg.threshold_adaptation:
            thetas = torch.where(act & ~flip_for_adapt, thetas * lam, thetas)
        if cfg.mode_switching:
            f2 = (d.to(f32) * y_t).sum(dim=0) + syn_sum
            mu = torch.where(act & (it > cfg.t_switch) & (f1 >= f2), 0, mu)
        if cfg.output_smoothing:
            in_window = it > T - cfg.window_size
            out["dsum"] = torch.where(act & in_window, dsum + d, dsum)
        return dict(st, d=d, thetas=thetas, mu=mu,
                    steps=steps + act.to(torch.int32), its=its,
                    phases=phases, done=done, smooth_used=smooth_used, **out)

    def boundary(st, ptr, acc, rec, rc, pool, pool_unc, pool_sat0, base, C):
        cfg, T, total_steps = C[:3]
        done = st["done"]
        retire = (done | (st["steps"] >= total_steps)) & ~st["idle"]
        d_rep = report_d(st, cfg)
        errs = (d_rep != 1).sum(dim=0)
        # a capped frame counts the smoothing of its last phase, as the
        # batch decoder's accounting after its loop does
        su = st["smooth_used"]
        if cfg.output_smoothing:
            su = su + (~done).to(torch.int32)
        ri = retire.to(torch.int64)
        word = errs > 0
        _count(acc, ri, frames=ri, bit_errs=errs, word_errs=word,
               iter_sum=st["its"], sat=done, unc_sum=st["unc"],
               smooth_sum=su)
        acc["iter_hist"].index_add_(
            0, torch.clamp(st["its"], 0, total_steps).long(), ri)
        acc["weight_hist"].index_add_(0, torch.clamp(errs, 0, n).long(),
                                      ri * word)
        acc["phase_hist"].index_add_(
            0, torch.clamp(st["phases"], 0, cfg.max_phases).long(), ri)
        if record:
            p, rc = _record_slots(rc, ri, retire, rec_cap)
            for k, v in (("gid", st["gid"]), ("iters", st["its"]),
                         ("errs", errs.to(torch.int32)),
                         ("phases", st["phases"]), ("sat", done),
                         ("smooth", su), ("hard", d_rep.t().to(torch.int8))):
                rec[k][p] = v

        # refill the retired and idle lanes from the pool, in lane order
        want = retire | st["idle"]
        can, local, ranks = _refill_plan(want, ptr, pool.shape[0])
        ych_new = torch.index_select(pool, 0, local).t().contiguous()
        sat0 = pool_sat0[local]
        # a frame satisfied at injection counts its smoothing there, as
        # the batch decoder's check at step 0 does (only when the window
        # is longer than a phase)
        su0 = sat0 & (cfg.output_smoothing and cfg.window_size > T)
        st_new = dict(
            st,
            ych=torch.where(can, ych_new, st["ych"]),
            # a frame satisfied at injection retires with the channel
            # decisions; the others reset at their first iteration (step 0)
            d=torch.where(can, _r_of(ych_new.float()), st["d"]),
            done=torch.where(can, sat0, done) | (want & ~can),
            idle=want & ~can,
            steps=torch.where(can, 0, st["steps"]),
            its=torch.where(can & ~sat0, total_steps,
                            torch.where(can, 0, st["its"])),
            phases=torch.where(can & ~sat0, cfg.max_phases,
                               torch.where(can, 1, st["phases"])),
            smooth_used=torch.where(can, su0.to(torch.int32),
                                    st["smooth_used"]),
            unc=torch.where(can, pool_unc[local], st["unc"]),
            gid=torch.where(can, base + ptr + ranks, st["gid"]),
        )
        if cfg.output_smoothing:
            st_new["dsum"] = torch.where(can, 0, st["dsum"])
        if cfg.add_noise and cfg.noise_shaping:
            st_new["noise_prev"] = torch.where(can, 0.0, st["noise_prev"])
        return st_new, ptr + can.sum(), rc

    def call(state, pool, pool_unc, pool_sat0, base, seed, sigma, cfg,
             ptr0=0):
        device = pool.device
        ops = _graph_ops(code, qc, dense_on(device), device)
        C = derived(sigma, cfg, device)
        total_steps = C[2]
        drain = ptr0 >= pool.shape[0]
        ptr = torch.full((), ptr0, dtype=torch.int64, device=device)
        acc = _zeros(device, frames=(), bit_errs=(), word_errs=(),
                     iter_sum=(), sat=(), unc_sum=(), smooth_sum=(),
                     iter_hist=(total_steps + 1,), weight_hist=(n + 1,),
                     phase_hist=(cfg.max_phases + 1,))
        rec = rc = None
        if record:
            rc = torch.zeros((), dtype=torch.int64, device=device)
            rows = rec_cap + 1

            def col(fill, dt):
                return torch.full((rows,), fill, dtype=dt, device=device)

            rec = dict(gid=col(-1, torch.int64), iters=col(0, torch.int32),
                       errs=col(0, torch.int32), phases=col(0, torch.int32),
                       sat=col(False, torch.bool),
                       smooth=col(0, torch.int32),
                       hard=torch.zeros((rows, n), dtype=torch.int8,
                                        device=device))
        st = state
        for r in range(rounds):
            if drain and r > 0 and bool(st["idle"].all()):
                break  # a drain call ends once every lane is idle
            st, ptr, rc = boundary(st, ptr, acc, rec, rc, pool, pool_unc,
                                   pool_sat0, base, C)
            for _ in range(K):
                st = iterate(st, ops, seed, C)
        acc["consumed"] = ptr - ptr0
        if record:
            acc["rc"] = rc
        return st, acc, rec

    if mesh is not None:
        return shard_call(lambda device: call, mesh)
    return call


def simulate_stream_gdbf(
    code: Code,
    cfg: GDBFConfig,
    snr_db: float,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    lanes: int = 4096,
    refill_every: int = 1,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 30.0,
    seed: int = 0,
    preprocess=None,
    pool_dtype=None,
    pool_bytes: Optional[int] = None,
    qc: Optional[QCCode] = None,
    dense: Optional[DenseGraph] = None,
    verbose: bool = False,
    max_calls: int = 100000,
    device="cuda",
    mesh=None,
) -> MCStats:
    """Monte-Carlo loop of a GDBF config over the streaming driver.

    The statistics of :func:`.montecarlo.simulate` with
    :func:`..decoders.gdbf.decode_gdbf` (all-zero codewords), with its
    ``smoothing_used`` total and ``phase_hist`` in ``extra``, without the
    straggler tax.  The lanes in flight are drained after the stop rule
    fires (:func:`.stream.run_drain`), so the counted frames are the gid
    prefix 0 … total_words−1 and their totals equal ``simulate``'s over
    those frames: the channel rows and the decoder noise are keyed alike.
    ``pool_bytes``: the pool's byte budget (:func:`.stream.pool_policy`).
    ``qc`` / ``dense``: the graph operations, as
    :func:`make_gdbf_stream_call` takes them.
    ``device`` defaults to the card; ``device="cpu"`` runs the kernels'
    plain twins.  ``mesh``: stream over the mesh's data slots, as
    :func:`.stream.simulate_stream` does (their devices replace
    ``device``).
    """
    mesh = slot_mesh(mesh, device, "simulate_stream_gdbf")
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    sigma = snr_to_sigma(snr_db, rate)
    pdt = pool_dtype or torch.float32
    default_pool = pool_frames is None
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint,
            code.n * pdt.itemsize, pool_bytes)
    elif rounds_per_call is None:
        rounds_per_call = 64
    iters_per_call = rounds_per_call * refill_every
    total_steps = cfg.max_phases * cfg.num_iterations

    dense_on = graphs_by_device(dense, code)

    def pool_of(base, frames, dev):
        return build_channel_pool_gdbf(code, seed, base, frames, sigma,
                                       preprocess, pool_dtype, qc=qc,
                                       dense=dense_on(dev), device=dev)

    nd, pool_frames, state = mesh_setup(
        mesh, lanes, pool_frames, default_pool,
        lambda n_lanes, dev: gdbf_stream_init(code, cfg, n_lanes, pdt, dev))
    call = make_gdbf_stream_call(code, rounds_per_call, refill_every, qc=qc,
                                 dense=dense, mesh=mesh)

    stats = MCStats(n=code.n)
    stats.iteration_hist = np.zeros(total_steps + 1, np.int64)
    phase_hist = np.zeros(cfg.max_phases + 1, np.int64)
    t0 = time.perf_counter()

    def take(a):
        stats.total_words += a["frames"]
        stats.total_bits += a["frames"] * code.n
        stats.errors += a["bit_errs"]
        stats.word_errors += a["word_errs"]
        stats.total_iterations += a["iter_sum"]
        stats.satisfied_words += a["sat"]
        stats.uncoded_errors += a["unc_sum"]
        stats.iteration_hist += a["iter_hist"]
        stats.error_weight_hist[:code.n] += a["weight_hist"][1:]
        phase_hist[:] += a["phase_hist"]
        if cfg.output_smoothing:
            stats.extra["smoothing_used"] = (
                stats.extra.get("smoothing_used", 0) + a["smooth_sum"])

    base = 0
    pool = None
    for _ in range(max_calls):
        if stop.done(stats.errors, stats.word_errors, stats.total_words):
            break
        pool = mesh_pools(mesh, base, pool_frames // nd, pool_of)
        state, acc, _rec = call(state, *pool, base, seed, sigma, cfg)
        a = fetch(acc)
        take(a)
        base = next_base(base, a, nd, pool_frames)
        if verbose:
            print(stats.incremental_report())
    if pool is not None:
        state = run_drain(call, state, pool, base, pool_frames // nd, take,
                          total_steps, iters_per_call,
                          extra=(seed, sigma, cfg))
    # the batch harness's form: index p − 1 counts the frames that
    # attempted p phases (slot 0 is always empty)
    stats.extra["phase_hist"] = phase_hist[1:]
    stats.wall_seconds = time.perf_counter() - t0
    return stats
