"""Streaming refill harness for the fixed-point NGDBFhw decoder.

Port of ``ldpcsimulation_tpu.harness.stream_ngdbfhw``.  The batched
:func:`..decoders.ngdbf_hw.decode_ngdbf_hw` runs ``max_phases × T`` steps
for every batch (on highrate_2048_384 at 4.25 dB, 600 steps where frames
average ~48 iterations); here persistent lanes retire their frames into
device counters and refill from the keyed channel pool every
``refill_every`` steps, as :mod:`.stream` does for the binary decoders.

Two design points of the JAX module make a streamed frame exact and the
step cheap:

* **One shared ring pointer.**  Every lane reads the noise ring at one
  position, ``gstep % (ring_len − N)`` of the global step counter, so the
  read is the contiguous slice the batch decoder's one-phase path takes (a
  per-lane window costs half a step, PERF.md §6).  A lane injected when
  the counter is at ``g0`` behaves exactly like ``decode_ngdbf_hw`` on its
  frame with ``qpointer0 = g0`` (the reference's cross-frame pointer,
  ``NGDBFhw.cpp:153,356-358``); ``g0`` is recorded per frame.
* **A phase transition consumes an update.**  A lane ending a phase resets
  to the channel decisions and performs the next phase's first update in
  the same step, with the neighbour counts of the channel decisions
  computed at injection, so every active lane executes one update per step
  and its pointer stays in step with the shared one.

The counters keep the reference's parallel-decoder model
(``NGDBFhw.cpp:280-373``): every frame attempts all ``max_phases``
phases; the least errors and least iterations across phases are counted;
the exit-satisfied flag is the last phase's; a frame whose channel
decisions already satisfy H retires at injection with 0 iterations.

Keying.  Pool row i is frame ``base + i``'s channel row, drawn by kernel
B2 as :func:`.montecarlo.simulate` draws it; the frame's ring is drawn at
its refill by B4's per-lane entry on the ring's stream
(:func:`..decoders.ngdbf_hw.lane_rings`): the ring the batch decoder draws
for that frame.  So a streamed frame equals ``decode_ngdbf_hw(…,
key=NoiseKey(seed, gid), qpointer0=g0)`` with nothing injected.

A boundary works on the refilled lanes only: their ``cumsum`` ranks (as
in :mod:`.stream`) order them first, at most ``refill_cap`` of them take a
row (the others wait for the next boundary, idle), and their channel
terms, channel decisions and neighbour counts, and their rings (drawn and
quantized for those columns alone) are computed on the compacted columns
and scattered into the lane state.  No host read in a normal call: the
pointer, the counters and the records stay on the device, and the shared
ring position is a host integer (every step advances it).

``mesh=`` shards the lanes and the pool over a mesh's data slots as
:func:`.stream.simulate_stream` does.  The shared ring counter stays one
scalar that every slot advances in lockstep (the JAX package replicates
0-dim lane state): each slot's state carries it, every normal call advances
it by the same steps, and after a drain call the slots that stopped early
(all idle) catch up, over every rank of the mesh.  Each slot draws its
refilled lanes' rings with B4's per-lane entry, keyed by their own gids.

``dense=`` takes the graph operations as matrix products
(:mod:`..decoders.dense_ops`), the batch decoder's ``dense=``: the refilled
columns' neighbour counts too.  Left behind: the ``_cached_*`` compile
caches.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_sigma
from ..codes.code import Code
from ..codes.qc import QCCode
from ..decoders.dense_ops import DenseGraph, graphs_by_device
from ..decoders.ngdbf_hw import (
    NGDBFHwConfig,
    _f32,
    _ring_integers,
    hw_graph_ops,
    hw_quantize_int,
    lane_rings,
)
from ..parallel.mesh import all_reduce_max
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
    "hw_stream_init",
    "build_channel_pool_hw",
    "make_hw_stream_call",
    "simulate_stream_ngdbfhw",
    "default_refill_cap",
]


def _metric_dtype(code: Code, cfg: NGDBFHwConfig):
    """The batch decoder's metric type: int16 where |E| <= 2·NL +
    dv_max·Smult fits."""
    return (torch.int16 if 2 * cfg.nl + code.dv_max * cfg.smult < 2**15
            else torch.int32)


def hw_stream_init(code: Code, cfg: NGDBFHwConfig, lanes: int,
                   device="cuda", record: bool = False):
    """All-idle lane state (the first boundary fills every lane it can).
    ``record`` keeps each lane's least-error decisions for a recorded call
    (``make_hw_stream_call(record=True)``)."""
    device = torch.device(device)
    n, T = code.n, cfg.num_iterations
    edt = _metric_dtype(code, cfg)
    rdt = torch.int16 if cfg.nq <= 15 else torch.int32

    def plane(rows, dt):
        return torch.zeros((rows, lanes), dtype=dt, device=device)

    def lane(fill, dt=torch.int32):
        return torch.full((lanes,), fill, dtype=dt, device=device)

    st = dict(
        yint=plane(n, edt), neg_yint=plane(n, edt),
        d=plane(n, torch.uint8), d_init=plane(n, torch.uint8),
        ssum_init=plane(n, torch.int16), ring=plane(cfg.ring_len, rdt),
        it=lane(0), phase=lane(0), least_iters=lane(T), least_errs=lane(n),
        exit_sat=lane(False, torch.bool), qp0=lane(0),
        done=lane(True, torch.bool), idle=lane(True, torch.bool),
        unc=lane(0), gid=lane(-1, torch.int64),
        gstep=0,  # the shared ring counter: a host int, one per step
    )
    if record:
        st["best_d"] = plane(n, torch.uint8)
    return st


def build_channel_pool_hw(code: Code, seed: int, base: int, pool_frames: int,
                          sigma: float, qc: Optional[QCCode] = None,
                          dense: Optional[DenseGraph] = None,
                          device="cuda"):
    """Pool rows ``[F, N]`` f32 of frames base … base+F−1 (kernel B2 keyed by
    (seed, frame): the rows ``simulate`` gives them; the decoder clips and
    quantizes), ``unc [F]`` int32 (the channel decisions' errors against
    the all-zero word) and ``sat0 [F]`` bool (their syndrome: such a frame
    retires at injection with 0 iterations).  The rings are drawn at
    refill.  ``qc`` / ``dense``: the graph operations, as
    :func:`..decoders.ngdbf_hw.hw_graph_ops` takes them."""
    syndrome01, _ = hw_graph_ops(code, qc, dense)
    y = awgn_all_zero(seed, base, pool_frames, code.n, sigma, device)
    d0 = y <= 0
    unc = d0.sum(dim=1).to(torch.int32)
    sat0 = (syndrome01(d0.t().to(torch.uint8)) == 0).all(dim=0)
    return y, unc, sat0


def default_refill_cap(lanes: int, refill_every: int,
                       avg_iters_hint: float) -> int:
    """The refills a boundary can take: twice the expected retirements
    ``lanes × refill_every / avg_iters_hint`` (every lane when that reaches
    the lane count)."""
    want = math.ceil(2 * lanes * refill_every / max(avg_iters_hint, 1.0))
    return max(1, min(lanes, want))


def make_hw_stream_call(code: Code, cfg: NGDBFHwConfig, rounds: int,
                        refill_every: int = 1, qc: Optional[QCCode] = None,
                        dense: Optional[DenseGraph] = None,
                        record: bool = False, rec_cap: int = 0,
                        refill_cap: Optional[int] = None, mesh=None):
    """The persistent-state call.

    ``call(state, pool, pool_unc, pool_sat0, base, seed, sigma, ptr0=0) ->
    (state', acc, rec)`` runs ``rounds`` boundary + ``refill_every``-step
    cycles; ``seed`` is the run seed (the rings' key) and ``sigma`` the
    channel's.  ``base`` is pool row 0's gid; ``ptr0 == len(pool)`` makes a
    drain call (no refills; stops once every lane is idle, one host read
    per round).  The call writes the refilled columns of its state's lane
    planes in place.

    ``qc`` / ``dense``: the graph operations, as
    :func:`..decoders.ngdbf_hw.hw_graph_ops` takes them.
    ``refill_cap``: the most lanes a boundary refills (default: every
    lane); the rings are drawn and quantized for that many columns.  acc:
    int64 counters (frames, bit_errs = least errors, word_errs, iter_sum =
    least iterations, sat = exit-satisfied, unc_sum, iter_hist [T + 1],
    weight_hist [N + 1]), ``consumed`` and ``rc``.  With ``record`` (and
    a state from ``hw_stream_init(record=True)``), rec holds (gid, iters,
    errs, sat, qp0, hard) per retired frame in retire order: ``qp0`` the
    injection-time ring offset, ``hard`` the least-error decisions as int8
    ±1.

    ``mesh``: the call sharded over the mesh's data slots
    (:func:`.stream.shard_call`, one call per device on the code's tables
    there); the slots' ring counters end every call equal.
    """
    if mesh is not None:
        dense_on = graphs_by_device(dense, code)
        inner = shard_call(
            lambda device: make_hw_stream_call(
                code.to(device), cfg, rounds, refill_every, qc=qc,
                dense=dense_on(device), record=record, rec_cap=rec_cap,
                refill_cap=refill_cap),
            mesh)

        def sharded(state, pool, *args):
            state, acc, rec = inner(state, pool, *args)
            # a drain call (ptr0 == len(pool)) stops early on a slot whose
            # lanes are all idle: such a slot catches up with the others,
            # on every rank
            gstep = max(st["gstep"] for st in state)
            if mesh.ranks > 1 and len(args) > 5 and args[5] >= len(pool[0]):
                gstep = all_reduce_max(gstep, state.home)
            for st in state:
                st["gstep"] = gstep
            return state, acc, rec

        return sharded
    n, T, K, P = code.n, cfg.num_iterations, refill_every, cfg.max_phases
    theta, smult = cfg.theta_int, cfg.smult
    ring_mod = cfg.ring_len - n
    if ring_mod <= 0:
        raise ValueError("ring_len must exceed code length")
    edt = _metric_dtype(code, cfg)
    syndrome01, satsum = hw_graph_ops(code, qc, dense)

    def derive(rows_t):
        """Raw [N, C] samples -> (yint, d_init, ssum_init), the batch
        decoder's channel clip and quantizer."""
        ym = _f32(cfg.ymax, rows_t.device)
        ay = rows_t.abs()
        y_clip = torch.where(ay > ym, rows_t * (ym / ay), rows_t)
        d_init = (y_clip <= 0).to(torch.uint8)
        yint = hw_quantize_int(y_clip / _f32(2.0 * cfg.w, rows_t.device),
                               cfg.nl, cfg.lmax).to(edt)
        return yint, d_init, satsum(syndrome01(d_init))

    def iterate(st):
        act = ~st["done"] & ~st["idle"]
        d, it, phase = st["d"], st["it"], st["phase"]
        least_errs = st["least_errs"]
        # phase end: the cap after T updates (no check then,
        # NGDBFhw.cpp:290), or satisfied at the iteration-start check
        capped = act & (it >= T)
        syn = syndrome01(d)
        sat_end = act & ~capped & (syn == 0).all(dim=0)
        end = capped | sat_end
        p_iters = torch.where(capped, T, it)
        errs_now = d.sum(dim=0, dtype=torch.int32)  # against the zero word
        better = end & (errs_now < least_errs)
        out = {}
        if record:
            out["best_d"] = torch.where(better, d, st["best_d"])
        least_errs = torch.where(better, errs_now, least_errs)
        least_iters = torch.where(
            end, torch.minimum(st["least_iters"], p_iters),
            st["least_iters"])
        new_phase = torch.where(end, phase + 1, phase)
        finished = end & (new_phase >= P)
        exit_sat = torch.where(finished, sat_end, st["exit_sat"])
        upd = act & ~finished
        # one update per active lane; a lane ending a phase (not its last)
        # starts the next from the channel decisions in this same step
        if P > 1:
            trans = end & ~finished
            d_used = torch.where(trans, st["d_init"], d)
            ssum = torch.where(trans, st["ssum_init"], satsum(syn))
            it = torch.where(trans, 1, torch.where(upd, it + 1, it))
        else:
            d_used, ssum = d, satsum(syn)
            it = torch.where(upd, it + 1, it)
        p = st["gstep"] % ring_mod
        e = (torch.where(d_used.bool(), st["neg_yint"], st["yint"])
             + ssum.to(edt) * smult + st["ring"][p:p + n])
        flip = upd & (e <= theta)
        d = torch.where(flip, 1 - d_used, torch.where(upd, d_used, d))
        return dict(st, d=d, it=it, phase=new_phase,
                    least_iters=least_iters, least_errs=least_errs,
                    exit_sat=exit_sat,
                    done=st["done"] | finished, gstep=st["gstep"] + 1, **out)

    def boundary(st, ptr, acc, rec, rc, pool, pool_unc, pool_sat0, base,
                 seed, sigma, cap, drain):
        retire = st["done"] & ~st["idle"]
        ri = retire.to(torch.int64)
        errs = st["least_errs"]
        word = errs > 0
        _count(acc, ri, frames=ri, bit_errs=errs, word_errs=word,
               iter_sum=st["least_iters"], sat=st["exit_sat"],
               unc_sum=st["unc"])
        acc["iter_hist"].index_add_(
            0, torch.clamp(st["least_iters"], 0, T).long(), ri)
        acc["weight_hist"].index_add_(0, torch.clamp(errs, 0, n).long(),
                                      ri * word)
        if record:
            p, rc = _record_slots(rc, ri, retire, rec_cap)
            hard = (1 - 2 * st["best_d"].to(torch.int8)).t()
            for k, v in (("gid", st["gid"]), ("iters", st["least_iters"]),
                         ("errs", errs), ("sat", st["exit_sat"]),
                         ("qp0", st["qp0"]), ("hard", hard)):
                rec[k][p] = v

        # refill the retired and idle lanes in lane order, at most ``cap``
        want = retire | st["idle"]
        if drain:  # nothing to refill: the retired lanes go idle
            return dict(st, done=st["done"] | want, idle=want), ptr, rc
        can, local, ranks = _refill_plan(want, ptr, pool.shape[0])
        can = can & (ranks < cap)
        # compacted column r: the refilled lane of rank r, then the other
        # lanes in lane order (distinct columns: their old values stay)
        k = can.sum()
        pos = torch.where(can, ranks, k + torch.cumsum(~can, 0) - 1)
        lane_ids = torch.arange(len(can), device=pool.device)
        dest = torch.empty_like(lane_ids).scatter_(0, pos, lane_ids)[:cap]
        r = lane_ids[:cap]
        slot_ok = r < k
        rows = torch.clamp(ptr + r, max=pool.shape[0] - 1)
        yint, d_init, ssum = derive(
            pool.index_select(0, rows).t().contiguous())
        ring = _ring_integers(cfg, lane_rings(cfg, sigma, seed,
                                              base + ptr + r))
        new = dict(yint=yint, neg_yint=-yint, d=d_init, d_init=d_init,
                   ssum_init=ssum, ring=ring)
        if record:
            new["best_d"] = d_init
        for k, v in new.items():
            old = st[k].index_select(1, dest)
            st[k].index_copy_(1, dest, torch.where(slot_ok, v, old))
        sat0 = pool_sat0[local]
        unc = pool_unc[local]
        st = dict(
            st,
            it=torch.where(can, 0, st["it"]),
            phase=torch.where(can, 0, st["phase"]),
            least_iters=torch.where(can, torch.where(sat0, 0, T),
                                    st["least_iters"]).to(torch.int32),
            least_errs=torch.where(can, torch.where(sat0, unc, n),
                                   st["least_errs"]).to(torch.int32),
            exit_sat=torch.where(can, sat0, st["exit_sat"]),
            qp0=torch.where(can, st["gstep"] % ring_mod,
                            st["qp0"]).to(torch.int32),
            done=torch.where(can, sat0, st["done"]) | (want & ~can),
            idle=want & ~can,
            unc=torch.where(can, unc, st["unc"]),
            gid=torch.where(can, base + ptr + ranks, st["gid"]),
        )
        return st, ptr + can.sum(), rc

    def call(state, pool, pool_unc, pool_sat0, base, seed, sigma, ptr0=0):
        device = pool.device
        lanes = state["it"].shape[0]
        cap = lanes if refill_cap is None else min(refill_cap, lanes)
        drain = ptr0 >= pool.shape[0]
        ptr = torch.full((), ptr0, dtype=torch.int64, device=device)
        acc = _zeros(device, frames=(), bit_errs=(), word_errs=(),
                     iter_sum=(), sat=(), unc_sum=(), iter_hist=(T + 1,),
                     weight_hist=(n + 1,))
        rec = rc = None
        if record:
            if "best_d" not in state:
                raise ValueError("a recorded call needs a state from "
                                 "hw_stream_init(record=True)")
            rc = torch.zeros((), dtype=torch.int64, device=device)
            rows = rec_cap + 1

            def col(fill, dt):
                return torch.full((rows,), fill, dtype=dt, device=device)

            rec = dict(gid=col(-1, torch.int64), iters=col(0, torch.int32),
                       errs=col(0, torch.int32), sat=col(False, torch.bool),
                       qp0=col(0, torch.int32),
                       hard=torch.zeros((rows, n), dtype=torch.int8,
                                        device=device))
        st = state
        for r in range(rounds):
            if drain and r > 0 and bool(st["idle"].all()):
                break  # a drain call ends once every lane is idle
            st, ptr, rc = boundary(st, ptr, acc, rec, rc, pool, pool_unc,
                                   pool_sat0, base, seed, sigma, cap,
                                   drain)
            for _ in range(K):
                st = iterate(st)
        acc["consumed"] = ptr - ptr0
        if record:
            acc["rc"] = rc
        return st, acc, rec

    return call


def simulate_stream_ngdbfhw(
    code: Code,
    cfg: NGDBFHwConfig,
    snr_db: float,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    lanes: int = 4096,
    refill_every: int = 4,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 40.0,
    seed: int = 0,
    pool_bytes: Optional[int] = None,
    qc: Optional[QCCode] = None,
    dense: Optional[DenseGraph] = None,
    verbose: bool = False,
    max_calls: int = 100000,
    device="cuda",
    mesh=None,
) -> MCStats:
    """Monte-Carlo loop of NGDBFhw over the streaming driver.

    The counters of :func:`.montecarlo.simulate` with ``decode_ngdbf_hw``
    (least errors and least iterations across phases, the exit-satisfied
    flag; all-zero codewords) without the straggler tax.  The reference
    runs a fixed frame count (``NGDBFhw.cpp:193``): pass
    ``StopRule.fixed_frames``, as the sweep does.  The lanes in flight are
    drained after the stop rule fires, so the counted frames are the gid
    prefix 0 … total_words−1, each equal to its batch decode at its
    recorded ring offset.  ``pool_bytes``: the pool's byte budget
    (:func:`.stream.pool_policy`, default 1 GiB); a boundary refills at
    most :func:`default_refill_cap` lanes.  ``device`` defaults to the card;
    ``device="cpu"`` runs the kernels' plain twins.  ``extra["steps"]``:
    the stream steps the run executed, drain included (× lanes / frames =
    lane-iterations per counted frame).  ``mesh``: stream over the mesh's
    data slots, as :func:`.stream.simulate_stream` does (their devices
    replace ``device``; the refill cap is a slot's).
    """
    mesh = slot_mesh(mesh, device, "simulate_stream_ngdbfhw")
    rate = code.rate if rate is None else rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    sigma = snr_to_sigma(snr_db, rate)
    default_pool = pool_frames is None
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint,
            code.n * 4, pool_bytes, default_rounds=32)
    elif rounds_per_call is None:
        rounds_per_call = 32
    T = cfg.num_iterations
    codes = {}
    dense_on = graphs_by_device(dense, code)

    def code_on(dev):
        if dev not in codes:
            codes[dev] = code.to(dev)
        return codes[dev]

    def pool_of(base, frames, dev):
        return build_channel_pool_hw(code_on(dev), seed, base, frames, sigma,
                                     qc, dense_on(dev), dev)

    nd, pool_frames, state = mesh_setup(
        mesh, lanes, pool_frames, default_pool,
        lambda n_lanes, dev: hw_stream_init(code_on(dev), cfg, n_lanes, dev))
    call = make_hw_stream_call(
        code, cfg, rounds_per_call, refill_every, qc=qc, dense=dense,
        refill_cap=default_refill_cap(lanes // nd, refill_every,
                                      avg_iters_hint),
        mesh=mesh)

    stats = MCStats(n=code.n)
    stats.iteration_hist = np.zeros(T + 1, np.int64)
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

    base = 0
    pool = None
    for _ in range(max_calls):
        if stop.done(stats.errors, stats.word_errors, stats.total_words):
            break
        pool = mesh_pools(mesh, base, pool_frames // nd, pool_of)
        state, acc, _rec = call(state, *pool, base, seed, sigma)
        a = fetch(acc)
        take(a)
        base = next_base(base, a, nd, pool_frames)
        if verbose:
            print(stats.incremental_report())
    if pool is not None:
        state = run_drain(call, state, pool, base, pool_frames // nd, take,
                          cfg.max_phases * T,
                          rounds_per_call * refill_every,
                          extra=(seed, sigma))
    stats.extra["steps"] = state[0]["gstep"]
    stats.wall_seconds = time.perf_counter() - t0
    return stats
