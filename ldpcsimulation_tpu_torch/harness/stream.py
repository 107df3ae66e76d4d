"""Streaming early-termination harness: persistent lanes that retire
converged frames and refill from a keyed channel pool.

Port of ``ldpcsimulation_tpu.harness.stream``.  A batched
early-termination decode runs every batch until its slowest frame is done,
so most of its rounds decode frames that are already finished (on the QC BP
path 20 rounds against a frame's average of ~10).  Here a ``lanes``-wide
decode state stays on the device: every ``refill_every`` iterations the
lanes whose frame checked out (or hit the cap) are *retired* into counters
on the device and *refilled* from a pool of channel rows, so the device
decodes live frames.  Per frame, nothing changes:

  * pool row i is frame ``base + i`` of the run seed, drawn by kernel B2
    (:func:`..channel.awgn.awgn_all_zero`): the very row that
    :func:`.montecarlo.simulate` gives that frame;
  * the decoders are deterministic and frames are independent along the
    batch, so a frame's trajectory does not depend on when it enters a
    lane;
  * the iteration count keeps the batched decoders' definition (checked
    before the first update: a frame satisfied at injection reports 0;
    capped frames report T; DD-BMP's break index, see
    :class:`StreamDecoder`).

Only the decision carry is masked, as in
:func:`..decoders.base.run_flooding_soft`: a finished frame's messages go on
evolving until its lane is refilled, and nothing reads them.

The loop runs eagerly from Python.  A normal call makes no host sync: the
pool pointer, the counters and the record cursor are device tensors, the
refill ranks come from a ``cumsum`` on the device, and the host reads the
counters once, after the call (:func:`fetch`).  A drain call (the pool
pre-exhausted) reads "every lane idle" once per round to stop early.

Frame ids are int64 (B2's counter takes a 64-bit frame index), so a run
never rotates its channel key, where the JAX package rotates its root key
before its int32 ids run out.

The simulate drivers run over the data slots of a
:class:`..parallel.mesh.Mesh` (``mesh=``; without one, a one-slot mesh on
``device``).  Each data slot ``di`` of ``nd`` streams ``lanes/nd`` lanes of
its own against its own ``pool_frames/nd`` pool rows, frames ``base +
di·(pool_frames/nd)`` onwards, so gids never collide; the counters are
summed over the rank's slots and all-reduced over the mesh's ranks.  One
slot's window advances by the rows it consumed; several slots' advance by
the whole pool each call (a slot's unconsumed gids are skipped, as in the
JAX package: which gids are skipped depends on the consumption counts
only, never on a skipped frame's own channel).  The JAX ``data_axis``
argument is not taken: a stream shards over the "data" axis only.

The GDBF family streams through :mod:`.stream_gdbf`, NGDBFhw through
:mod:`.stream_ngdbfhw`.  The non-binary FFT-QSPA streams here
(:func:`nb_qspa_stream`, :func:`simulate_stream_nb`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_n0, snr_to_sigma
from ..codes.code import Code
from ..codes.qc import QCCode
from ..parallel.mesh import (
    Mesh,
    all_reduce_dict,
    all_reduce_sum,
    world,
)
from .montecarlo import MCStats, StopRule, default_min_word_errors

__all__ = [
    "StreamDecoder",
    "minsum_qc_stream",
    "bp_qc_stream",
    "minsum_stream",
    "bp_stream",
    "minsum_stratified_stream",
    "bp_stratified_stream",
    "minsum_layered_qc_stream",
    "bp_layered_qc_stream",
    "ddbmp_qc_stream",
    "ddbmp_stream",
    "stream_init",
    "pool_policy",
    "DEFAULT_POOL_BYTES",
    "make_stream_call",
    "MeshState",
    "slot_mesh",
    "mesh_setup",
    "mesh_pools",
    "next_base",
    "shard_call",
    "fetch",
    "build_channel_pool",
    "run_drain",
    "simulate_stream",
    "nb_qspa_stream",
    "build_channel_pool_nb",
    "simulate_stream_nb",
]


@dataclasses.dataclass(frozen=True)
class StreamDecoder:
    """A decoder at iteration granularity, for the stream driver.

    Every callable works in the decoder's layout, batch on the LAST axis.

    prep(rows [B, R]) -> ych        — channel term in decoder layout (for
                                      the soft decoders, the iteration-0
                                      posterior); R is the pool row width
                                      (N for binary decoders).
    init(ych) -> msgs               — initial messages (a tensor or a
                                      tuple of them).
    step(msgs, ych) -> (msgs, total)
    satisfied(d) -> [B] bool        — all parity checks pass.
    hard(d) -> [N, B]               — decisions in bit order.

    Optional hooks (the non-binary decoders use them):
    d_of(total) -> d                — decisions from the step total
                                      (default: int8 sign, sgn(0) = −1).
    errs_of(d) -> [B]               — primary error count per frame
                                      (default: ``hard(d) != +1``).
    errs2_of(d) -> [B]              — optional second counter.
    prep_raw(rows) -> rows          — maps the preprocessed channel rows to
                                      the pool's rows once per frame, at
                                      pool build.

    Iteration-count conventions (DD-BMP differs from the soft decoders):
    check_at_injection=False        — no frame retires at injection: the
                                      decoder runs at least one round
                                      before its first syndrome check.
    break_index=True                — satisfied frames report the 0-based
                                      break index (rounds run minus one);
                                      capped frames still report T.
    step_fresh(msgs, ych, fresh)    — the refill merge done inside the step
                                      (``fresh`` [B] bool: lanes whose
                                      messages read as ``init(ych)``), for
                                      decoders whose message state is too
                                      heavy to merge whole; the values of
                                      merging first.
    """

    prep: Callable
    init: Callable
    step: Callable
    satisfied: Callable
    hard: Callable
    d_of: Optional[Callable] = None
    errs_of: Optional[Callable] = None
    errs2_of: Optional[Callable] = None
    check_at_injection: bool = True
    break_index: bool = False
    step_fresh: Optional[Callable] = None
    prep_raw: Optional[Callable] = None


def _nb(rows):
    """Pool rows [B, N] -> the decoders' [N, B]."""
    return rows.t().contiguous()


def minsum_qc_stream(qc: QCCode, variant: str = "plain", alpha: float = 1.0,
                     delta: float = 0.0, storage_dtype=None) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.minsum_qc.decode_minsum_qc`
    (its step function: the same arithmetic)."""
    from ..decoders.minsum_qc import (
        qc_check_satisfied,
        qc_minsum_step,
        qc_ragged_init,
    )

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return qc_ragged_init(qc, ych, sdt)

    return StreamDecoder(
        prep=_nb,
        init=init,
        step=_upcast_step(
            qc_minsum_step(qc, variant, alpha, delta, storage_dtype)),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d,
    )


def bp_qc_stream(qc: QCCode, max_llr: Optional[float] = None,
                 storage_dtype=None) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.bp_qc.decode_bp_qc`.  Pool rows
    must be LLRs (``preprocess=llr_from_channel``); ``prep`` applies the
    batch decoder's ±max_llr input clamp."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_qc import qc_bp_step
    from ..decoders.minsum_qc import qc_check_satisfied, qc_ragged_init

    ml = MAXLLR if max_llr is None else max_llr

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return qc_ragged_init(qc, ych, sdt)

    return StreamDecoder(
        prep=lambda rows: _nb(torch.clamp(rows, -ml, ml)),
        init=init,
        step=_upcast_step(qc_bp_step(qc, ml, storage_dtype)),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d,
    )


def _slot_array_stream(code: Code, make_step, clamp: Optional[float],
                       storage_dtype) -> StreamDecoder:
    """Shared construction of the slot-array adapters: ``make_step(code on
    the messages' device)`` gives the batch decoder's step."""
    from ..decoders.base import xor_satisfied
    from ..decoders.minsum import minsum_plan

    def step(v2c, yb):
        return make_step(minsum_plan(code, v2c.device).code)(v2c, yb)

    def prep(rows):
        return _nb(rows if clamp is None
                   else torch.clamp(rows, -clamp, clamp))

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return ych.repeat_interleave(code.dv_max, dim=0).to(sdt)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(step),
        satisfied=lambda d: xor_satisfied(
            minsum_plan(code, d.device).check_cols, d),
        hard=lambda d: d,
    )


def minsum_stream(code: Code, variant: str = "plain", alpha: float = 1.0,
                  delta: float = 0.0, storage_dtype=None) -> StreamDecoder:
    """Stream adapter for the slot-array
    :func:`..decoders.minsum.decode_minsum`."""
    from ..decoders.minsum import minsum_step

    return _slot_array_stream(
        code,
        lambda c: minsum_step(c, variant, alpha, delta, storage_dtype),
        None, storage_dtype,
    )


def bp_stream(code: Code, max_llr: Optional[float] = None,
              storage_dtype=None) -> StreamDecoder:
    """Stream adapter for the slot-array :func:`..decoders.bp.decode_bp`
    (any binary code).  Pool rows must be LLRs; ``prep`` applies the batch
    decoder's ±max_llr input clamp."""
    from ..decoders.bp import MAXLLR, bp_step

    ml = MAXLLR if max_llr is None else max_llr
    return _slot_array_stream(
        code, lambda c: bp_step(c, ml, storage_dtype), ml, storage_dtype)


def _stratified_stream(sc, step, clamp: Optional[float],
                       storage_dtype) -> StreamDecoder:
    """Shared construction of the stratified adapters: the channel term is
    the [kg, w, B] group grid of the (clamped) rows, the messages the
    [mb, kg, w, B] VN-slot planes, decisions go back to column order
    through ``pos_of_col``."""
    from ..decoders.minsum_stratified import (
        stratified_check_satisfied,
        stratified_grid,
        stratified_hard,
        stratified_init,
    )

    def prep(rows):
        if clamp is not None:
            rows = torch.clamp(rows, -clamp, clamp)
        return stratified_grid(sc, rows.t())

    def init(ych):
        sdt = storage_dtype if storage_dtype is not None else ych.dtype
        return stratified_init(sc, ych, sdt)

    return StreamDecoder(
        prep=prep,
        init=init,
        step=_upcast_step(step),
        satisfied=lambda d: stratified_check_satisfied(sc, d),
        hard=lambda d: stratified_hard(sc, d),
    )


def minsum_stratified_stream(sc, variant: str = "plain", alpha: float = 1.0,
                             delta: float = 0.0,
                             storage_dtype=None) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.minsum_stratified.decode_minsum_stratified` (its step
    function: B1 on the stratified routing table), the sweep's ``--stream``
    route for an alist that stratifies."""
    from ..decoders.minsum_stratified import stratified_minsum_step

    return _stratified_stream(
        sc, stratified_minsum_step(sc, variant, alpha, delta, storage_dtype),
        None, storage_dtype)


def bp_stratified_stream(sc, max_llr: Optional[float] = None,
                         storage_dtype=None) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.bp_stratified.decode_bp_stratified`.  Pool rows must
    be LLRs; ``prep`` applies the batch decoder's ±max_llr input clamp
    before gathering into the group grid."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_stratified import stratified_bp_step

    ml = MAXLLR if max_llr is None else max_llr
    return _stratified_stream(sc, stratified_bp_step(sc, ml, storage_dtype),
                              ml, storage_dtype)


def _layered_stream(qc: QCCode, step, storage_dtype) -> StreamDecoder:
    """Shared construction of the layered adapters: one stream iteration is
    one pass over all layers, so the iteration count keeps the batched
    layered decoders' definition.  The state is (posterior ``q [N, B]``,
    per-layer stored messages ``L``); the channel term lives inside q, so
    a refill re-initializes q := ych, L := 0 (at ``storage_dtype``, or the
    posterior's type), and the step ignores ych.  An f16 pool's rows are
    upcast exactly at init: the posterior is f32, as in the batch
    decoders."""
    from ..decoders.minsum_layered import layered_l0
    from ..decoders.minsum_qc import qc_check_satisfied

    def init(ych):
        dt = torch.promote_types(ych.dtype, torch.float32)
        q = ych.to(dt)
        sdt = storage_dtype if storage_dtype is not None else dt
        return (q, layered_l0(qc, ych.shape[-1], sdt, ych.device))

    return StreamDecoder(
        prep=_nb,
        init=init,
        step=lambda qL, ych: step(qL),
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d,
    )


def minsum_layered_qc_stream(qc: QCCode, variant: str = "plain",
                             alpha: float = 1.0, delta: float = 0.0,
                             storage_dtype=None) -> StreamDecoder:
    """Stream adapter for
    :func:`..decoders.minsum_layered.decode_minsum_layered_qc` (its step
    function); see :func:`_layered_stream`."""
    from ..decoders.minsum_layered import qc_minsum_layered_step

    return _layered_stream(
        qc, qc_minsum_layered_step(qc, variant, alpha, delta, storage_dtype),
        storage_dtype)


def bp_layered_qc_stream(qc: QCCode,
                         max_llr: Optional[float] = None) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.bp_layered.decode_bp_layered_qc`
    (its step function); see :func:`_layered_stream`.  Pool rows must be
    LLRs; the batch decoder carries the unclamped posterior (it clamps only
    the check input), so ``prep`` clamps nothing.  L stays in the
    posterior's type: the batch decoder has no storage type."""
    from ..decoders.bp import MAXLLR
    from ..decoders.bp_layered import qc_bp_layered_step

    ml = MAXLLR if max_llr is None else max_llr
    return _layered_stream(qc, qc_bp_layered_step(qc, ml), None)


def ddbmp_qc_stream(qc: QCCode) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.ddbmp.decode_ddbmp_qc` (its
    round function).  DD-BMP is deterministic and streams like the soft
    decoders, with its own iteration-count conventions
    (``check_at_injection=False``, ``break_index=True``: the batched
    decoder never checks the channel decisions and reports the 0-based
    break index).  Pool rows must be quantized
    (``preprocess=quantize_no_zero``).  ``step_fresh`` merges the refilled
    lanes at the round's memory read (``qc_ddbmp_round(fresh=)``), so the
    boundary never writes the whole memory state."""
    from ..decoders.ddbmp import qc_ddbmp_round
    from ..decoders.minsum_qc import qc_check_satisfied, qc_plan

    def init(ych):
        dt = torch.promote_types(ych.dtype, torch.float32)
        return ych.to(dt)[qc_plan(qc, ych.device).row_col]

    def step_fresh(mem, yb, fresh):
        yf = yb.to(torch.promote_types(yb.dtype, torch.float32))
        return qc_ddbmp_round(qc, mem, yf, fresh=fresh)

    return StreamDecoder(
        prep=_nb,
        init=init,
        step=_upcast_step(lambda mem, yb: qc_ddbmp_round(qc, mem, yb)),
        step_fresh=step_fresh,
        satisfied=lambda d: qc_check_satisfied(qc, d),
        hard=lambda d: d,
        # the round emits int8 ±1 decisions; the lane carry stays int8
        d_of=lambda t: t.to(torch.int8),
        check_at_injection=False,
        break_index=True,
    )


def ddbmp_stream(code: Code) -> StreamDecoder:
    """Stream adapter for the slot-array
    :func:`..decoders.ddbmp.decode_ddbmp` (its round function), with
    :func:`ddbmp_qc_stream`'s conventions; for the codes without a QC
    form."""
    from ..decoders.base import xor_satisfied
    from ..decoders.ddbmp import ddbmp_round
    from ..decoders.minsum import minsum_plan

    def init(ych):
        dt = torch.promote_types(ych.dtype, torch.float32)
        return ych.to(dt).repeat_interleave(code.dv_max, dim=0)

    def step_fresh(mem, yb, fresh):
        yf = yb.to(torch.promote_types(yb.dtype, torch.float32))
        return ddbmp_round(code, mem, yf, fresh=fresh)

    return StreamDecoder(
        prep=_nb,
        init=init,
        step=_upcast_step(lambda mem, yb: ddbmp_round(code, mem, yb)),
        step_fresh=step_fresh,
        satisfied=lambda d: xor_satisfied(
            minsum_plan(code, d.device).check_cols, d),
        hard=lambda d: d,
        d_of=lambda t: t.to(torch.int8),
        check_at_injection=False,
        break_index=True,
    )


def _upcast_step(step):
    """A step that consumes a reduced-precision (f16 pool) channel term at
    f32: the conversion is exact, so only the pool's memory shrinks."""

    def wrapped(msgs, ych):
        return step(msgs, ych.to(torch.promote_types(ych.dtype,
                                                     torch.float32)))

    return wrapped


def _sign8(x):
    """Posterior sign as int8 ±1, sgn(0) = −1 (``total > 0``), the
    decision of :func:`..decoders.base.run_flooding_soft`."""
    return torch.where(x > 0, 1, -1).to(torch.int8)


def _merge(mask_b, new, old):
    """Per-tensor select with a [B] mask over the last (batch) axis, through
    tuples."""
    if isinstance(old, (tuple, list)):
        return type(old)(_merge(mask_b, nw, od) for nw, od in zip(new, old))
    return torch.where(mask_b, new, old)


def stream_init(dec: StreamDecoder, lanes: int, n: int,
                dtype=torch.float32, device="cuda"):
    """All-idle lane state: the first boundary of the first call fills every
    lane from the pool.  ``n`` is the pool row width and ``dtype`` the pool
    rows' type, so the carried ych keeps its layout."""
    device = torch.device(device)
    ych = dec.prep(torch.zeros((lanes, n), dtype=dtype, device=device))
    d_of = dec.d_of or _sign8
    return dict(
        msgs=dec.init(ych),
        fresh=torch.zeros((lanes,), dtype=torch.bool, device=device),
        ych=ych,
        d=d_of(ych),
        done=torch.ones((lanes,), dtype=torch.bool, device=device),
        idle=torch.ones((lanes,), dtype=torch.bool, device=device),
        iters=torch.zeros((lanes,), dtype=torch.int32, device=device),
        unc=torch.zeros((lanes,), dtype=torch.int32, device=device),
        gid=torch.full((lanes,), -1, dtype=torch.int64, device=device),
    )


def _zeros(device, **shapes):
    """int64 counters on the device (a fill each: no host copy)."""
    return {k: torch.zeros(s, dtype=torch.int64, device=device)
            for k, s in shapes.items()}


def _count(acc, ri, **values):
    """acc[k] += Σ values[k] over the retiring lanes (ri 0/1 int64)."""
    for k, v in values.items():
        acc[k] += (v.to(torch.int64) * ri).sum()


def _record_slots(rc, ri, retire, rec_cap):
    """Record rows of the retiring lanes in lane order (rec_cap, a spare
    row, for the others and past the capacity), and the cursor after."""
    pos = rc + torch.cumsum(ri, 0) - 1
    return torch.where(retire & (pos < rec_cap), pos, rec_cap), rc + ri.sum()


def _refill_plan(want, ptr, pool_len):
    """Lanes that take a pool row this boundary (``can``), and the row
    each takes: the k-th wanting lane in lane order takes row ptr + k."""
    ranks = torch.cumsum(want, 0) - 1
    can = want & (ranks < pool_len - ptr)
    local = torch.where(can, ptr + ranks, 0)
    return can, local, ranks


def make_stream_call(
    dec: StreamDecoder,
    n: int,
    num_iterations: int,
    rounds: int,
    refill_every: int = 1,
    record: bool = False,
    rec_cap: int = 0,
    max_weight: Optional[int] = None,
    mesh=None,
):
    """The persistent-state call.

    ``call(state, pool, pool_unc, pool_sat0, base, ptr0=0) -> (state',
    acc, rec)`` runs ``rounds`` boundary + ``refill_every``-iteration
    cycles.  ``base`` is the gid of pool row 0; ``ptr0`` pre-consumes the
    pool, and ``ptr0 == len(pool)`` makes a DRAIN call: no refills, the
    lanes in flight retire and go idle, and the call stops early once every
    lane is idle (one host read per round).

    acc: int64 counters and histograms on the device for the frames retired
    in the call (a frame retires once, at the first boundary after it
    checks out or caps); ``acc["consumed"]`` is the pool rows consumed (the
    caller's next base moves by it: unconsumed rows are drawn again, the
    same, next call) and ``acc["rc"]`` the records written.

    ``record=True``: the retired frames' (gid, iters, errs) and their
    decisions ``hard`` (int8 [·, N]) in retire order, the first
    ``acc["rc"]`` rows valid, up to ``rec_cap`` (one spare row takes the
    writes of the other lanes) — the hook of the per-frame tests; a
    non-binary decoder's ``hard`` rows are its symbols.  With
    ``dec.errs2_of``, acc adds the total ``errs2`` and ``weight2_hist``
    [n + 1] (retired frames with errs2 = w > 0 at index w).

    ``mesh``: the call of :func:`shard_call` over the mesh's data slots
    (state and pool arguments are per-slot lists, ``base`` the window's
    first gid).
    """
    T = num_iterations
    K = refill_every
    mw = n if max_weight is None else max_weight
    d_of = dec.d_of or _sign8

    def boundary(st, ptr, acc, rec, rc, pool, pool_unc, pool_sat0, base):
        d, done, idle, iters = st["d"], st["done"], st["idle"], st["iters"]
        hard = dec.hard(d) if record or dec.errs_of is None else None
        if dec.errs_of is not None:
            errs = dec.errs_of(d)
        else:
            errs = (hard != 1).sum(dim=0)
        retire = (done | (iters >= T)) & ~idle
        if dec.break_index:
            # DD-BMP: satisfied frames report the 0-based break index
            iters = torch.where(done, torch.clamp(iters - 1, min=0), iters)
        ri = retire.to(torch.int64)
        word = errs > 0
        _count(acc, ri, frames=ri, bit_errs=errs, word_errs=word,
               iter_sum=iters, sat=done, unc_sum=st["unc"])
        if dec.errs2_of is not None:
            errs2 = dec.errs2_of(d)
            _count(acc, ri, errs2=errs2)
            acc["weight2_hist"].index_add_(
                0, torch.clamp(errs2, 0, n).long(), ri * (errs2 > 0))
        acc["iter_hist"].index_add_(0, torch.clamp(iters, 0, T).long(), ri)
        acc["weight_hist"].index_add_(0, torch.clamp(errs, 0, mw).long(),
                                      ri * word)
        if record:
            p, rc = _record_slots(rc, ri, retire, rec_cap)
            rec["gid"][p] = st["gid"]
            rec["iters"][p] = iters
            rec["errs"][p] = errs.to(torch.int32)
            rec["hard"][p] = hard.t().to(torch.int8)

        # refill the retired and idle lanes from the pool, in lane order
        want = retire | idle
        can, local, ranks = _refill_plan(want, ptr, pool.shape[0])
        ych_new = dec.prep(torch.index_select(pool, 0, local))
        st = dict(
            st,
            fresh=can,  # the messages merge at the next iterate
            ych=_merge(can, ych_new, st["ych"]),
            d=_merge(can, d_of(ych_new), d),
            done=torch.where(can, pool_sat0[local], done) | (want & ~can),
            idle=want & ~can,
            iters=torch.where(can, 0, iters),
            unc=torch.where(can, pool_unc[local], st["unc"]),
            gid=torch.where(can, base + ptr + ranks, st["gid"]),
        )
        return st, ptr + can.sum(), rc

    def iterate(st, first):
        # the decisions freeze once a frame is done (or capped); the
        # messages always advance.  Refilled lanes read init(ych) in place
        # of their stale messages at the first iterate after a boundary
        # (``first``; the later ones have no fresh lane).
        act = ~st["done"] & (st["iters"] < T)
        if not first:
            msgs, total = dec.step(st["msgs"], st["ych"])
        elif dec.step_fresh is not None:
            msgs, total = dec.step_fresh(st["msgs"], st["ych"], st["fresh"])
        else:
            msgs_in = _merge(st["fresh"], dec.init(st["ych"]), st["msgs"])
            msgs, total = dec.step(msgs_in, st["ych"])
        d = _merge(act, d_of(total), st["d"])
        return dict(
            st,
            msgs=msgs,
            fresh=torch.zeros_like(st["fresh"]) if first else st["fresh"],
            d=d,
            iters=st["iters"] + act.to(torch.int32),
            done=st["done"] | dec.satisfied(d),
        )

    def call(state, pool, pool_unc, pool_sat0, base, ptr0=0):
        device = pool.device
        drain = ptr0 >= pool.shape[0]
        ptr = torch.full((), ptr0, dtype=torch.int64, device=device)
        acc = _zeros(device, frames=(), bit_errs=(), word_errs=(),
                     iter_sum=(), sat=(), unc_sum=(), iter_hist=(T + 1,),
                     weight_hist=(mw + 1,))
        if dec.errs2_of is not None:
            acc.update(_zeros(device, errs2=(), weight2_hist=(n + 1,)))
        rec = rc = None
        if record:
            rc = torch.zeros((), dtype=torch.int64, device=device)
            rec = dict(
                gid=torch.full((rec_cap + 1,), -1, dtype=torch.int64,
                               device=device),
                iters=torch.zeros((rec_cap + 1,), dtype=torch.int32,
                                  device=device),
                errs=torch.zeros((rec_cap + 1,), dtype=torch.int32,
                                 device=device),
                hard=torch.zeros((rec_cap + 1, n), dtype=torch.int8,
                                 device=device),
            )
        st = state
        for r in range(rounds):
            if drain and r > 0 and bool(st["idle"].all()):
                break  # a drain call ends once every lane is idle
            st, ptr, rc = boundary(st, ptr, acc, rec, rc, pool, pool_unc,
                                   pool_sat0, base)
            for j in range(K):
                # a drain call refills nothing, so no lane is ever fresh
                st = iterate(st, first=(j == 0 and not drain))
        acc["consumed"] = ptr - ptr0
        if record:
            acc["rc"] = rc
        return st, acc, rec

    if mesh is not None:
        return shard_call(lambda device: call, mesh)
    return call


class MeshState(list):
    """The lane states of this rank's data slots, in slot order; ``home``,
    the device their counters gather on, and ``ranks``, how many ranks the
    mesh spans."""

    def __init__(self, states, home, ranks=1):
        super().__init__(states)
        self.home = home
        self.ranks = ranks


def slot_mesh(mesh, device, who: str):
    """``mesh``, or without one a one-slot mesh on ``device`` (the card
    unless the caller asks for the CPU)."""
    if mesh is not None:
        return mesh
    return Mesh(((world()[0], _card_or_raise(device, who)),))


def mesh_setup(mesh, lanes, pool_frames, default_pool, init):
    """The mesh plumbing of the simulate drivers: validate divisibility
    (rounding a default pool up to the data axis size) and make each of
    this rank's data slots its state ``init(lanes / nd, device)``.
    Returns (nd, pool_frames, MeshState)."""
    slots = mesh.data_slots()
    nd = mesh.n_data
    if default_pool:
        pool_frames = -(-pool_frames // nd) * nd  # round up to nd
    if lanes % nd or pool_frames % nd:
        raise ValueError(
            f"lanes ({lanes}) and pool_frames ({pool_frames}) must be "
            f"divisible by the 'data' axis size {nd}"
        )
    states = [init(lanes // nd, dev) for _, dev in slots]
    return nd, pool_frames, MeshState(states, mesh.home, mesh.ranks)


def mesh_pools(mesh, base, local_frames, build):
    """The per-slot pools of the window at ``base``: slot ``di``'s is
    ``build(base + di·local_frames, local_frames, device)``, a (rows, unc,
    sat0) triple; returned as three per-slot lists, the call's pool
    arguments."""
    pools = [build(base + di * local_frames, local_frames, dev)
             for di, dev in mesh.data_slots()]
    return tuple(list(part) for part in zip(*pools))


def shard_call(call_for, mesh):
    """A stream call sharded over the mesh's data slots.

    ``call_for(device)`` gives a slot's single-device call (the same call
    for every device, or one bound to the device's tables).  The sharded
    ``call(state, pool, pool_unc, pool_sat0, base, *rest)`` takes per-slot
    lists of states and pools, runs each slot with its window's first gid
    ``base + di·len(pool)`` (``rest``, e.g. the GDBF call's seed, sigma,
    cfg and ptr0, passes through), sums the counters on the rank's home
    device and, when the mesh spans several ranks, all-reduces them in one
    collective.  Returns (MeshState, acc, rec), rec
    the per-slot records (each with the slot's record count ``rc_local``)
    or None."""
    slots = mesh.data_slots()
    home = mesh.home
    calls = {dev: call_for(dev) for _, dev in slots}

    def sharded(state, pool, pool_unc, pool_sat0, base, *rest):
        outs = [calls[dev](st, rows, unc, sat0, base + di * rows.shape[0],
                           *rest)
                for (di, dev), st, rows, unc, sat0 in zip(slots, state, pool,
                                                          pool_unc,
                                                          pool_sat0)]
        acc = {}
        for _, a, _ in outs:
            for k, v in a.items():
                acc[k] = acc[k] + v.to(home) if k in acc else v.to(home)
        if mesh.ranks > 1:
            acc = all_reduce_dict(acc)
        recs = None
        if outs[0][2] is not None:
            recs = [dict(r, rc_local=a["rc"]) for _, a, r in outs]
        return MeshState([o[0] for o in outs], home, mesh.ranks), acc, recs

    return sharded


def next_base(base: int, a: dict, nd: int, pool_frames: int) -> int:
    """The next window's first gid: one slot reuses the rows it did not
    consume; several advance by the whole pool, so that the slots' gid
    ranges never collide."""
    return base + (a["consumed"] if nd == 1 else pool_frames)


def _all_idle(state) -> bool:
    """Every lane idle; under a mesh, on every slot of every rank (one
    all-reduced count, so every rank takes the same branch)."""
    if not isinstance(state, MeshState):
        return bool(state["idle"].all())
    busy = sum((~st["idle"]).sum().to(state.home) for st in state)
    if state.ranks > 1:
        busy = all_reduce_sum(busy)
    return int(busy) == 0


def fetch(acc) -> dict:
    """The counters of a call on the host, in one copy: ints for the
    scalars, int64 numpy arrays for the histograms."""
    keys = list(acc)
    flat = torch.cat([acc[k].reshape(-1) for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        size = acc[k].numel()
        out[k] = int(flat[at]) if acc[k].dim() == 0 else flat[at:at + size]
        at += size
    return out


#: Default channel-pool byte budget per call of the simulate drivers;
#: override per run with ``pool_bytes=``.
DEFAULT_POOL_BYTES = 2**30


def pool_policy(
    lanes: int,
    refill_every: int,
    rounds_per_call,
    avg_iters_hint: float,
    row_bytes: int,
    pool_bytes=None,
    default_rounds: int = 64,
):
    """``(rounds_per_call, pool_frames)`` under a pool byte budget.

    The pool is sized to the expected consumption of a call, ``lanes ×
    rounds × refill_every / avg_iters_hint`` rows plus one lane width, and
    capped at ``pool_bytes`` (default :data:`DEFAULT_POOL_BYTES`):

      * ``rounds_per_call=None`` (auto): from ``default_rounds``, the
        rounds shrink until the expected consumption fits the budget —
        smaller calls, the same statistics (the counted frames depend only
        on gid order and the stop rule);
      * an explicit ``rounds_per_call`` is kept; only the pool is capped
        (an undersized pool idles lanes at the end of a call: correct,
        slower).

    The pool never drops below two lane widths (a boundary must be able to
    fill every lane), so a tiny budget is exceeded.
    """
    if pool_bytes is None:
        pool_bytes = DEFAULT_POOL_BYTES
    auto = rounds_per_call is None
    r = default_rounds if auto else rounds_per_call
    hint = max(avg_iters_hint, 1.0)
    cap = max(2 * lanes, int(pool_bytes // max(row_bytes, 1)))
    want = lanes + int(lanes * r * refill_every / hint)
    if want > cap and auto:
        r = max(1, int((cap - lanes) * hint // (lanes * refill_every)))
        want = lanes + int(lanes * r * refill_every / hint)
    return r, min(want, cap)


def run_drain(call, state, pool_args, base, ptr0, take, num_steps,
              iters_per_call, extra=()):
    """Drain the lanes in flight: call again with the pool pre-exhausted
    (``ptr0`` = pool length) until every lane is idle, folding each call's
    counters through ``take``.

    The test is lane idleness, not zero retirements: a drain call whose
    budget (rounds × refill_every) is below a lane's remaining iterations
    retires nothing while work remains.  ceil(num_steps / iters_per_call)
    calls retire everything.  ``extra`` carries the arguments that precede
    ptr0 in the GDBF call (seed, sigma, cfg).  Under a mesh, ``ptr0`` is a
    slot's pool length and the idleness test covers every slot and rank.
    """
    for _ in range(2 + num_steps // max(iters_per_call, 1)):
        if _all_idle(state):
            break
        state, acc, _rec = call(state, *pool_args, base, *extra, ptr0)
        take(fetch(acc))
    return state


def build_channel_pool(
    dec: StreamDecoder,
    seed: int,
    base: int,
    pool_frames: int,
    n: int,
    sigma: float,
    preprocess=None,
    pool_dtype=None,
    device="cuda",
):
    """Pool rows ``[F, R]`` of frames base … base+F−1, with ``unc [F]``
    int32 (the uncoded bit errors) and ``sat0 [F]`` bool.

    Row i is frame ``base + i``'s channel of the all-(+1) word, ``y = 1 +
    σ·n`` drawn by kernel B2 keyed by (seed, frame) — the row
    :func:`.montecarlo.simulate` gives that frame — mapped by
    ``preprocess`` (LLR or quantizer) and ``dec.prep_raw``, then cast to
    ``pool_dtype`` (an f16 pool: the stored rows are the channel the
    decoder sees, upcast exactly at the step).  ``sat0`` is the syndrome of
    each row's iteration-0 decisions, computed once here so a refill needs
    no syndrome pass (all False for a decoder without
    ``check_at_injection``).
    """
    y = awgn_all_zero(seed, base, pool_frames, n, sigma, device)
    # uncoded decision (y > 0 ? +1 : −1) against c = +1, as simulate counts
    unc = (y <= 0).sum(dim=1).to(torch.int32)
    rows = preprocess(y) if preprocess is not None else y
    if dec.prep_raw is not None:
        rows = dec.prep_raw(rows)
    if pool_dtype is not None:
        rows = rows.to(pool_dtype)
    if dec.check_at_injection:
        sat0 = dec.satisfied(_sign8(dec.prep(rows)))
    else:
        sat0 = torch.zeros((pool_frames,), dtype=torch.bool, device=y.device)
    return rows, unc, sat0


def _card_or_raise(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device 'cuda', but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    return device


def simulate_stream(
    code_n: int,
    dec: StreamDecoder,
    snr_db: float,
    rate: float,
    num_iterations: int,
    stop: Optional[StopRule] = None,
    lanes: int = 4096,
    refill_every: int = 1,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 8.0,
    seed: int = 0,
    preprocess=None,
    pool_dtype=None,
    verbose: bool = False,
    max_calls: int = 100000,
    pool_bytes: Optional[int] = None,
    device="cuda",
    mesh=None,
) -> MCStats:
    """Monte-Carlo loop over the streaming driver (all-zero codewords).

    The stop rule of :func:`.montecarlo.simulate`, evaluated between calls.
    After it fires, the lanes in flight are DRAINED (:func:`run_drain`), so
    every injected frame is counted once: a frame holds a lane in
    proportion to its decode time, so the frames in flight are enriched in
    slow and failing ones, and dropping them would bias FER low.  The
    counted frames are then the gid prefix 0 … total_words−1, whatever the
    call geometry, and their totals equal ``simulate``'s over those frames
    with the batch decoder.

    ``pool_frames`` defaults to the expected consumption of a call plus one
    lane width, capped at ``pool_bytes`` (:func:`pool_policy`).
    ``device`` defaults to the card; ``device="cpu"`` runs the kernels'
    plain twins.

    ``mesh``: stream over the mesh's data slots (their devices replace
    ``device``); ``lanes`` and ``pool_frames`` are global and must divide
    by the axis size.  Each slot streams its lanes against its own gid
    window of the pool (see the module docstring), so every counted frame
    equals its batch decode, and the counters are all-reduced: the stop
    rule sees global totals on every rank.
    """
    mesh = slot_mesh(mesh, device, "simulate_stream")
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code_n))
    sigma = snr_to_sigma(snr_db, rate)
    pdt = pool_dtype or torch.float32
    default_pool = pool_frames is None
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint,
            code_n * pdt.itemsize, pool_bytes)
    elif rounds_per_call is None:
        rounds_per_call = 64
    iters_per_call = rounds_per_call * refill_every

    def pool_of(base, frames, dev):
        return build_channel_pool(dec, seed, base, frames, code_n, sigma,
                                  preprocess, pool_dtype, dev)

    nd, pool_frames, state = mesh_setup(
        mesh, lanes, pool_frames, default_pool,
        lambda n_lanes, dev: stream_init(dec, n_lanes, code_n, pdt, dev))
    call = make_stream_call(dec, code_n, num_iterations, rounds_per_call,
                            refill_every, mesh=mesh)

    stats = MCStats(n=code_n)
    stats.iteration_hist = np.zeros(num_iterations + 1, np.int64)
    t0 = time.perf_counter()

    def take(a):
        stats.total_words += a["frames"]
        stats.total_bits += a["frames"] * code_n
        stats.errors += a["bit_errs"]
        stats.word_errors += a["word_errs"]
        stats.total_iterations += a["iter_sum"]
        stats.satisfied_words += a["sat"]
        stats.uncoded_errors += a["unc_sum"]
        stats.iteration_hist += a["iter_hist"]
        stats.error_weight_hist[:code_n] += a["weight_hist"][1:]

    base = 0
    pool = None
    for _ in range(max_calls):
        if stop.done(stats.errors, stats.word_errors, stats.total_words):
            break
        pool = mesh_pools(mesh, base, pool_frames // nd, pool_of)
        state, acc, _rec = call(state, *pool, base)
        a = fetch(acc)
        take(a)
        base = next_base(base, a, nd, pool_frames)
        if verbose:
            print(stats.incremental_report())
    if pool is not None:
        state = run_drain(call, state, pool, base, pool_frames // nd, take,
                          num_iterations, iters_per_call)
    stats.wall_seconds = time.perf_counter() - t0
    return stats


# --------------------------------------------------------------- non-binary


def nb_qspa_stream(code: Code, n0: float, q: int = 0,
                   storage_dtype=None) -> StreamDecoder:
    """Stream adapter for :func:`..decoders.nb_qspa.decode_nb_qspa`.

    Pool rows are the max-normalized log priors flattened to ``[B, N·q]``
    f32: ``prep_raw`` runs the batch decoder's front end
    (:func:`..channel.nb.symbol_priors`, then ``log_of``) once per frame at
    pool build, so ``prep`` is a pure relayout to [N, q, B] and a streamed
    frame equals a batch decode of its bit-level channel row.  Decisions
    are the int8 symbols; the primary error count is the frame's bit errors
    against the all-zero word (``errs_of``), the second its symbol errors
    (``errs2_of``).  ``step_fresh`` merges the refilled lanes at the CN's
    gathered rows (``cn_update(fresh=)``)."""
    from ..channel.nb import symbol_priors
    from ..decoders.nb_qspa import nb_qspa_machine

    q = q or code.q
    m_bits = q.bit_length() - 1
    M = nb_qspa_machine(code, q, torch.float32, storage_dtype)

    def prep(rows):
        return rows.reshape(-1, code.n, q).permute(1, 2, 0).contiguous()

    def prep_raw(y):
        # bit-level samples [F, N·m] -> prepped pool rows [F, N·q]
        yb = y.to(torch.float32).reshape(-1, code.n, m_bits)
        lp = M["log_of"](symbol_priors(yb, n0, q).permute(1, 2, 0))
        return lp.permute(2, 0, 1).reshape(-1, code.n * q)

    def step(v2c, ych):
        return M["vn_update"](M["cn_update"](v2c), ych)

    def step_fresh(v2c, ych, fresh):
        return M["vn_update"](M["cn_update"](v2c, ych, fresh), ych)

    def errs_of(d):  # bit errors against the all-zero codeword
        acc = ((d >> 0) & 1).sum(dim=0, dtype=torch.int32)
        for i in range(1, m_bits):
            acc = acc + ((d >> i) & 1).sum(dim=0, dtype=torch.int32)
        return acc

    return StreamDecoder(
        prep=prep,
        init=M["init"],
        step=step,
        step_fresh=step_fresh,
        satisfied=M["syndrome_ok"],
        hard=lambda d: d,
        d_of=M["decide"],
        errs_of=errs_of,
        errs2_of=lambda d: (d != 0).sum(dim=0, dtype=torch.int32),
        prep_raw=prep_raw,
    )


def build_channel_pool_nb(dec: StreamDecoder, seed: int, base: int,
                          pool_frames: int, n: int, q: int, sigma: float,
                          device="cuda"):
    """NB pool of frames base … base+F−1: kernel B2's bit-level rows
    ``[F, N·m]`` (the rows :func:`.montecarlo_nb.simulate_nb` gives those
    frames), prepped by ``dec.prep_raw`` to ``[F, N·q]`` log priors; ``unc``
    the uncoded symbol errors of the iteration-0 decisions and ``sat0``
    their syndrome."""
    m_bits = q.bit_length() - 1
    y = awgn_all_zero(seed, base, pool_frames, n * m_bits, sigma, device)
    rows = dec.prep_raw(y)
    d0 = dec.d_of(dec.prep(rows))  # [N, F] symbols
    unc = (d0 != 0).sum(dim=0, dtype=torch.int32)
    return rows, unc, dec.satisfied(d0)


def simulate_stream_nb(
    code: Code,
    snr_db: float,
    num_iterations: int,
    rate: Optional[float] = None,
    stop: Optional[StopRule] = None,
    lanes: int = 512,
    refill_every: int = 1,
    rounds_per_call: Optional[int] = None,
    pool_frames: Optional[int] = None,
    avg_iters_hint: float = 6.0,
    seed: int = 0,
    storage_dtype=None,
    verbose: bool = False,
    max_calls: int = 100000,
    pool_bytes: Optional[int] = None,
    device="cuda",
):
    """NB Monte-Carlo over the streaming driver ->
    :class:`.montecarlo_nb.NBMCStats`.

    The statistics of :func:`.montecarlo_nb.simulate_nb` (bit errors drive
    the stop rule; a word error is a frame with any symbol error) without
    the straggler tax, with the drain of :func:`simulate_stream`: the
    counted frames are the gid prefix 0 … total_words−1, each equal to its
    batch decode.  Pool rows are f32 log priors of width N·q (no pool dtype:
    narrowing them would change the values against a batch decode).
    ``device`` defaults to the card; ``device="cpu"`` runs the plain twins.
    """
    from .montecarlo_nb import NBMCStats

    device = _card_or_raise(device, "simulate_stream_nb")
    q = code.q
    m_bits = q.bit_length() - 1
    rate = rate if rate is not None else code.rate
    stop = stop or StopRule(min_word_errors=default_min_word_errors(code.n))
    n0 = float(snr_to_n0(snr_db, rate))
    sigma = float(np.sqrt(n0 / 2.0))
    width = code.n * q
    if pool_frames is None:
        rounds_per_call, pool_frames = pool_policy(
            lanes, refill_every, rounds_per_call, avg_iters_hint, width * 4,
            pool_bytes, default_rounds=32)
    elif rounds_per_call is None:
        rounds_per_call = 32
    code_d = code.to(device)
    dec = nb_qspa_stream(code_d, n0, q, storage_dtype)
    state = stream_init(dec, lanes, width, torch.float32, device)
    call = make_stream_call(dec, code.n, num_iterations, rounds_per_call,
                            refill_every, max_weight=code.n * m_bits)

    stats = NBMCStats(n=code.n, q=q)
    stats.iteration_hist = np.zeros(num_iterations + 1, np.int64)
    t0 = time.perf_counter()

    def take(a):
        stats.total_words += a["frames"]
        stats.total_symbols += a["frames"] * code.n
        stats.total_bits += a["frames"] * code.n * m_bits
        stats.bit_errors += a["bit_errs"]
        stats.symbol_errors += a["errs2"]
        stats.word_errors += a["word_errs"]
        stats.total_iterations += a["iter_sum"]
        stats.uncoded_symbol_errors += a["unc_sum"]
        stats.iteration_hist += a["iter_hist"]
        stats.bit_weight_hist += a["weight_hist"][1:]
        stats.symbol_weight_hist += a["weight2_hist"][1:]

    base = 0
    pool = None
    for _ in range(max_calls):
        if stop.done(stats.bit_errors, stats.word_errors, stats.total_words):
            break
        pool = build_channel_pool_nb(dec, seed, base, pool_frames, code.n, q,
                                     sigma, device)
        state, acc, _rec = call(state, *pool, base)
        a = fetch(acc)
        take(a)
        base += a["consumed"]
        if verbose:
            print(f"stream_nb: {stats.total_words} frames, "
                  f"SER={stats.ser:.4g} BER={stats.ber:.4g}")
    if pool is not None:
        state = run_drain(call, state, pool, base, pool_frames, take,
                          num_iterations, rounds_per_call * refill_every)
    stats.wall_seconds = time.perf_counter() - t0
    return stats
