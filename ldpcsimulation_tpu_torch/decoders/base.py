"""Shared decoder machinery: results, sign conventions, storage casts, the
flooding driver.

Port of the soft-decoder parts of ``ldpcsimulation_tpu.decoders.base``.
Decoders take channel samples as ``[B, N]`` and keep the batch on the LAST
axis inside (``[rows, B]``), so the kernels' loads coalesce along B.

Sign conventions (a bit-exactness trap):
  * BP / min-sum / DDBMP: ``sgn(0) = +1``
  * GDBF family / NGDBFhw: ``sgn(0) = -1``
"""

from __future__ import annotations

import dataclasses

import torch

from .. import spans
from ..kernels.bp import sgn_pos
from ..kernels.check import parity_check
from ..kernels.merge import et_merge
from ..kernels.minsum import minsum_cn_scan, minsum_vn_update
from .qc_ops import slot_graph, syndrome_bipolar

__all__ = [
    "DecodeResult",
    "NoiseKey",
    "sgn_pos",
    "sgn_neg",
    "storage_cast",
    "minsum_iteration",
    "run_flooding",
    "run_flooding_soft",
    "gather_cn",
    "gather_vn",
    "syndrome_from_hard",
    "check_columns",
    "check_satisfied",
    "xor_satisfied",
    "all_done",
]


@dataclasses.dataclass
class DecodeResult:
    """Outcome of a batched decode.

    hard:       [B, N] int32, bipolar ±1 decisions.
    iterations: [B] int32 — with early termination, the update rounds each
                frame used (0 when the channel decisions already check out);
                for fixed-trip decodes, T.
    satisfied:  [B] bool — all parity checks satisfied at exit.
    """

    hard: torch.Tensor
    iterations: torch.Tensor
    satisfied: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NoiseKey:
    """Noise coordinates of one batch: the run seed and the global index
    of the batch's first frame.  A decoder that draws noise keys row ``i``
    of the batch by (seed, frame0 + i, step), so a frame decodes the same
    in any batch (kernels B3/B4 of :mod:`..kernels.channel`)."""

    seed: int
    frame0: int


def storage_cast(x: torch.Tensor, sdt: torch.dtype) -> torch.Tensor:
    """Cast messages to the storage dtype, SATURATING at its finite range.

    min-sum magnitudes grow roughly ×(dv+1) per iteration, so deep runs on
    high-degree codes pass float16's 65504, and a plain cast gives inf.
    No-op for f32.
    """
    if sdt.is_floating_point and torch.finfo(sdt).bits < 32:
        m = torch.finfo(sdt).max
        x = torch.clamp(x, -m, m)
    return x.to(sdt)


def minsum_iteration(v2c: torch.Tensor, y: torch.Tensor, cn_rows, vn_rows,
                     variant="plain", alpha=1.0, delta=0.0,
                     storage_dtype=None):
    """One flooding min-sum iteration on kernels B1 and B5 through a plan's
    tables: (v2c' in the storage dtype, total in y's dtype).

    The storage dtype is ``storage_dtype``, else the channel's.  Messages
    in it take B1's storage-typed store, and B5 writes v2c' over c2v.
    Messages in another dtype (the JAX steps take them): B1 scans v2c in
    its own dtype into f32, B5 runs on f32 storage, and v2c' is
    :func:`storage_cast` to the storage dtype — the JAX steps'
    ``storage_cast(total − c2v, sdt)``.
    """
    sdt = storage_dtype if storage_dtype is not None else y.dtype
    store = sdt if v2c.dtype == sdt else torch.float32
    c2v = minsum_cn_scan(v2c, cn_rows, variant, alpha, delta,
                         out_dtype=store)
    v2c, total = minsum_vn_update(c2v, y, vn_rows)
    return (v2c if store == sdt else storage_cast(v2c, sdt)), total


def sgn_neg(x: torch.Tensor) -> torch.Tensor:
    """sgn(0) = -1 convention (GDBF family)."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


def gather_cn(code, v2c_flat: torch.Tensor) -> torch.Tensor:
    """[N*dv_max, B] v2c -> [M, dc_max, B] per-check incoming messages
    (padding slots read VN slot 0)."""
    g = v2c_flat[code.cn_from_vn.reshape(-1).long()]
    return g.reshape(code.m, code.dc_max, -1)


def gather_vn(code, c2v_flat: torch.Tensor) -> torch.Tensor:
    """[M*dc_max, B] c2v -> [N, dv_max, B] per-variable incoming messages
    (padding slots read CN slot 0)."""
    g = c2v_flat[code.vn_from_cn.reshape(-1).long()]
    return g.reshape(code.n, code.dv_max, -1)


def syndrome_from_hard(code, d: torch.Tensor) -> torch.Tensor:
    """Bipolar syndrome per check from hard decisions (the bit-flip
    decoders' CN update), through kernel B6 on the slot arrays' table.

    d: [N, B] ±1 int8/int32.  Returns [M, B] in d's dtype, +1 satisfied and
    −1 unsatisfied; padding slots contribute +1.
    """
    return syndrome_bipolar(slot_graph(code, d.device), d)


def xor_satisfied(cols: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] ±1 int8/int32 -> [B] bool, all parity checks satisfied:
    per check the XOR of its negative decisions (the sign of the JAX
    package's product), kernel B6.

    cols: [M, dc] int64 column of each check slot, N in an absent slot (a
    sentinel column that is never negative).
    """
    return parity_check(cols, d.contiguous())


def check_columns(code) -> torch.Tensor:
    """[M, dc_max] int64: ``cn_vn`` with the sentinel column N in padding
    slots (the table :func:`xor_satisfied` reads)."""
    return torch.where(code.cn_mask, code.cn_vn, code.n).long()


def check_satisfied(code, d: torch.Tensor) -> torch.Tensor:
    """d: [N, B] ±1 -> [B] bool, all parity checks satisfied."""
    return xor_satisfied(slot_graph(code, d.device).check_cols, d)


def _decide(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """±1 decisions (sgn(0) = −1) made in ``dtype`` (no int64 temporary)."""
    one = torch.ones((), dtype=dtype, device=total.device)
    return torch.where(total > 0, one, -one)


def all_done(done: torch.Tensor) -> bool:
    """The host's read of a decoder's all-done flag: whether every frame of
    ``done`` [B] is done (a sync with the card)."""
    with spans.span(spans.EXIT_CHECK):
        return bool(done.all())


def run_flooding(
    state0,
    step,
    decide,
    satisfied_of,
    num_iterations: int,
    early_termination: bool,
    batch: int,
):
    """Iteration loop for decoders whose state is a tuple of tensors (the
    layered ones).

    step(state) -> state'        — one full decoder iteration.
    decide(state) -> d           — hard decisions, batch last.
    satisfied_of(d) -> [B] bool  — all checks satisfied per frame.

    Fixed-trip: T steps, one decision at the end, ``iterations`` is T.
    Early termination: ``decide(state0)`` is checked first; the loop stops
    when every frame checks out or at T, only the decision carry is masked
    (a satisfied frame's state may keep evolving — its latched decision is
    what the decoder returns), and ``iterations`` counts the update rounds
    each frame used.  The host reads the all-done flag once per iteration;
    each executed round's decisions and their latch (plain torch) run under
    the span ``ldpc.decode.et_merge``.

    Returns (d, iterations [B] int32, satisfied [B] bool).
    """
    if not early_termination:
        state = state0
        for _ in range(num_iterations):
            state = step(state)
        d = decide(state)
        iters = torch.full((batch,), num_iterations, dtype=torch.int32,
                           device=d.device)
        return d, iters, satisfied_of(d)

    state = state0
    d = decide(state)
    done = satisfied_of(d)
    iters = torch.zeros((batch,), dtype=torch.int32, device=d.device)
    t = 0
    while t < num_iterations and not all_done(done):
        state = step(state)
        with spans.span(spans.ET_MERGE):
            act = ~done
            d = torch.where(act, decide(state), d)
            iters = torch.where(act, t + 1, iters)
        done = done | satisfied_of(d)
        t += 1
    return d, iters, done


def run_flooding_soft(
    total0,
    msgs0,
    step,
    satisfied_of,
    num_iterations: int,
    early_termination: bool,
    batch: int,
):
    """Flooding driver for soft decoders whose hard decisions are the sign
    of a posterior total that ``step`` computes anyway.

    step(msgs) -> (msgs', total)  — one full iteration.
    total0: the pre-iteration posterior (the channel term), in the layout
    of step's total (batch last); gives the decisions when T == 0 and the
    early-termination initial state.
    satisfied_of(d) -> [B] bool, with d in total's layout.

    Fixed-trip: T−1 message-only iterations, then one whose total feeds the
    decisions.  Early termination: the loop stops when every frame checks
    out or at T; only the int8 decision carry is masked (a satisfied
    frame's messages may keep evolving — its latched decision is what the
    decoder returns), and ``iterations`` counts the update rounds each frame
    used.  The host reads the all-done flag once per iteration; each
    executed round's decision merge, kernel B10 (``kernels/merge.py::
    et_merge``: the decisions and round counts latched in place), runs
    under the span ``ldpc.decode.et_merge``.

    Returns (d int32 in total's layout, iterations [B] int32, done [B] bool).

    No reference to a superseded message buffer or total is kept: a caller
    that passes ``msgs0`` without a name of its own lets it go after the
    first step (DVB-S2 at B=32768 fits on one card only so).
    """
    device = total0.device
    msgs, msgs0 = msgs0, None
    if not early_termination:
        if num_iterations <= 0:
            d = _decide(total0, torch.int32)
        else:
            for _ in range(num_iterations - 1):
                msgs = step(msgs)[0]
            total, msgs = step(msgs)[1], None
            d = _decide(total, torch.int32)
        iters = torch.full((batch,), num_iterations, dtype=torch.int32,
                           device=device)
        return d, iters, satisfied_of(d)

    d = _decide(total0, torch.int8)
    done = satisfied_of(d)
    iters = torch.zeros((batch,), dtype=torch.int32, device=device)
    t = 0
    while t < num_iterations and not all_done(done):
        msgs, total = step(msgs)
        with spans.span(spans.ET_MERGE):
            et_merge(total, done, d, iters, t + 1)
        done = done | satisfied_of(d)
        t += 1
    return d.to(torch.int32), iters, done
