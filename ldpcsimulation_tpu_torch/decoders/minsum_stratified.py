"""Flooding min-sum on the stratified slot grids of a code without QC
structure (the 802.3an RS-LDPC class; :mod:`..codes.stratified`).

Port of ``ldpcsimulation_tpu.decoders.minsum_stratified``, bit for bit.
The JAX decoder moves messages VN slots → CN slots → VN slots with two
one-hot einsums on the TPU's MXU and runs an order-independent check update
between them.  Here the check update is kernel B1 with its routing inside:
its table is ``cn_from_vn`` reshaped to ``[mb·h, kg]`` (check ``(b, i)``'s
slot ``g`` reads VN-slot row ``(b·kg + g)·w + j``), it reads the
``[mb·kg·w, B]`` VN-slot planes and writes c2v back into the same rows, so
both einsums fold into B1's reads and writes.  B1 leaves the VN slots that
no check names unwritten; only those rows are set to exact zeros, as the
one-hot's empty rows give.  The stored messages keep ``total`` in those
slots where JAX stores 0: no reader takes them (B1 reads only the rows its
table names, the fold reads c2v), so the decode is unchanged.

Why B1's slot-order scan is exact here although the CN slots are in
column-group order, not alist order: the magnitude a slot receives does not
depend on the order.  With one minimum the minimum's slot gets min2 and the
others min1 in any order; with two or more tied minima min2 = min1 and
every slot gets min1, so the alist-rank tie-break of the JAX formulation
(``cn_rank``) can change no value.  The sign product is order-free (±1).

After B1 the step is the JAX one: the c2v planes cast to the channel grid's
dtype, the strata left-folded ``c2v[0] + c2v[1] + …`` and the channel term
added last (``yg + acc``), then the saturating store of ``total − c2v``.
With contiguous strata the fold order is the alist's ascending-row order,
so the totals equal the slot-array decoder's too.

The index gathers below (:func:`stratified_to_cn`, :func:`stratified_to_vn`)
serve DD-BMP; BP's check update takes :attr:`StratifiedPlan.cn_rows` as B1
does (kernel B8, :mod:`.bp_stratified`).  A gather cannot turn ``0·inf``
into NaN as the JAX matmul interleaver can; messages are finite by
construction anyway (the saturating f16 store, BP's clamp).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..codes.stratified import StratifiedCode
from ..kernels.minsum import VARIANTS, minsum_cn_scan
from .base import DecodeResult, run_flooding_soft, storage_cast, xor_satisfied

__all__ = [
    "StratifiedPlan",
    "stratified_plan",
    "decode_minsum_stratified",
    "stratified_to_cn",
    "stratified_to_vn",
    "stratified_check_satisfied",
    "stratified_grid",
    "stratified_init",
    "stratified_hard",
    "stratified_zero_pad",
    "stratified_minsum_step",
]


@dataclasses.dataclass(frozen=True, eq=False)
class StratifiedPlan:
    """Tables of one stratified structure on one device.

    sc:         the structure with its tables on the plan's device.
    cn_rows:    [mb·h, kg] int32 — ``cn_from_vn``: B1's and B8's routing
                table.
    check_cols: [mb·h, kg] int64 — the grid position ``g·w + j`` of each CN
                slot's column, the sentinel ``kg·w`` in an absent slot; the
                syndrome check's table.
    vn_pad:     [mb·kg·w, 1] bool — VN slots without an edge (None if
                every slot has one).
    vn_absent:  [·] int64 — the rows of those slots (None without any).
    col_idx:    [kg·w] int64 — each grid cell's column (0 in a pad cell).
    col_pad:    [kg, w, 1] bool — pad cells (None without any).
    pos_of_col: [N] int64.
    """

    sc: StratifiedCode
    cn_rows: torch.Tensor
    check_cols: torch.Tensor
    vn_pad: Optional[torch.Tensor]
    vn_absent: Optional[torch.Tensor]
    col_idx: torch.Tensor
    col_pad: Optional[torch.Tensor]
    pos_of_col: torch.Tensor


@functools.lru_cache(maxsize=None)
def stratified_plan(sc: StratifiedCode, device) -> StratifiedPlan:
    """The tables of ``sc`` on ``device`` (built once, cached)."""
    sc = sc.to(device)
    rows = sc.cn_from_vn.reshape(sc.mb * sc.h, sc.kg)
    cells = sc.kg * sc.w
    vn_pad = ~sc.vn_valid.reshape(-1, 1)
    col_pad = (sc.col_slot < 0)[..., None]
    return StratifiedPlan(
        sc=sc,
        cn_rows=rows.to(torch.int32).contiguous(),
        check_cols=torch.where(rows >= 0, rows % cells, cells).long(),
        vn_pad=vn_pad if bool(vn_pad.any()) else None,
        vn_absent=(vn_pad[:, 0].nonzero()[:, 0] if bool(vn_pad.any())
                   else None),
        col_idx=sc.col_slot.clamp(min=0).reshape(-1).long(),
        col_pad=col_pad if bool(col_pad.any()) else None,
        pos_of_col=sc.pos_of_col.long(),
    )


def _masked(x: torch.Tensor, pad: Optional[torch.Tensor]) -> torch.Tensor:
    """x with exact zeros (of x's dtype) where ``pad`` holds."""
    if pad is None:
        return x
    return torch.where(pad, torch.zeros((), dtype=x.dtype, device=x.device),
                       x)


def stratified_zero_pad(sc: StratifiedCode, x: torch.Tensor) -> torch.Tensor:
    """VN-slot planes (``[mb, kg, w, B]`` or flat ``[mb·kg·w, B]``) with
    exact zeros in the slots without an edge."""
    pad = stratified_plan(sc, x.device).vn_pad
    return _masked(x.reshape(-1, x.shape[-1]), pad).view(x.shape)


def stratified_to_cn(sc: StratifiedCode, x_vn: torch.Tensor) -> torch.Tensor:
    """VN slots [mb, kg, w, B] -> CN slots [mb, h, kg, B] (a row gather);
    absent CN slots hold exact zeros of x's dtype."""
    p = stratified_plan(sc, x_vn.device)
    b = x_vn.shape[-1]
    rows = p.cn_rows.reshape(-1)
    out = x_vn.reshape(-1, b)[rows.clamp(min=0).long()]
    return _masked(out, (rows < 0)[:, None]).view(sc.mb, sc.h, sc.kg, b)


def stratified_to_vn(sc: StratifiedCode, x_cn: torch.Tensor) -> torch.Tensor:
    """CN slots [mb, h, kg, B] -> VN slots [mb, kg, w, B] (a row gather);
    VN slots without an edge hold exact zeros of x's dtype."""
    p = stratified_plan(sc, x_cn.device)
    b = x_cn.shape[-1]
    src = p.sc.vn_from_cn.reshape(-1)
    out = x_cn.reshape(-1, b)[src.clamp(min=0).long()]
    return stratified_zero_pad(sc, out.view(sc.mb, sc.kg, sc.w, b))


def stratified_check_satisfied(sc: StratifiedCode,
                               d_grid: torch.Tensor) -> torch.Tensor:
    """d_grid: [kg, w, B] ±1 (pad cells arbitrary) -> [B] bool, all parity
    checks satisfied (the XOR of each check's negative decisions)."""
    p = stratified_plan(sc, d_grid.device)
    return xor_satisfied(p.check_cols, d_grid.reshape(sc.kg * sc.w, -1))


def stratified_grid(sc: StratifiedCode, y_t: torch.Tensor) -> torch.Tensor:
    """[N, B] column-ordered samples -> the padded [kg, w, B] group grid
    (one gather per decode; pad cells are exact zeros)."""
    p = stratified_plan(sc, y_t.device)
    yg = y_t[p.col_idx].view(sc.kg, sc.w, y_t.shape[-1])
    return _masked(yg, p.col_pad)


def stratified_init(sc: StratifiedCode, yg: torch.Tensor, sdt) -> torch.Tensor:
    """Initial v2c planes [mb, kg, w, B]: every VN slot with an edge starts
    at the channel sample (initializeSymMessages, decodeMinSum.cpp:364-370),
    the others at 0."""
    v = yg[None].expand(sc.mb, -1, -1, -1)
    return stratified_zero_pad(sc, v).to(sdt)


def stratified_hard(sc: StratifiedCode, d: torch.Tensor) -> torch.Tensor:
    """Decisions on the [kg, w, B] grid -> [N, B] in column order."""
    p = stratified_plan(sc, d.device)
    return d.reshape(sc.kg * sc.w, -1)[p.pos_of_col]


def stratified_minsum_step(sc: StratifiedCode, variant: str = "plain",
                           alpha: float = 1.0, delta: float = 0.0,
                           storage_dtype=None):
    """The :func:`decode_minsum_stratified` iteration as a function of
    (messages, channel grid): ``step(v2c, yg) -> (v2c', total)``.  The VN
    fold runs in the channel grid's dtype, as the slot-array decoder's
    does (an f16 grid folds in f16).  The returned messages equal JAX's in
    every VN slot with an edge; the others hold ``total`` (never read)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")

    def step(v2c, yg):
        p = stratified_plan(sc, v2c.device)
        b = v2c.shape[-1]
        # B1: check update in CN-slot order, read from and written to the
        # VN-slot rows (both interleaves inside the kernel)
        c2v = minsum_cn_scan(v2c.reshape(-1, b).contiguous(), p.cn_rows,
                             variant, alpha, delta)
        if p.vn_absent is not None:  # the rows B1 leaves unwritten
            c2v.index_fill_(0, p.vn_absent, 0)
        c2v = c2v.to(yg.dtype).view(sc.mb, sc.kg, sc.w, b)
        # messages (strata) left-fold first, channel term last
        acc = c2v[0]
        for s in range(1, sc.mb):
            acc = acc + c2v[s]
        total = yg + acc
        sdt = storage_dtype if storage_dtype is not None else yg.dtype
        return storage_cast(total[None] - c2v, sdt), total

    return step


def decode_minsum_stratified(
    sc: StratifiedCode,
    y: torch.Tensor,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched flooding min-sum on a stratified code.  y: [B, N].

    Same flags and semantics as :func:`.minsum.decode_minsum` (the three
    variants of decodeMinSum.cpp, optional f16 message storage with f32
    arithmetic).  The structure's tables are taken to y's device (once,
    cached).  On the card, B1 takes ``kg`` ≤ 64 column groups and raises
    beyond.
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")
    y_t = y.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != sc.n:
        raise ValueError(f"y has {n} columns, the code {sc.n}")
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype
    yg = stratified_grid(sc, y_t)
    v2c0 = stratified_init(sc, yg, sdt)
    step_y = stratified_minsum_step(sc, variant, alpha, delta, storage_dtype)
    d, iters, done = run_flooding_soft(
        yg, v2c0, lambda v2c: step_y(v2c, yg),
        lambda d: stratified_check_satisfied(sc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=stratified_hard(sc, d).t(), iterations=iters,
                        satisfied=done)
