"""Row-layered min-sum schedule for QC codes.

Port of ``ldpcsimulation_tpu.decoders.minsum_layered`` with the same
arithmetic, so its decisions equal the JAX decoder's bit for bit on the same
samples.  The reference decoders are flooding-only; a layered (serial-C)
schedule passes information on within an iteration and typically halves the
iteration count at equal BER.

Semantics (standard row-layered min-sum):
  * State: the posterior ``q [N, B]`` (the channel samples at the start) and
    the stored check messages ``L``, one ``[dc_bi * z, B]`` buffer per layer
    in the storage type (zeros at the start).
  * Per layer — one base row, whose z checks meet each column of a
    single-circulant block once:
        qext = q[col] − L          (f32)
        out  = min-sum over the check's qext, with the variant post-op
        L'   = storage_cast(out);  q[col] = qext + out
  * One iteration is one pass over the Mb layers in base-row order;
    decisions are ``q > 0 ? +1 : −1``.

A layer without a two-circulant pair is kernel B11
(:func:`..kernels.layered.minsum_layer_step`): one pass reads each named
slot's posterior and stored message, scans the extrinsics in registers,
writes ``q[col]`` in place and ``L'`` to a fresh buffer, Mb launches per
iteration, each layer's work under the span ``ldpc.decode.layer``.  The
extrinsic and the variant post-op are f32 operations here whatever the
storage type (the JAX layered scan runs in the posterior's type with weakly
typed ``alpha``/``delta``), unlike the flooding decoder's storage-precision
post-op; only ``L'`` is cast.

Generalized structures: a two-circulant PAIR meets every column of its
block twice within the layer; all z checks read the pre-layer posterior and
their updates accumulate, ``q' = (a1 − q) + a2`` in exactly that grouping.
Such a layer keeps the body from before B11
(:func:`..kernels.layered.layer_body`): the layer's ``qext`` rows in an f32
buffer, kernel B1 (:func:`..kernels.minsum.minsum_cn_scan`) through the
layer's routing table (:class:`.minsum_qc.LayerPlan`), then
:func:`layered_scatter`.  An absent edge is a −1 slot of the routing table
(the JAX scan reads +inf there), stores a zero and leaves its column's
posterior untouched.
"""

from __future__ import annotations

import torch

from .. import spans
from ..codes.qc import QCCode
from ..kernels.layered import layer_body, minsum_layer_step
from ..kernels.minsum import VARIANTS, minsum_cn_scan
from .base import DecodeResult, run_flooding
from .minsum_qc import (
    assert_layered_compatible,
    qc_check_satisfied,
    qc_plan,
)

__all__ = ["layered_l0", "layered_scatter", "qc_minsum_layered_step",
           "decode_minsum_layered_qc"]


def layered_l0(qc: QCCode, b: int, sdt, device):
    """Zero stored check messages: one ``[dc_bi * z, B]`` buffer per
    layer."""
    return tuple(
        torch.zeros((lp.dc * qc.z, b), dtype=sdt, device=device)
        for lp in qc_plan(qc, device).layers
    )


def layered_scatter(q, lp, qv, qext, out):
    """Write one layer's posterior update into ``q`` (in place).

    qv, qext, out: the layer's ``[dc*z, B]`` posterior reads, extrinsics and
    check outputs (zeros in absent rows).  A single circulant writes
    ``qext + out`` (an absent edge writes back what it read); a pair
    accumulates ``(a1 − q) + a2`` per column.
    """
    post = qext + out
    if lp.absent is not None:
        post[lp.absent] = qv[lp.absent]
    if lp.single_rows is None:
        q[lp.cols] = post
        return
    q[lp.cols[lp.single_rows]] = post[lp.single_rows]
    first = lp.pair_first
    q[lp.cols[first]] = (post[first] - qv[first]) + post[lp.pair_second]


def qc_minsum_layered_step(qc: QCCode, variant: str = "plain",
                           alpha: float = 1.0, delta: float = 0.0,
                           storage_dtype=None):
    """The :func:`decode_minsum_layered_qc` iteration as a function of the
    layered state: ``step((q, L)) -> ((q', L'), total)`` with ``q`` the
    ``[N, B]`` posterior, ``L`` the per-layer stored check messages and
    ``total`` the new posterior (decisions are its sign).  One call is one
    pass over all Mb layers; the state given is left unchanged (the step
    updates a copy of ``q`` in place and writes fresh ``L'`` buffers).  A
    layer without a pair is kernel B11; a pair layer keeps the gather, B1
    and :func:`layered_scatter`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown min-sum variant {variant!r}")
    assert_layered_compatible(qc)

    def step(qL):
        q, L = qL
        plan = qc_plan(qc, q.device)
        sdt = storage_dtype if storage_dtype is not None else q.dtype
        q = q.clone()
        L_new = []
        for lp, l_old in zip(plan.layers, L):
            with spans.span(spans.LAYER_STEP):
                if lp.pair_first is None:
                    L_new.append(minsum_layer_step(q, l_old, lp, variant,
                                                   alpha, delta, sdt))
                else:
                    L_new.append(layer_body(q, l_old, lp, variant, alpha,
                                            delta, sdt, minsum_cn_scan))
        return (q, tuple(L_new)), q

    return step


def decode_minsum_layered_qc(
    qc: QCCode,
    y: torch.Tensor,
    num_iterations: int,
    variant: str = "plain",
    alpha: float = 1.0,
    delta: float = 0.0,
    early_termination: bool = False,
    storage_dtype=None,
) -> DecodeResult:
    """Batched row-layered min-sum on a QC code.  y: [B, N] samples (f32).

    storage_dtype: optional narrower type (e.g. torch.float16) of the stored
    check messages; the posterior and the arithmetic stay f32.
    """
    y_t = y.t().contiguous()  # [N, B]
    n, b = y_t.shape
    if n != qc.n:
        raise ValueError(f"y has {n} columns, the code {qc.n}")
    sdt = storage_dtype if storage_dtype is not None else y_t.dtype
    step = qc_minsum_layered_step(qc, variant, alpha, delta, storage_dtype)
    d, iters, done = run_flooding(
        (y_t, layered_l0(qc, b, sdt, y_t.device)),
        lambda st: step(st)[0],
        lambda st: torch.where(st[0] > 0, 1, -1).to(torch.int32),
        lambda d: qc_check_satisfied(qc, d),
        num_iterations, early_termination, b,
    )
    return DecodeResult(hard=d.t(), iterations=iters, satisfied=done)
