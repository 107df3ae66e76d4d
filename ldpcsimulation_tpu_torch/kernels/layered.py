"""Kernel B11: one layer of the row-layered min-sum decoder in one pass
(``csrc/minsum_layer_step.cu``).

No Pallas original: the JAX package leaves the layered step to XLA, which
fuses ``ldpcsimulation_tpu.decoders.minsum_layered.qc_minsum_layered_step``'s
per-layer body.  For one layer ``lp`` (a :class:`..decoders.minsum_qc.
LayerPlan` without a two-circulant pair) the kernel reads each named slot's
posterior ``q[col]`` (f32) and stored message (f16 or f32, widened exactly),
forms the extrinsic, runs kernel B1's two-min scan and variant post-op on
it in f32, writes ``q[col] = extrinsic + out`` in place and ``storage_cast
(out)`` to a fresh message buffer; an absent edge stores +0.0 and leaves
its column alone.  :func:`minsum_layer_step` launches it for CUDA tensors
and runs :func:`minsum_layer_step_plain` for CPU tensors; the two agree bit
for bit on the card (``chip_smoke.py``), since every operation is one
correctly rounded f32 subtraction, compare, division or add, or a cast, in
the twin's order.

The twin is the step's per-layer body as it was before the kernel
(:func:`layer_body` with B1's plain twin): the posterior's gather, the
messages' widening, the extrinsic, the scan, the absent rows' fill, the
scatter and the storage cast.  A pair layer (DVB-S2's tied blocks) meets a
column twice and updates it from the pre-layer posterior, which an in-place
pass cannot do: the decoder runs :func:`layer_body` with B1 there, and the
wrapper refuses such a layer by name.
"""

from __future__ import annotations

import torch

from . import build
from .bp import CAP_LANES
from .minsum import VARIANTS, in_storage, minsum_cn_scan_plain, vn_lane_width

__all__ = ["layer_body", "layer_instance", "minsum_layer_step",
           "minsum_layer_step_plain"]


def layer_instance(dc: int, q, l_old, l_new) -> tuple[int, int]:
    """(slot cap, lanes per thread) of the instance that takes a layer: the
    smallest cap that holds ``dc``, then the widest lane count under the
    cap's register budget (B8's :data:`.bp.CAP_LANES`) that divides the
    batch and keeps the three planes' vector accesses aligned."""
    caps = [cap for cap in CAP_LANES if dc <= cap]
    if not caps:
        raise ValueError(f"minsum_layer_step: the kernel takes dc <= "
                         f"{max(CAP_LANES)}, got dc={dc}")
    cap = caps[0]
    return cap, min(CAP_LANES[cap], vn_lane_width(l_old, q, l_new))


def _check(q, l_old, lp, variant, sdt):
    if variant not in VARIANTS:
        raise ValueError(f"minsum_layer_step: unknown min-sum variant "
                         f"{variant!r}")
    if lp.pair_first is not None:
        raise ValueError("minsum_layer_step: a layer with a two-circulant "
                         "pair meets its columns twice; it takes the "
                         "decoder's body with B1")
    z, dc = lp.slot_cols.shape
    if dc > max(CAP_LANES):
        raise ValueError(f"minsum_layer_step: the kernel takes dc <= "
                         f"{max(CAP_LANES)}, got dc={dc}")
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(f"minsum_layer_step: q must be [N, B] f32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if sdt not in (torch.float16, torch.float32) or l_old.dtype != sdt:
        raise ValueError(f"minsum_layer_step: the messages must be f16 or "
                         f"f32 in the storage type, got {l_old.dtype} "
                         f"stored as {sdt}")
    if l_old.shape != (dc * z, q.shape[1]):
        raise ValueError(f"minsum_layer_step: l_old must be "
                         f"[{dc * z}, {q.shape[1]}], got "
                         f"{tuple(l_old.shape)}")
    if not q.device == l_old.device == lp.slot_cols.device:
        raise ValueError(f"minsum_layer_step: q on {q.device}, l_old on "
                         f"{l_old.device}, the layer's table on "
                         f"{lp.slot_cols.device}")
    if not (q.is_contiguous() and l_old.is_contiguous()):
        raise ValueError("minsum_layer_step: q and l_old must be contiguous")


def layer_body(q, l_old, lp, variant, alpha, delta, sdt, scan):
    """One layer as the step ran it before B11, ``scan`` the check update
    (B1's wrapper or its twin): updates ``q`` in place and returns the
    layer's new messages in ``sdt``.  Takes pair layers too."""
    # imported here: the decoders import the kernels
    from ..decoders.base import storage_cast
    from ..decoders.minsum_layered import layered_scatter

    qv = q[lp.cols]
    qext = qv - l_old.to(q.dtype)
    out = scan(qext, lp.scan_rows, variant, alpha, delta)
    if lp.absent is not None:  # rows B1 does not write
        out.index_fill_(0, lp.absent, 0.0)
    layered_scatter(q, lp, qv, qext, out)
    return storage_cast(out, sdt)


def minsum_layer_step_plain(q, l_old, lp, variant="plain", alpha=1.0,
                            delta=0.0, sdt=torch.float32):
    """Plain PyTorch twin of kernel B11: :func:`layer_body` on B1's twin."""
    _check(q, l_old, lp, variant, sdt)
    return layer_body(q, l_old, lp, variant, alpha, delta, sdt,
                      minsum_cn_scan_plain)


def minsum_layer_step(q, l_old, lp, variant="plain", alpha=1.0, delta=0.0,
                      sdt=torch.float32):
    """One layer ``lp`` of row-layered min-sum: updates the posterior ``q
    [N, B]`` (f32) in place and returns the layer's new messages ``[dc * z,
    B]`` in ``sdt`` (f16 or f32, the type of ``l_old``).

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if q.device.type == "cpu":
        return minsum_layer_step_plain(q, l_old, lp, variant, alpha, delta,
                                       sdt)
    if q.device.type != "cuda":
        raise ValueError(f"minsum_layer_step: unsupported device "
                         f"{q.device}")
    _check(q, l_old, lp, variant, sdt)
    z, dc = lp.slot_cols.shape
    l_new = torch.empty_like(l_old)
    cap, lanes = layer_instance(dc, q, l_old, l_new)
    rc = build.library().ldpc_minsum_layer_step(
        q.data_ptr(), l_old.data_ptr(), int(sdt == torch.float16),
        lp.slot_cols.data_ptr(), z, dc, q.shape[1], cap, lanes,
        VARIANTS[variant], in_storage(alpha, torch.float32),
        in_storage(delta, torch.float32), l_new.data_ptr(), q.device.index,
        build.stream_of(q.device),
    )
    build.check(rc, "minsum_layer_step")
    build.LAUNCHES["minsum_layer_step"] += 1
    build.PATHS["minsum_layer_step", lanes] += 1
    return l_new
