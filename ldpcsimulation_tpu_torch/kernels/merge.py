"""Kernel B10: the early-termination decision merge (``csrc/et_merge.cu``).

No Pallas original: it replaces the XLA fusion of the JAX loop body's latch
in ``ldpcsimulation_tpu.decoders.base.run_flooding_soft``.  After each
executed round the flooding soft decoders latch, for every frame not yet
done, the posterior's sign as its int8 decision (``sgn(0) = −1``: +0.0,
−0.0 and NaN give −1) and the round number as its round count; a done
frame keeps both.  The posterior ``total`` is batch last and of any rank
(``[rows, B]`` once flattened), f32, f16 or bf16; ``d`` is int8 in its
shape, ``done [B]`` bool, ``iters [B]`` int32.  Both ``d`` and ``iters``
are written in place, every lane of them: a done lane gets its old value.

:func:`et_merge` launches the kernel for CUDA tensors and runs
:func:`et_merge_plain` for CPU tensors; both check their inputs on every
device.  The two are exact (the merge only selects), so they agree bit for
bit (``chip_smoke.py`` [48]).
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = ["WIDE", "et_merge", "et_merge_plain", "merge_lane_width"]

#: the posterior's type -> its id at the C entry
_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: lanes a thread of the wide instance
WIDE = 16


def _check(total, done, d, iters, rounds):
    if total.dtype not in _KINDS or total.dim() < 1:
        raise ValueError(f"et_merge: total must be f32/f16/bf16 [..., B], "
                         f"got {tuple(total.shape)} {total.dtype}")
    batch = total.shape[-1]
    if d.dtype != torch.int8 or d.shape != total.shape:
        raise ValueError(f"et_merge: d must be int8 {tuple(total.shape)}, "
                         f"got {tuple(d.shape)} {d.dtype}")
    for name, t, dtype in (("done", done, torch.bool),
                           ("iters", iters, torch.int32)):
        if t.dtype != dtype or t.shape != (batch,):
            raise ValueError(f"et_merge: {name} must be {dtype} [{batch}], "
                             f"got {tuple(t.shape)} {t.dtype}")
    devices = {t.device for t in (total, done, d, iters)}
    if len(devices) != 1:
        raise ValueError(f"et_merge: total, done, d and iters on "
                         f"{sorted(map(str, devices))}")
    for name, t in (("total", total), ("done", done), ("d", d),
                    ("iters", iters)):
        if not t.is_contiguous():
            raise ValueError(f"et_merge: {name} must be contiguous")
    if not 0 <= rounds < 2**31:
        raise ValueError(f"et_merge: rounds {rounds} outside int32")


def merge_lane_width(total, done, d, iters) -> int:
    """Lanes a thread of the instance that takes a call: :data:`WIDE` (16,
    one 16-byte access of decisions and flags a row) where the batch is a
    multiple of it and the four planes are 16-byte aligned, else 1."""
    if total.shape[-1] % WIDE == 0 and all(
            t.data_ptr() % 16 == 0 for t in (total, done, d, iters)):
        return WIDE
    return 1


def et_merge_plain(total, done, d, iters, rounds):
    """Plain PyTorch twin of kernel B10: the latch as the flooding loop
    wrote it before the kernel, written back in place."""
    _check(total, done, d, iters, rounds)
    act = ~done
    one = torch.ones((), dtype=torch.int8, device=total.device)
    d.copy_(torch.where(act, torch.where(total > 0, one, -one), d))
    iters.copy_(torch.where(act, rounds, iters))


def et_merge(total, done, d, iters, rounds):
    """Latch round ``rounds``' decisions ``sign(total)`` into ``d`` and
    ``rounds`` into ``iters`` for every lane not ``done``, in place.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if total.device.type == "cpu":
        et_merge_plain(total, done, d, iters, rounds)
        return
    if total.device.type != "cuda":
        raise ValueError(f"et_merge: unsupported device {total.device}")
    _check(total, done, d, iters, rounds)
    batch = total.shape[-1]
    if batch == 0:
        return
    lanes = merge_lane_width(total, done, d, iters)
    rc = build.library().ldpc_et_merge(
        total.data_ptr(), _KINDS[total.dtype], done.data_ptr(), d.data_ptr(),
        iters.data_ptr(), math.prod(total.shape[:-1]), batch, lanes, rounds,
        total.device.index, build.stream_of(total.device),
    )
    build.check(rc, "et_merge")
    build.LAUNCHES["et_merge"] += 1
    build.PATHS["et_merge", "wide" if lanes == WIDE else "tail"] += 1
