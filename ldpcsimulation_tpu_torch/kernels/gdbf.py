"""Kernel B7: the parallel GDBF step on the variable side
(``csrc/gdbf_step.cu``), in place.

No Pallas original: it replaces the XLA fusion of the JAX bit-flip step
after its CN update (``ldpcsimulation_tpu.decoders.gdbf``: the neighbour
sum and flip metric, the parallel rule of ``flip_decisions``, the flip,
threshold adaptation and output smoothing).  Per variable ``i`` and lane
``b``: ``s`` the sum of the bipolar syndromes of i's checks through
``vn_checks [N, dv]`` (int64, the sentinel ``M`` in an absent slot);
``e = (d·y + w·s) + pert`` in f32, each operation rounded in that order;
then on an active lane ``d ← −d`` where ``e < θ``, ``θ ← θ·λ`` where it
does not flip (with ``lam``), and ``dsum ← dsum + d`` (with ``smooth``).

:func:`gdbf_parallel_step` launches the kernel for CUDA tensors and runs
:func:`gdbf_parallel_step_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["gdbf_parallel_step", "gdbf_parallel_step_plain",
           "step_lane_width"]

_DTYPES = (torch.int8, torch.int32)
_F32 = torch.float32


def _check(d, y, syn, vn_checks, thetas, dsum, act, w, pert):
    n, b = d.shape if d.dim() == 2 else (-1, -1)
    if d.dim() != 2 or d.dtype not in _DTYPES:
        raise ValueError(f"d must be [N, B] int8/int32, got "
                         f"{tuple(d.shape)} {d.dtype}")
    if syn.dim() != 2 or syn.dtype != d.dtype or syn.shape[1] != b:
        raise ValueError(f"syn must be [M, {b}] {d.dtype}, got "
                         f"{tuple(syn.shape)} {syn.dtype}")
    if (vn_checks.dim() != 2 or vn_checks.dtype != torch.int64
            or vn_checks.shape[0] != n):
        raise ValueError(f"vn_checks must be [{n}, dv] int64, got "
                         f"{tuple(vn_checks.shape)} {vn_checks.dtype}")
    planes = {"y": (y, _F32), "thetas": (thetas, _F32),
              "dsum": (dsum, torch.int32)}
    if pert is not None:
        planes["pert"] = (pert, _F32)
    for name, (t, dt) in planes.items():
        if t.dtype != dt or t.shape != d.shape:
            raise ValueError(f"{name} must be [{n}, {b}] {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if act.dtype != torch.bool or act.shape != (b,):
        raise ValueError(f"act must be [{b}] bool, got {tuple(act.shape)} "
                         f"{act.dtype}")
    tensors = [d, y, syn, vn_checks, thetas, dsum, act]
    if isinstance(w, torch.Tensor):
        if w.dtype != _F32 or w.shape != (n,):
            raise ValueError(f"w must be a float or [{n}] f32, got "
                             f"{tuple(w.shape)} {w.dtype}")
        tensors.append(w)
    if pert is not None:
        tensors.append(pert)
    if any(t.device != d.device for t in tensors):
        raise ValueError("every tensor must be on d's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every tensor must be contiguous")


def step_lane_width(d, y, syn, thetas, dsum, act, pert) -> int:
    """Lanes per thread of the instance that takes a call: 4 where the
    batch is a multiple of 4 and every plane's address allows its vector
    accesses, else 1."""
    lanes = 4
    planes = [d, y, syn, thetas, dsum, act] + ([] if pert is None else [pert])
    if d.shape[1] % lanes == 0 and all(
            t.data_ptr() % (lanes * t.element_size()) == 0 for t in planes):
        return lanes
    return 1


def gdbf_parallel_step_plain(d, y, syn, vn_checks, thetas, dsum, act, w,
                             pert=None, lam=None, smooth=False):
    """Plain PyTorch twin of kernel B7 (the same operations in the same
    order), in place on ``d``, ``thetas`` and ``dsum``."""
    _check(d, y, syn, vn_checks, thetas, dsum, act, w, pert)
    x = torch.cat([syn.to(_F32), syn.new_zeros((1, syn.shape[1]),
                                               dtype=_F32)])
    s = torch.index_select(x, 0, vn_checks[:, 0])
    for t in range(1, vn_checks.shape[1]):
        s = s + torch.index_select(x, 0, vn_checks[:, t])
    if isinstance(w, torch.Tensor):
        w = w[:, None]
    e = d.to(_F32) * y + w * s
    if pert is not None:
        e = e + pert
    flip = e < thetas
    take = act[None, :]
    d.copy_(torch.where(take & flip, -d, d))
    if lam is not None:
        thetas.copy_(torch.where(take & ~flip, thetas * lam, thetas))
    if smooth:
        dsum.copy_(torch.where(take, dsum + d, dsum))


def gdbf_parallel_step(d, y, syn, vn_checks, thetas, dsum, act, w,
                       pert=None, lam=None, smooth=False):
    """One parallel GDBF step after the CN update, in place.

    d [N, B] int8/int32 ±1 (flipped in place); y [N, B] f32 channel
    samples; syn [M, B] bipolar syndromes in d's dtype; vn_checks [N, dv]
    int64; thetas [N, B] f32 (scaled by ``lam`` where a lane did not flip,
    when ``lam`` is given); dsum [N, B] int32 (the new d added, when
    ``smooth``); act [B] bool (only active lanes change); w a float or [N]
    f32; pert an optional [N, B] f32 perturbation.  Python floats ``w`` and
    ``lam`` must already be f32 values.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if d.device.type == "cpu":
        return gdbf_parallel_step_plain(d, y, syn, vn_checks, thetas, dsum,
                                        act, w, pert, lam, smooth)
    if d.device.type != "cuda":
        raise ValueError(f"gdbf_parallel_step: unsupported device "
                         f"{d.device}")
    _check(d, y, syn, vn_checks, thetas, dsum, act, w, pert)
    n, batch = d.shape
    per_vn = isinstance(w, torch.Tensor)
    rc = build.library().ldpc_gdbf_parallel_step(
        d.data_ptr(), int(d.dtype == torch.int8), y.data_ptr(),
        syn.data_ptr(), vn_checks.data_ptr(), n, syn.shape[0],
        vn_checks.shape[1], thetas.data_ptr(), dsum.data_ptr(),
        act.data_ptr(), 0.0 if per_vn else float(w),
        w.data_ptr() if per_vn else None,
        None if pert is None else pert.data_ptr(),
        1.0 if lam is None else float(lam), int(lam is not None),
        int(bool(smooth)), batch,
        step_lane_width(d, y, syn, thetas, dsum, act, pert),
        d.device.index, build.stream_of(d.device),
    )
    build.check(rc, "gdbf_parallel_step")
    build.LAUNCHES["gdbf_parallel_step"] += 1
