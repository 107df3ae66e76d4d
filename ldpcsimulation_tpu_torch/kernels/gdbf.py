"""Kernel B7: the parallel GDBF step on the variable side
(``csrc/gdbf_step.cu``), in place; and the chunk of parallel GDBF steps
issued from one host call (``csrc/gdbf_chunk.cu``).

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

The chunk.  A decode's parallel steps between two reads of its all-done
flag need nothing from the host, so :func:`gdbf_chunk` issues them in one
C call: per step kernel B6 (the syndrome and the satisfied flags), the
step's ``[B]`` bookkeeping as one kernel (``gdbf_lanes_kernel``; its twin
:func:`gdbf_lanes_plain`), kernel B4 (the keyed perturbation, when the
decoder draws one) and kernel B7, each with the arguments its wrapper
would pass.  :func:`gdbf_chunk_plan` validates the planes and picks the
kernels' lane widths once per decode, and holds the step's buffers (the
syndrome, the satisfied flags, the perturbation).  The chunk runs on the
card only; on the CPU the decoder runs the same steps one at a time
through the per-step wrappers' twins and :func:`gdbf_lanes_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import build
from .channel import _check_draw, noise_stream
from .check import _check as _check_cols
from .check import check_lane_width

__all__ = ["gdbf_parallel_step", "gdbf_parallel_step_plain",
           "step_lane_width", "gdbf_lanes_plain", "ChunkPlan",
           "gdbf_chunk_plan", "gdbf_chunk"]

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


def gdbf_lanes_plain(sat, done, act, iters, phases, smooth_used,
                     sat_at_exit, step, phase, in_window):
    """One step's ``[B]`` bookkeeping after its parity check, in place
    (the plain twin of ``gdbf_lanes_kernel``): frames that check out now
    record the step, the phase and, inside the smoothing window, a
    smoothing use; ``done`` takes ``sat``, ``act`` becomes ``~done`` (the
    lanes the step's VN side changes) and ``sat`` is reset to true."""
    newly = ~done & sat
    iters.masked_fill_(newly, step)
    phases.masked_fill_(newly, phase + 1)
    if in_window:
        smooth_used += newly
    done |= sat
    sat_at_exit |= newly
    torch.logical_not(done, out=act)
    sat.fill_(True)


@dataclasses.dataclass
class ChunkPlan:
    """One decode's validated arguments of :func:`gdbf_chunk`: the graph
    tables, the planes updated in place (``d``, ``thetas``, ``dsum``), the
    ``[B]`` state (``done``, ``act``, ``iters``, ``phases``,
    ``smooth_used``, ``sat_at_exit``), the step buffers (``syn``, ``sat``,
    ``pert``), the scalars and the lane widths of B6 and B7.  Step ``t``
    is inside the smoothing window when ``t % T >= window_start``;
    ``noise`` is ``(seed, frame0, scale)`` of B4's draws, or None."""

    check_cols: torch.Tensor
    vn_checks: torch.Tensor
    d: torch.Tensor
    y: torch.Tensor
    thetas: torch.Tensor
    dsum: torch.Tensor
    done: torch.Tensor
    act: torch.Tensor
    iters: torch.Tensor
    phases: torch.Tensor
    smooth_used: torch.Tensor
    sat_at_exit: torch.Tensor
    syn: torch.Tensor
    sat: torch.Tensor
    pert: Optional[torch.Tensor]
    T: int
    window_start: int
    w: object
    lam: Optional[float]
    noise: Optional[tuple]
    check_lanes: int
    step_lanes: int
    #: the C entry's fixed arguments, built on the first CUDA chunk
    c_args: Optional[tuple] = None


def gdbf_chunk_plan(check_cols, vn_checks, d, y, thetas, dsum, done, act,
                    iters, phases, smooth_used, sat_at_exit, T: int,
                    window_start: int, total_steps: int, w, lam=None,
                    noise=None) -> ChunkPlan:
    """Validate one decode's arguments of :func:`gdbf_chunk` once and
    allocate its step buffers.

    check_cols [M, dc] and vn_checks [N, dv] int64: B6's and B7's tables;
    d, y, thetas, dsum as :func:`gdbf_parallel_step` takes them; done,
    act and sat_at_exit [B] bool, iters, phases and smooth_used [B] int32;
    T the steps of a phase; steps stop below ``total_steps``; w, lam as B7
    takes them; noise ``(seed, frame0, scale)`` (``scale`` an f32 value)
    or None.  The buffers live as long as the plan.
    """
    _check_cols(check_cols, d)
    (n, b), m = d.shape, check_cols.shape[0]
    syn = torch.empty((m, b), dtype=d.dtype, device=d.device)
    sat = torch.ones((b,), dtype=torch.bool, device=d.device)
    pert = (torch.empty((n, b), dtype=torch.float32, device=d.device)
            if noise is not None else None)
    _check(d, y, syn, vn_checks, thetas, dsum, act, w, pert)
    state = {"done": (done, torch.bool), "sat_at_exit":
             (sat_at_exit, torch.bool), "iters": (iters, torch.int32),
             "phases": (phases, torch.int32),
             "smooth_used": (smooth_used, torch.int32)}
    for name, (t, dt) in state.items():
        if t.dtype != dt or t.shape != (b,) or t.device != d.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be [{b}] {dt} on {d.device}, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if T <= 0 or total_steps < 0 or total_steps >= (1 << 31) - 2:
        raise ValueError(f"bad step budget: T={T}, {total_steps} steps")
    if noise is not None:
        seed, frame0, _ = noise
        if total_steps:
            _check_draw(seed, frame0, b, n,
                        noise_stream(total_steps - 1, 0), "nb")
    return ChunkPlan(
        check_cols, vn_checks, d, y, thetas, dsum, done, act, iters, phases,
        smooth_used, sat_at_exit, syn, sat, pert, T, window_start, w, lam,
        noise, check_lane_width(d),
        step_lane_width(d, y, syn, thetas, dsum, act, pert))


def _c_args(p: ChunkPlan) -> tuple:
    """(arguments before the step range, arguments after it) of
    ``ldpc_gdbf_chunk``: fixed for the plan's decode, so built once."""
    n, batch = p.d.shape
    per_vn = isinstance(p.w, torch.Tensor)
    seed, frame0, scale = p.noise if p.noise is not None else (0, 0, 0.0)
    ptr = [None if t is None else t.data_ptr() for t in (
        p.check_cols, p.vn_checks, p.d, p.y, p.thetas, p.dsum, p.syn, p.sat,
        p.pert, p.done, p.act, p.iters, p.phases, p.smooth_used,
        p.sat_at_exit)]
    head = (ptr[0], p.check_cols.shape[0], p.check_cols.shape[1], ptr[1],
            p.vn_checks.shape[1], n, batch, ptr[2],
            int(p.d.dtype == torch.int8), *ptr[3:])
    tail = (p.T, p.window_start, seed, frame0, scale,
            0.0 if per_vn else float(p.w),
            p.w.data_ptr() if per_vn else None,
            1.0 if p.lam is None else float(p.lam), int(p.lam is not None),
            p.check_lanes, p.step_lanes, p.d.device.index,
            build.stream_of(p.d.device))
    return head, tail


def gdbf_chunk(p: ChunkPlan, step0: int, count: int) -> None:
    """Steps ``step0`` … ``step0 + count − 1`` of a parallel GDBF decode,
    in place on the plan's planes and ``[B]`` state; a chunk stays inside
    one phase.  CUDA tensors only: one C call that issues every kernel of
    the chunk (each counted in ``LAUNCHES``, B4's instances in ``PATHS``),
    or an exception.  Its plain twin is the decoder's per-step body run
    over the same steps (``decoders.gdbf.decode_gdbf`` on the CPU)."""
    if p.d.device.type != "cuda":
        raise ValueError(f"gdbf_chunk: unsupported device {p.d.device}")
    if p.c_args is None:
        p.c_args = _c_args(p)
    head, tail = p.c_args
    counts = (ctypes.c_int * 6)()
    rc = build.library().ldpc_gdbf_chunk(*head, step0, count, *tail, counts)
    for name, c in zip(("parity_check", "gdbf_lanes", "gauss_philox",
                        "gdbf_parallel_step"), counts):
        if c:
            build.LAUNCHES[name] += c
    if counts[4]:
        build.PATHS["gauss_philox", "fast"] += counts[4]
    if counts[5]:
        build.PATHS["gauss_philox", "tail"] += counts[5]
    build.check(rc, "gdbf_chunk")
