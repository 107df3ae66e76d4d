"""Slot-mesh Monte-Carlo parallelism on ``torch.distributed``.

Port of ``ldpcsimulation_tpu.parallel.mesh``.  The reference fans out one
OS process per (SNR × parameter) operating point; the JAX package replaces
that by a 2-D device mesh whose ``"snr"`` axis holds operating points and
whose ``"data"`` axis splits the frame batch, with counters reduced by
``psum``.  Here:

  * a :class:`Mesh` is a ("snr", "data") grid of *slots*, each a (rank,
    device) pair.  Each rank owns a contiguous, equal block of slots, and a
    device may repeat: one card (or the CPU) holds several slots, which is
    how a single H100 or a CPU test runs a many-slot mesh;
  * a step runs, on every rank, the slots that rank owns, each on its
    device: kernel B2 draws the slot's channel, the decoder runs and the
    slot's counters are reduced on its device (``index_add_``).  Then the
    rank adds its slots into one zeroed ``[S, W]`` int64 tensor, one
    ``all_reduce(SUM)`` over the world gives every rank every slot's
    counters (no collective in a world of one), and one host copy brings
    them back;
  * a rank runs its slots one after another.  A decoder that reads the
    host inside its decode (early termination, the GDBF and NGDBFhw loop
    control every 4 steps, NB) holds back the next slot's launches, so the
    cards of one process take turns.  Cards run at once with one rank per
    card: torchrun, or :func:`spawn_ranks`, which the sweep's
    ``--distributed`` calls on a host with several cards;
  * the operating point's scalars (σ and the decoder parameters) reach the
    decoder as Python floats, each rounded to f32 (``float(np.float32(v))``)
    as the JAX engine's traced f32 scalars are: one decode per slot, and no
    decoder changes its arithmetic.

Frame keying.  The JAX engine folds (round, snr slot, data slot) into a
threefry key; the port keys every frame by (seed, frame index) on kernel B2
and :class:`..decoders.base.NoiseKey`.  So a step takes, per snr slot, the
index ``f0`` of its first frame: data slot ``di`` decodes frames ``[f0 +
di·bpd, f0 + (di+1)·bpd)``, and a codeword fixture is cycled by frame index
mod L, as :func:`..harness.montecarlo.simulate` cycles it.  The drivers
(:mod:`.montecarlo`) number each operating point's frames 0, 1, 2, … on
their own, so a point's counters do not depend on how the slots are split
over processes, and a point run on one slot equals ``simulate(batch_size=
B_global, seed=seed)`` over the same frames.

Multi-process: call :func:`init_distributed` first (torchrun's environment,
or an explicit ``init_method``, ``rank`` and ``world_size``).
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import spans
from ..channel.awgn import awgn_all_zero, bpsk
from ..codes.code import Code
from ..decoders.base import NoiseKey

__all__ = [
    "init_distributed",
    "world",
    "Mesh",
    "make_mesh",
    "local_cuda_devices",
    "all_reduce_sum",
    "all_reduce_dict",
    "all_reduce_max",
    "spawn_ranks",
    "make_counters_step",
    "make_grid_step",
    "BatchCounters",
]

#: the channel forms of :func:`..harness.montecarlo.simulate` (a copy: the
#: harness imports this module)
_AWGN_FORMS = ("multiplicative", "additive")
#: scalar counters of a step, in their column order
_SCALARS = ("errors", "uncoded_errors", "word_errors", "iteration_sum",
            "satisfied_words")


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     devices: Optional[Sequence] = None, **kwargs) -> None:
    """Initialize the process group (``torch.distributed.init_process_group``).

    Pass ``init_method`` (``"tcp://localhost:<port>"``), ``rank`` and
    ``world_size`` for an explicit cluster, or nothing to read torchrun's
    environment (``env://``).  ``backend`` defaults to ``"nccl"``, or to
    ``"gloo"`` when every device of ``devices`` is the CPU; other keyword
    arguments (``timeout``) pass through.  Idempotent: a second call on an
    initialized group is a no-op.  Failures propagate — a group that cannot
    form is an error, never a single-process run or another backend.
    """
    if dist.is_initialized():
        return
    if backend is None:
        cpu = devices is not None and all(
            torch.device(d).type == "cpu" for d in devices)
        backend = "gloo" if cpu else "nccl"
    given = dict(init_method=init_method, rank=rank, world_size=world_size)
    dist.init_process_group(
        backend=backend,
        **{k: v for k, v in given.items() if v is not None}, **kwargs)


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over every rank, in place (no collective in a world of
    one); returns ``t``."""
    if world()[1] > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_max(value: int, device) -> int:
    """The largest of every rank's ``value`` (one int64 collective on
    ``device``; none in a world of one)."""
    if world()[1] == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def all_reduce_dict(d: dict) -> dict:
    """:func:`all_reduce_sum` of a dict of int64 tensors on one device, in
    one collective (the tensors packed into one vector)."""
    if world()[1] == 1:
        return d
    flat = all_reduce_sum(torch.cat([v.reshape(-1) for v in d.values()]))
    out, at = {}, 0
    for k, v in d.items():
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("snr", "data") grid of slots.

    ``slots[si · n_data + di]`` is slot (si, di): the (rank, device) that
    runs it.  Each rank owns a contiguous, equal block of slots; a device
    may hold several slots."""

    slots: Tuple[Tuple[int, torch.device], ...]
    n_snr: int = 1

    axis_names = ("snr", "data")

    @property
    def n_data(self) -> int:
        return len(self.slots) // self.n_snr

    @property
    def shape(self) -> dict:
        return {"snr": self.n_snr, "data": self.n_data}

    @property
    def size(self) -> int:
        return len(self.slots)

    def local(self) -> List[Tuple[int, int, torch.device]]:
        """(si, di, device) of the slots this process's rank runs."""
        rank = world()[0]
        nd = self.n_data
        return [(i // nd, i % nd, dev)
                for i, (r, dev) in enumerate(self.slots) if r == rank]

    @property
    def home(self) -> torch.device:
        """The device of this rank's first slot, where its counters
        gather."""
        return self.local()[0][2]

    @property
    def ranks(self) -> int:
        """How many ranks own slots of the mesh."""
        return len({r for r, _ in self.slots})

    def data_slots(self) -> List[Tuple[int, torch.device]]:
        """(data index, device) of this rank's slots, for a run sharded
        over the data axis alone (a stream: one snr slot)."""
        if self.n_snr != 1:
            raise ValueError(f"a run sharded over 'data' needs one 'snr' "
                             f"slot, not {self.n_snr}")
        return [(di, dev) for _, di, dev in self.local()]


def spawn_ranks(cmd: Sequence[str], n: int) -> int:
    """Run ``cmd`` as ``n`` ranks of one process group on this host, as
    torchrun starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a free local
    port), so that each rank takes its own card (:func:`local_cuda_devices`).
    A rank that fails ends the others; returns its exit code, or 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(list(cmd), env=dict(
            os.environ, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
            MASTER_PORT=str(port)))
        for r in range(n)
    ]
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.2)
        failed = [p.returncode for p in procs if p.returncode]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return failed[0] if failed else 0


def local_cuda_devices() -> List[torch.device]:
    """This rank's CUDA devices: every visible one, or, under torchrun
    with several ranks on the host, those of its local rank."""
    n = torch.cuda.device_count()
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    devs = [torch.device("cuda", i)
            for i in range(n)][local_rank::local_world]
    if not devs:
        raise RuntimeError(
            "make_mesh: no CUDA device is available to this rank (pass "
            "devices=, e.g. ['cpu'] * 4, to run on the CPU)")
    return devs


def make_mesh(n_snr: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """2-D ("snr", "data") mesh of slots.

    ``devices``: the global slot list, each rank owning a contiguous equal
    block of it (a device may repeat); by default one slot per local CUDA
    device of every rank, in rank order.  n_snr must divide the slot count;
    the remaining factor becomes the data axis."""
    size = world()[1]
    if devices is None:
        devices = local_cuda_devices() * size
    devices = [torch.device(d) for d in devices]
    nd = len(devices)
    if nd % size:
        raise ValueError(f"{nd} slots cannot be split evenly over {size} "
                         "ranks")
    if nd % n_snr:
        raise ValueError(f"{nd} devices not divisible by n_snr={n_snr}")
    per_rank = nd // size
    return Mesh(tuple((i // per_rank, d) for i, d in enumerate(devices)),
                n_snr)


# A counters dict (one step's output, on the host) has keys errors,
# uncoded_errors, word_errors, iteration_sum, satisfied_words — each [S]
# int64 — plus error_weight_hist [S, N+1], iteration_hist [S, T+1] and,
# when the decoder reports it, smoothing_used [S].  Frame and bit totals
# are the step's attributes (step.batch_global, step.bits_global).
BatchCounters = dict


def _f32(v) -> float:
    """The f32 value of an operating-point scalar, as a Python float."""
    return float(np.float32(v))


def make_grid_step(
    code: Code,
    decode_fn: Callable,
    mesh: Mesh,
    batch_per_device: int,
    max_iterations: int,
    param_names: Tuple[str, ...] = (),
    preprocess: Optional[Callable] = None,
    awgn_form: str = "multiplicative",
    codewords=None,
):
    """Build the operating-point-grid Monte-Carlo step.

    The mesh's "snr" axis is the operating-point axis: each slot gets its
    own sigma and its own value of every name in ``param_names``, so the
    step serves any assignment of grid points to slots.

    decode_fn(samples [b, N], sigma, key, point) -> DecodeResult-like with
    .hard [b, N], .iterations [b], .satisfied [b] (and, if the decoder
    reports it, .smoothing_used [b]); ``key`` is the slot's
    :class:`..decoders.base.NoiseKey` and ``point`` a dict {name: float}
    over param_names.  preprocess(y, point) if given.

    Returns step(seed, sigmas [S], params {name: [S]}, frame0s [S] = 0) ->
    BatchCounters, where S = the mesh "snr" axis size and snr slot si
    decodes frames frame0s[si] … frame0s[si] + B_global − 1 (B_global =
    batch_per_device · the data axis size).  While a profiler runs, each
    slot, its decode, the all-reduce and the host copy are :mod:`..spans`
    ranges.
    """
    n_snr, n_data = mesh.n_snr, mesh.n_data
    n, T, bpd = code.n, max_iterations, batch_per_device
    param_names = tuple(param_names)
    # the JAX engine's int32 guard: errors <= bits, so the per-step global
    # bit count bounds every counter
    if bpd * n_data * n > 2**31 - 1:
        raise ValueError(
            f"per-step bits {bpd * n_data * n} exceed int32; "
            "reduce batch_per_device (throughput comes from more steps)"
        )
    if awgn_form not in _AWGN_FORMS:
        raise ValueError(f"awgn_form {awgn_form!r} not in {_AWGN_FORMS}")
    local = mesh.local()
    home = mesh.home
    cw = {}
    if codewords is not None:
        codewords = np.asarray(codewords, np.uint8)
        if codewords.ndim != 2 or codewords.shape[1] != n:
            raise ValueError(f"codewords must be [L, {n}]")
        for _, _, dev in local:  # one copy per device
            if dev not in cw:
                cw[dev] = torch.tensor(codewords, device=dev)

    def run_slot(seed, f0, sigma, point, device):
        """One slot's decode and its counters as one [W] int64 vector on
        its device (no host read)."""
        with spans.span(spans.GRID_SLOT):
            y = awgn_all_zero(seed, f0, bpd, n, sigma, device)
            if cw:
                fixture = cw[device]
                idx = ((f0 + torch.arange(bpd, device=device))
                       % fixture.shape[0])
                c = bpsk(fixture[idx])
                y = c * y if awgn_form == "multiplicative" else y + (c - 1.0)
            else:
                c = 1
            inp = preprocess(y, point) if preprocess is not None else y
            with spans.span(spans.DECODE):
                res = decode_fn(inp, sigma, NoiseKey(seed, f0), point)
            frame_errs = (res.hard != c).sum(dim=1)
            uncoded = ((y > 0) != (c > 0)).sum(dim=1)
            its = res.iterations.to(torch.int64)
            # out-of-range iteration counts vanish, as JAX's mode="drop"
            in_range = ((its >= 0) & (its <= T)).to(torch.int64)
            ihist = torch.zeros(T + 1, dtype=torch.int64, device=device)
            ihist.index_add_(0, torch.where(in_range > 0, its, 0), in_range)
            ewh = torch.zeros(n + 1, dtype=torch.int64, device=device)
            ewh.index_add_(0, frame_errs, torch.ones_like(frame_errs))
            parts = [frame_errs.sum(), uncoded.sum(), (frame_errs > 0).sum(),
                     its.sum(), res.satisfied.sum()]
            su = getattr(res, "smoothing_used", None)
            if su is not None:
                parts.append(su.sum())
            scalars = torch.stack([p.to(torch.int64) for p in parts])
            return torch.cat([scalars, ewh, ihist])

    def step(seed: int, sigmas: Sequence[float], params=None,
             frame0s: Optional[Sequence[int]] = None) -> BatchCounters:
        params = params or {}
        f0s = [0] * n_snr if frame0s is None else [int(f) for f in frame0s]
        rows = [
            (si, run_slot(seed, f0s[si] + di * bpd, _f32(sigmas[si]),
                          {nm: _f32(params[nm][si]) for nm in param_names},
                          dev))
            for si, di, dev in local
        ]
        with spans.span(spans.GRID_ALLREDUCE):
            total = torch.zeros((n_snr, rows[0][1].numel()),
                                dtype=torch.int64, device=home)
            for si, v in rows:
                total[si] += v.to(home)
            total = all_reduce_sum(total)
        with spans.span(spans.GRID_TO_HOST):
            flat = total.cpu().numpy()
        keys = _SCALARS + (("smoothing_used",)
                           if flat.shape[1] > len(_SCALARS) + n + T + 2
                           else ())
        out = {k: flat[:, i] for i, k in enumerate(keys)}
        at = len(keys)
        out["error_weight_hist"] = flat[:, at:at + n + 1]
        out["iteration_hist"] = flat[:, at + n + 1:]
        return out

    step.batch_global = bpd * n_data
    step.bits_global = bpd * n_data * n
    step.n_snr = n_snr
    return step


def make_counters_step(
    code: Code,
    decode_fn: Callable,
    mesh: Mesh,
    sigmas: Sequence[float],
    batch_per_device: int,
    max_iterations: int,
    preprocess: Optional[Callable] = None,
    awgn_form: str = "multiplicative",
    codewords=None,
):
    """Fixed-operating-point wrapper over :func:`make_grid_step`.

    decode_fn(samples [b, N], sigma, key) -> DecodeResult-like.

    Returns step(seed, round_idx=0) -> BatchCounters, where S = len(sigmas)
    must equal the mesh "snr" axis size and every snr slot decodes frames
    round_idx·B_global … (round_idx + 1)·B_global − 1 of its own point.
    """
    n_snr = mesh.n_snr
    if len(sigmas) != n_snr:
        raise ValueError(f"need {n_snr} sigmas for the snr axis")
    sigmas = list(sigmas)
    gstep = make_grid_step(
        code,
        lambda y, sigma, key, point: decode_fn(y, sigma, key),
        mesh,
        batch_per_device=batch_per_device,
        max_iterations=max_iterations,
        preprocess=(
            None if preprocess is None else (lambda y, point: preprocess(y))
        ),
        awgn_form=awgn_form,
        codewords=codewords,
    )

    def step(seed: int, round_idx: int = 0) -> BatchCounters:
        return gstep(seed, sigmas, {},
                     [round_idx * gstep.batch_global] * n_snr)

    step.batch_global = gstep.batch_global
    step.bits_global = gstep.bits_global
    step.n_snr = n_snr
    return step
