"""NGDBFhw: the bit-accurate fixed-point NGDBF of the 10GBASE-T ASIC model.

Port of ``ldpcsimulation_tpu.decoders.ngdbf_hw`` (whose docstring cites the
reference line of every rule), with the same integer datapath, so the
decisions equal the JAX decoder's bit for bit on the same samples and the
same noise ring.  In short:

  * ``lmax = Ymax/(2w)``, ``NL = 2^NQ − 1``; a sample quantizes to the odd
    integer ``±(2·floor(|x|·NL/(2·lmax)) + 1)`` with sgn(0) = −1
    (:func:`hw_quantize_int`); ``theta = 2·floor(2·NL/(2·lmax)) + 1`` and
    ``Smult = floor(NL/lmax + 0.5)`` (C ``round``: half away from zero);
  * channel: clip to ±Ymax (multiplicatively), then ``quantize(y/(2w))``;
  * the noise ring ``[ring_len, B]`` of ``(σ·noise_scale·n − θ0)/(2w) − 1``
    clipped to ±lmax and quantized, drawn once per frame and shared by all
    phases; bit i at an executed iteration reads ``ring[i + qpointer]``, and
    the pointer advances once per executed iteration, wrapping at
    ``ring_len − N``;
  * ``E_i = (1−2d_i)·y'_i + Smult·Σ_j(1 − s_j) + q_{i+ptr}``; flip when
    ``E_i <= theta``; the syndrome is checked at each iteration's start;
  * all ``max_phases`` phases run, each from the channel decisions; the
    result keeps the least errors (against ``true_bits``) and the least
    iterations over the phases.

Derived constants.  The JAX config carries w, Ymax, noise scale and θ0 as
pytree data, so under x64 they are f64 scalars: ``lmax``, ``theta_int`` and
``smult`` are computed in double, and each scalar is rounded to f32 where it
meets an f32 array (``f32(2w)``, ``f32(2·lmax)``, ``f32(θ0)``, ``f32(lmax)``
for the clip).  Here they are Python doubles, and each is made a 0-dim f32
tensor on the samples' device where it meets a tensor: PyTorch's CUDA
division by a Python scalar is a reciprocal multiply.

Noise ring.  The JAX decoder draws the ring from its key; here frame ``f``
of seed ``s`` draws its ring column with kernel B4
(:func:`..kernels.channel.gauss_philox`, offset 0, scale ``f32(σ·noise
scale)``) on :data:`..kernels.channel.NGDBFHW_RING_STREAM`, so a frame
decodes the same in any batch; :func:`lane_rings` draws the same rings for
any set of frame ids (the streaming harness's refilled lanes).
``ring_noise=`` injects a pre-drawn ring.
As in the JAX decoder, one phase without ``qpointer0`` reads the ring as a
contiguous slice (every lane still decoding has the pointer ``it``; a
frozen lane's samples are never used), and otherwise each lane reads its
own window (a strided view indexed by the lane's pointer).  Every few
steps the host reads whether every lane is frozen; a frozen lane changes
no state, so the loop then jumps to the next phase's start, and the result
is the same.

The graph operations are one row gather each over the code's (or the QC
structure's) slot tables: the syndrome as the parity of a check's bits,
the per-variable count of unsatisfied checks as a sum; or, with
``dense=``, one matrix product each (:mod:`.dense_ops`).  The metric is
computed in int16 when its bound ``2·NL + dv_max·Smult`` fits (int32
otherwise): the same integers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..codes.code import Code
from ..codes.qc import QCCode
from ..kernels.channel import (
    NGDBFHW_RING_STREAM,
    gauss_philox,
    gauss_philox_lanes,
)
from .base import NoiseKey
from .dense_ops import DenseGraph, dense_sat_sum_per_vn, dense_syndrome01
from .gdbf import DONE_CHECK_EVERY
from .qc_ops import qc_graph, slot_graph

__all__ = [
    "NGDBFHwConfig",
    "NGDBFHwResult",
    "hw_graph_ops",
    "hw_quantize_int",
    "keyed_ring",
    "lane_rings",
    "RING_LANE_STEP",
    "decode_ngdbf_hw",
]


@dataclasses.dataclass(frozen=True)
class NGDBFHwConfig:
    """The JAX ``NGDBFHwConfig``'s fields (the 802.3an operating point by
    default); a plain frozen dataclass here."""

    num_iterations: int = 600
    w: float = 0.185
    ymax: float = 1.625
    noise_scale: float = 0.95
    theta0: float = -0.525
    nq: int = 5
    max_phases: int = 1
    ring_len: int = 2648

    @property
    def lmax(self) -> float:
        return self.ymax / (2.0 * self.w)

    @property
    def nl(self) -> int:
        return 2 ** self.nq - 1

    @property
    def theta_int(self) -> int:
        """unpack(pack(quantize(2), +1))."""
        return 2 * math.floor(2.0 * self.nl / (2.0 * self.lmax)) + 1

    @property
    def smult(self) -> int:
        """round(NL/lmax), C ``round``: half away from zero."""
        return math.floor(self.nl / self.lmax + 0.5)

    @classmethod
    def from_reference(cls, obj) -> "NGDBFHwConfig":
        """Copy any object with the JAX config's fields (read by attribute,
        so the port needs no import of it)."""
        cast = {"int": int, "float": float}
        return cls(**{
            f.name: cast[f.type](getattr(obj, f.name))
            for f in dataclasses.fields(cls)
        })


@dataclasses.dataclass
class NGDBFHwResult:
    """hard [B, N] ±1 int32 from the phase with the least errors;
    iterations [B] int32, the least over the phases; satisfied [B], the
    last phase's syndrome state; least_errors [B] int32 against the true
    codeword; qpointer [B] int32, the ring pointer at exit (a run that
    carries it across frames feeds it back as ``qpointer0``, see
    ``harness.simulate(decode_carry0=)``); steps — the loop steps the
    decode ran (a host int)."""

    hard: torch.Tensor
    iterations: torch.Tensor
    satisfied: torch.Tensor
    least_errors: torch.Tensor
    qpointer: torch.Tensor
    steps: int = 0


def _f32(v: float, device) -> torch.Tensor:
    """A Python scalar as a 0-dim f32 tensor on ``device`` (a fill, not a
    host copy: no sync on the card)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def hw_quantize_int(x: torch.Tensor, nl: int, lmax: float) -> torch.Tensor:
    """quantize + pack + unpack: ``±(2·floor(|x|·NL/(2·lmax)) + 1)`` as
    int32, sgn(0) = −1.  ``x`` is expected clipped to ±lmax."""
    mag = torch.floor(x.abs() * nl / _f32(2.0 * lmax, x.device))
    sign = torch.where(x > 0, 1, -1).to(torch.int32)
    return sign * (2 * mag.to(torch.int32) + 1)


def _gather_reduce(x, table, padded, reduce):
    """reduce over slots t of x[table[:, t]] ([rows, slots, B] in one
    gather), with row ``len(x)`` a zero row."""
    if padded:
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return reduce(x[table])


def hw_graph_ops(code: Code, qc: Optional[QCCode] = None,
                 dense: Optional[DenseGraph] = None):
    """(syndrome01, satsum), the graph operations of the NGDBFhw update.

    syndrome01(d {0,1} uint8 [N, B]) -> [M, B] uint8 {0,1}, 0 = satisfied
    (the parity of a check's bits); satsum(syn01) -> [N, B] int16, the count
    of satisfied neighbour checks of each variable.  One matrix product
    each on ``dense`` when it is given (before ``qc``, as in the JAX
    package); else one row gather each on the QC tables
    (:func:`.qc_ops.qc_graph`) when ``qc`` is given, else on the code's
    slot tables: the same integers every way.
    """
    if dense is not None:
        return (functools.partial(dense_syndrome01, dense),
                functools.partial(dense_sat_sum_per_vn, dense))

    def graph(device):
        return qc_graph(qc, device) if qc is not None else slot_graph(
            code, device)

    def syndrome01(d):
        g = graph(d.device)
        return _gather_reduce(d, g.check_cols, g.padded_checks,
                              lambda v: v.sum(dim=1, dtype=torch.uint8) & 1)

    def satsum(syn):
        g = graph(syn.device)
        unsat = _gather_reduce(syn, g.vn_checks, g.padded_vns,
                               lambda v: v.sum(dim=1, dtype=torch.int16))
        return code.vn_deg.to(syn.device, torch.int16)[:, None] - unsat

    return syndrome01, satsum


def _ring_integers(cfg: NGDBFHwConfig, qn: torch.Tensor) -> torch.Tensor:
    """Raw ring draws [ring_len, B] -> quantized ring integers (an infinite
    draw clips to ±lmax like any other)."""
    dev = qn.device
    lm = _f32(cfg.lmax, dev)
    qmod = (qn - _f32(cfg.theta0, dev)) / _f32(2.0 * cfg.w, dev) - 1.0
    qint = hw_quantize_int(torch.clamp(qmod, -lm, lm), cfg.nl, cfg.lmax)
    # |q| <= 2^NQ - 1: int16 halves the per-step gather's traffic
    return qint.to(torch.int16) if cfg.nq <= 15 else qint


#: the per-lane step whose decoder stream ``1 + 2·step + 0`` (taken mod
#: 2³² by B4's per-lane entry and its twin) is the ring's stream
#: :data:`..kernels.channel.NGDBFHW_RING_STREAM`
RING_LANE_STEP = (NGDBFHW_RING_STREAM - 1) // 2


def _ring_scale(cfg: NGDBFHwConfig, sigma: float) -> float:
    """The ring draw's scale ``f32(σ·noise_scale)``."""
    return float(np.float32(sigma * cfg.noise_scale))


def keyed_ring(cfg: NGDBFHwConfig, sigma: float, key: NoiseKey, batch: int,
               device) -> torch.Tensor:
    """The raw ring ``[ring_len, batch]`` the decoder draws for the frames
    key.frame0 … (kernel B4, ``σ' = f32(σ·noise_scale)``), for injection
    and replay."""
    return gauss_philox(key.seed, key.frame0, batch, cfg.ring_len,
                        NGDBFHW_RING_STREAM, 0.0, _ring_scale(cfg, sigma),
                        device)


def lane_rings(cfg: NGDBFHwConfig, sigma: float, seed: int,
               gid: torch.Tensor) -> torch.Tensor:
    """The raw rings ``[ring_len, len(gid)]`` of frames ``gid[b]`` (int64,
    any order), on gid's device: the bits :func:`keyed_ring` draws for
    those frames.

    B4's per-lane entry keys column b by (seed, gid[b]) on stream ``1 +
    2·step[b] + domain`` in 32-bit arithmetic; :data:`RING_LANE_STEP` with
    domain 0 makes that the ring's reserved stream, which
    :func:`..kernels.channel.noise_stream` never gives a decoder draw.  So
    a streaming lane draws its frame's ring, the one the batch decoder
    draws for that frame, with no injection."""
    step = torch.full(gid.shape, RING_LANE_STEP, dtype=torch.int32,
                      device=gid.device)
    return gauss_philox_lanes(seed, gid, step, cfg.ring_len, 0, 0.0,
                              _ring_scale(cfg, sigma))


def decode_ngdbf_hw(
    code: Code,
    y: torch.Tensor,
    sigma: float,
    cfg: NGDBFHwConfig,
    key: Optional[NoiseKey] = None,
    true_bits: Optional[torch.Tensor] = None,
    qpointer0: Optional[torch.Tensor] = None,
    ring_noise: Optional[torch.Tensor] = None,
    dense: Optional[DenseGraph] = None,
    qc: Optional[QCCode] = None,
) -> NGDBFHwResult:
    """Batched fixed-point NGDBF decode.

    y: [B, N] raw channel samples (the decoder clips and quantizes them).
    sigma: the channel's noise std-dev.  key: the frames' noise coordinates
    (needed unless ``ring_noise`` is given).  true_bits: [B, N] transmitted
    bits for the least-errors selection (all-zero if None).  qpointer0: [B]
    initial ring offsets in [0, ring_len − N) (0 if None).  ring_noise:
    optional [ring_len, B] raw ring draws (σ·noise_scale·n) that replace the
    keyed draw.  dense: optional :class:`.dense_ops.DenseGraph` of the
    SAME code — the graph operations as matrix products (taken before
    ``qc``).  qc: optional QC structure of the SAME code — row-gather
    graph operations on its tables.  Both are bit-identical to the generic
    ones.
    """
    if qc is not None and (qc.n != code.n or qc.m != code.m):
        raise ValueError("qc structure does not match code dimensions")
    if dense is not None and (dense.n != code.n or dense.m != code.m):
        raise ValueError("dense graph does not match code dimensions")
    if ring_noise is None and key is None:
        raise ValueError("decode_ngdbf_hw needs a noise key or ring_noise")
    y_t = y.t().to(torch.float32)  # [N, B]
    device = y_t.device
    n, b = y_t.shape
    T = cfg.num_iterations
    theta, smult = cfg.theta_int, cfg.smult
    ring_mod = cfg.ring_len - n
    if ring_mod <= 0:
        raise ValueError("ring_len must exceed code length")

    # channel clip + quantize
    ym = _f32(cfg.ymax, device)
    ay = y_t.abs()
    y_clip = torch.where(ay > ym, y_t * (ym / ay), y_t)
    d_init = (y_clip <= 0).to(torch.uint8)  # {0,1}: 1 where sgn(y) = -1
    yint = hw_quantize_int(y_clip / _f32(2.0 * cfg.w, device), cfg.nl,
                           cfg.lmax)
    # |E| <= 2·NL + dv_max·Smult: int16 where that fits halves the traffic
    edt = (torch.int16 if 2 * cfg.nl + code.dv_max * smult < 2**15
           else torch.int32)
    yint = yint.to(edt)
    neg_yint = -yint  # (1 - 2d)·y' as a select

    # the noise ring, drawn once per frame and shared by the phases
    qn = (ring_noise.to(device, torch.float32) if ring_noise is not None
          else keyed_ring(cfg, sigma, key, b, device))
    qint = _ring_integers(cfg, qn)
    if cfg.max_phases == 1 and qpointer0 is None:
        def ring_values(it, qptr):
            return qint[it % ring_mod:it % ring_mod + n]
    else:
        # window[s, i, c] = qint[s + i, c]: lane c reads ptr_c … ptr_c+N-1
        window = qint.as_strided((ring_mod, n, b), (b, b, 1))
        rows = torch.arange(n, device=device)[:, None]
        lanes = torch.arange(b, device=device)[None, :]

        def ring_values(it, qptr):
            return window[qptr.long()[None, :], rows, lanes]

    c_bits = (torch.zeros((n, b), dtype=torch.uint8, device=device)
              if true_bits is None
              else true_bits.t().to(device, torch.uint8))
    qptr = (torch.zeros((b,), dtype=torch.int32, device=device)
            if qpointer0 is None
            else qpointer0.to(device, torch.int32).clone())
    syndrome01, satsum = hw_graph_ops(code, qc, dense)

    least_iters = torch.full((b,), T, dtype=torch.int32, device=device)
    least_errs = torch.full((b,), n, dtype=torch.int32, device=device)
    best_d = d_init
    d = d_init
    frozen = torch.zeros((b,), dtype=torch.bool, device=device)
    phase_iters = least_iters

    def phase_end():
        nonlocal least_errs, best_d, least_iters
        errs = (d != c_bits).sum(dim=0, dtype=torch.int32)
        better = errs < least_errs
        least_errs = torch.where(better, errs, least_errs)
        best_d = torch.where(better[None, :], d, best_d)
        least_iters = torch.minimum(least_iters, phase_iters)

    total = cfg.max_phases * T
    step = executed = 0
    while step < total:
        phase, it = divmod(step, T)
        if it == 0:
            if step > 0:
                phase_end()
            d = d_init
            frozen = torch.zeros((b,), dtype=torch.bool, device=device)
            phase_iters = torch.full((b,), T, dtype=torch.int32,
                                     device=device)
        elif it % DONE_CHECK_EVERY == 0 and bool(frozen.all()):
            step = (phase + 1) * T  # the rest of the phase changes nothing
            continue

        syn = syndrome01(d)  # [M, B]
        satisfied = (syn == 0).all(dim=0)
        phase_iters = torch.where(~frozen & satisfied, it, phase_iters)
        frozen = frozen | satisfied
        act = ~frozen

        e = (torch.where(d.bool(), neg_yint, yint)
             + satsum(syn).to(edt) * smult + ring_values(it, qptr))
        d = torch.where(act[None, :] & (e <= theta), 1 - d, d)
        qptr = torch.where(act, (qptr + 1) % ring_mod, qptr)
        step += 1
        executed += 1

    # the last phase's frozen flags are the reference's `satisfied` at exit
    satisfied = frozen
    phase_end()
    return NGDBFHwResult(
        hard=(1 - 2 * best_d.to(torch.int32)).t(),
        iterations=least_iters,
        satisfied=satisfied,
        least_errors=least_errs,
        qpointer=qptr,
        steps=executed,
    )
