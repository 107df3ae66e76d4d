"""GDBF / NGDBF gradient-descent bit-flipping family.

Port of ``ldpcsimulation_tpu.decoders.gdbf``, with the same arithmetic and
the same operation order, so the decisions equal the JAX decoder's bit for
bit on the same samples and the same injected noise.  One configuration
dataclass stands for the reference's compile-time flag matrix (see
:data:`PRESETS`); the JAX module's docstring cites the reference line of
every rule.  In short:

  * CN update: the bipolar syndrome product of each check over the current
    decisions, tested at the *start* of each iteration, so the reported
    iteration count is the loop index at which the frame checked out;
  * flip metric ``E_i = d_i·y_i + Σ_j w·s_j + q_i`` (``w = alpha`` with
    weight_syndromes; ``alpha·Ymax/dv_i`` with legacy_weight);
  * parallel mode flips every ``E_i < θ_i``; sequential mode only the first
    minimum, and its running-minimum candidates drive threshold adaptation;
  * threshold adaptation ``θ_i ← θ_i·λ`` for bits that did not flip;
  * mode switching to sequential when the objective did not improve;
  * output smoothing over the last ``window_size − 1`` iterations of a
    frame that ends unsatisfied;
  * stochastic flips (quantizeProbabilities): probability
    ``Φ((θ_i − E_i)/σ')`` snapped to the nearest of 8 hardware levels;
  * redecode phases: restarts from the channel decisions with fresh noise.

Kernels.  On the QC and slot-array graphs every step's syndrome and its
check are one launch of kernel B6 (:func:`..kernels.check.parity_check`);
the parallel rule's VN side — neighbour sum, metric, flip, adaptation and
smoothing sum — is one launch of kernel B7
(:func:`..kernels.gdbf.gdbf_parallel_step`), in place on int8 decisions.
The sequential, mode-switching and stochastic rules, and the dense route,
keep the plain torch VN side.

Two step paths.  The parallel rule on a QC or slot-array graph, with B4's
keyed Gaussian noise or none, no injected sequences and no trace, runs
in chunks: the steps between two exit checks (at most
:data:`DONE_CHECK_EVERY`, and never across a phase start) are issued by
one call of :func:`..kernels.gdbf.gdbf_chunk` — per step B6, the ``[B]``
bookkeeping as one kernel, B4 and B7 — on one plan per decode (planes
validated and lane widths chosen once; the syndrome, flag and
perturbation buffers allocated once).  On the CPU the chunk is its plain
twin: the per-step body run over the same steps.  Every other decode
runs the per-step loop, whose Python sees each step (replay, injection,
uniform noise, noise shaping, the other rules, the dense route).  The
two give the same results bit for bit; ``build.PATHS["gdbf_step",
"chunk" | "loop"]`` counts the steps each path took.

Decoder noise.  The JAX decoder folds one key per batch and step.  Here the
noise of frame ``f`` at step ``t`` is keyed by (run seed, f, t) through
:class:`.base.NoiseKey`, so a frame decodes the same in any batch: the
perturbation ``σ'·√2·erfinv(2u − 1)`` comes from kernel B4
(:func:`..kernels.channel.gauss_philox`, ``σ' = f32(σ·noise_scale)``), or,
with ``uniform_noise``, the uniforms of kernel B3 go through the JAX
transform ``√3·σ'·2·(u − 0.5)``; the stochastic flips draw B3's uniforms on
a second stream (:func:`..kernels.channel.noise_stream`).  The
``perturbations=`` / ``stoch_uniforms=`` hooks inject pre-drawn
``[steps, N, B]`` sequences instead, as in the JAX decoder.

Two numeric notes.  Mode switching compares two f32 sums over N, which
PyTorch and XLA reduce in different orders: a near-tie within the sum's
rounding error could be decided differently.  The stochastic rule's ``Φ``
uses JAX's ``ndtr`` formula with PyTorch's ``erf``/``erfc``, which can
differ from XLA's by an ulp: a decision moves only if ``Φ`` lies within an
ulp of a level midpoint.

``trace=True`` runs the whole step budget with no early exit and returns
every step's decisions as well (the source of :mod:`..tools.replay`'s
traces).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..codes.code import Code
from ..codes.qc import QCCode
from ..kernels import build
from ..kernels.channel import gauss_philox, noise_stream, uniform_philox
from ..kernels.check import parity_check
from ..kernels.gdbf import (
    gdbf_chunk,
    gdbf_chunk_plan,
    gdbf_lanes_plain,
    gdbf_parallel_step,
)
from .base import NoiseKey, all_done
from .dense_ops import (
    DenseGraph,
    dense_syndrome_bipolar,
    dense_syndrome_sum_per_vn,
)
from .qc_ops import qc_graph, slot_graph, syndrome_sum_per_vn

__all__ = [
    "GDBFConfig",
    "GDBFResult",
    "PR_LEVELS",
    "PRESETS",
    "preset",
    "flip_decisions",
    "keyed_draws",
    "decode_gdbf",
]

# Hardware-realizable flip probabilities (decodeGDBF.cpp:564-575).
PR_LEVELS = (0.0, 0.0625, 0.125, 0.25, 0.34375, 0.4106, 0.68359, 1.0)

#: the loop reads "all frames done" from the card every this many steps.
#: Once every frame is done, a step changes nothing that is returned
#: (every state update is masked by the active set), so the extra steps
#: are exact; the check is a host sync, which drains the launch queue.
DONE_CHECK_EVERY = 4


@dataclasses.dataclass(frozen=True)
class GDBFConfig:
    """Configuration = the reference's -D flag set + argv scalars (the JAX
    ``GDBFConfig``'s fields; a plain frozen dataclass here)."""

    num_iterations: int
    theta: float
    sequential: bool = False
    mode_switching: bool = False
    t_switch: int = 0
    add_noise: bool = False
    uniform_noise: bool = False
    noise_shaping: bool = False
    noise_scale: float = 1.0
    threshold_adaptation: bool = False
    lam: float = 0.991
    weight_syndromes: bool = False
    alpha: float = 2.25
    # RNGDBF's per-node weight w_i = alpha*Ymax/dv_i (see the JAX config)
    legacy_weight: bool = False
    weight_ymax: float = 2.5
    output_smoothing: bool = False
    window_size: int = 64
    quantize_probabilities: bool = False
    max_phases: int = 1

    @classmethod
    def from_reference(cls, obj) -> "GDBFConfig":
        """Copy any object with the JAX config's fields (read by attribute,
        so the port needs no import of it)."""
        cast = {"int": int, "float": float, "bool": bool}
        return cls(**{
            f.name: cast[f.type](getattr(obj, f.name))
            for f in dataclasses.fields(cls)
        })


# The reference Makefile's binary -> flag-set registry.
PRESETS = {
    "GDBF": dict(),
    "MGDBF": dict(mode_switching=True),
    "SGDBF": dict(sequential=True),
    "SMGDBF": dict(output_smoothing=True),
    "ATGDBF": dict(threshold_adaptation=True),
    "SATGDBF": dict(threshold_adaptation=True, output_smoothing=True),
    "MNGDBF": dict(
        add_noise=True, threshold_adaptation=True, weight_syndromes=True
    ),
    "SMNGDBF": dict(
        add_noise=True,
        threshold_adaptation=True,
        weight_syndromes=True,
        output_smoothing=True,
    ),
    "StochasticNGDBF": dict(quantize_probabilities=True, weight_syndromes=True),
    "RSMNGDBF": dict(
        add_noise=True,
        threshold_adaptation=True,
        weight_syndromes=True,
        output_smoothing=True,
        max_phases=7,
        legacy_weight=True,
    ),
}


def preset(name: str, num_iterations: int, theta: float,
           **overrides) -> GDBFConfig:
    """Config matching a reference binary by name (e.g. "SMNGDBF")."""
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return GDBFConfig(num_iterations=num_iterations, theta=theta, **kw)


@dataclasses.dataclass
class GDBFResult:
    """hard [B, N] ±1 int32; iterations [B] (accumulated across redecode
    phases); satisfied [B]; phases [B] (attempted phases); smoothing_used
    [B] (phases that entered the smoothing window); steps — the loop steps
    the decode ran (a host int: each draws the keyed noise once)."""

    hard: torch.Tensor
    iterations: torch.Tensor
    satisfied: torch.Tensor
    phases: torch.Tensor
    smoothing_used: torch.Tensor
    steps: int = 0


def _f32(x: float) -> float:
    """A Python float rounded to f32 (exact where it meets an f32 tensor)."""
    return float(np.float32(x))


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``ndtr`` formula (``jax._src.scipy.special._ndtr``)."""
    h = _f32(np.float32(0.5) * np.sqrt(np.float32(2.0)))
    w = x * h
    z = w.abs()
    y = torch.where(
        z < h, 1.0 + torch.erf(w),
        torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)),
    )
    return 0.5 * y


def flip_decisions(cfg: GDBFConfig, e, thetas, mu, noise_sigma, rnum):
    """(flip, flip_for_adapt) masks from the flip metric ``e`` [N, B].

    Stochastic: the level nearest to ``Φ((θ_i − E_i)/σ')`` (squared
    distance, a strict < scan from a distance of 1, so the first minimum
    wins and a distance of 1 keeps level 0), then ``rnum < level``.
    Parallel: ``E_i < θ_i``.  Sequential (``mu == 0``): the first minimum,
    with the exclusive prefix-min candidates for adaptation.
    ``noise_sigma`` is a 0-dim f32 tensor on e's device (a divisor).
    """
    n, b = e.shape
    if cfg.quantize_probabilities:
        pcdf = _ndtr((thetas - e) / noise_sigma)
        best = torch.ones_like(pcdf)
        p_flip = torch.zeros_like(pcdf)  # level 0
        for level in PR_LEVELS:
            lv = _f32(level)
            diff = lv - pcdf
            dist = diff * diff
            take = dist < best
            best = torch.where(take, dist, best)
            p_flip = torch.where(take, lv, p_flip)
        flip = rnum < p_flip
        return flip, flip
    flip_par = e < thetas
    if not (cfg.sequential or cfg.mode_switching):
        # mu stays 1 (parallel) in every frame: the sequential masks would
        # be computed and then never selected
        return flip_par, flip_par
    amin = torch.argmin(e, dim=0)  # first minimum
    one_hot = torch.arange(n, device=e.device)[:, None] == amin[None, :]
    run_min = torch.cummin(e, dim=0).values
    excl_min = torch.cat(
        [torch.full((1, b), math.inf, dtype=e.dtype, device=e.device),
         run_min[:-1]]
    )
    flip_seq_trans = e < excl_min
    is_par = (mu == 1)[None, :]
    flip = torch.where(is_par, flip_par, one_hot)
    flip_for_adapt = torch.where(is_par, flip_par, flip_seq_trans)
    return flip, flip_for_adapt


def _keyed_perturbation(cfg, key: NoiseKey, n, b, step, ns, device):
    """Step ``step``'s perturbation sample [N, B] of frames key.frame0 …"""
    stream = noise_stream(step, 0)
    if cfg.uniform_noise:
        u = uniform_philox(key.seed, key.frame0, b, n, stream, device)
        # ((√3·σ')·2)·(u − 0.5) in f32: the doubling is exact
        c = 2.0 * _f32(np.float32(np.sqrt(3.0)) * np.float32(ns))
        return c * (u - 0.5)
    return gauss_philox(key.seed, key.frame0, b, n, stream, 0.0, ns, device)


def _keyed_uniforms(key: NoiseKey, n, b, step, device):
    """Step ``step``'s stochastic-flip uniforms [N, B]."""
    return uniform_philox(key.seed, key.frame0, b, n, noise_stream(step, 1),
                          device)


def keyed_draws(cfg: GDBFConfig, sigma: float, key: NoiseKey, n: int,
                batch: int, steps: int, device):
    """(perturbations, stoch_uniforms) — the ``[steps, N, B]`` keyed draws
    the decoder makes for these frames (None where the config draws none),
    for injection and replay.  The perturbations are the samples before
    noise shaping."""
    ns = _f32(sigma * cfg.noise_scale)
    pert = unif = None
    if cfg.add_noise:
        pert = torch.stack([
            _keyed_perturbation(cfg, key, n, batch, t, ns, device)
            for t in range(steps)
        ])
    if cfg.quantize_probabilities:
        unif = torch.stack([
            _keyed_uniforms(key, n, batch, t, device) for t in range(steps)
        ])
    return pert, unif


def _vn_side(cfg, graph, dense, d, y_t, syn, thetas, dsum, mu, act, w,
             pert, lam, noise_sigma, rnum, it, in_window):
    """The plain torch VN side of one step (the rules B7 does not take:
    sequential, mode switching, stochastic; and the dense route).  Returns
    (d, thetas, dsum, mu)."""
    dtype = y_t.dtype
    # mode switching: f1 before the flips (stale syndrome)
    if cfg.mode_switching:
        syn_sum = syn.sum(dim=0).to(dtype)
        f1 = (d.to(dtype) * y_t).sum(dim=0) + syn_sum

    # flip metric
    if graph is not None:
        syn_sum_vn = syndrome_sum_per_vn(graph, syn.to(dtype))
    else:
        syn_sum_vn = dense_syndrome_sum_per_vn(dense, syn.to(dtype))
    e = d.to(dtype) * y_t + w * syn_sum_vn
    if pert is not None:
        e = e + pert

    # flip decisions
    flip, flip_for_adapt = flip_decisions(cfg, e, thetas, mu, noise_sigma,
                                          rnum)
    d = torch.where(act[None, :] & flip, -d, d)

    if cfg.threshold_adaptation:
        thetas = torch.where(act[None, :] & ~flip_for_adapt, thetas * lam,
                             thetas)

    # mode switch decision: f2 with the new d, stale syndrome
    if cfg.mode_switching and it > cfg.t_switch:
        f2 = (d.to(dtype) * y_t).sum(dim=0) + syn_sum
        mu = torch.where(act & (f1 >= f2), 0, mu)

    # output smoothing accumulation
    if in_window:
        dsum = torch.where(act[None, :], dsum + d, dsum)
    return d, thetas, dsum, mu


def _chunk_end(step: int, T: int, total_steps: int) -> int:
    """The end of the chunk that starts at ``step``: the next exit check,
    the next phase start or the budget, whichever comes first."""
    return min(total_steps, step - step % DONE_CHECK_EVERY
               + DONE_CHECK_EVERY, step - step % T + T)


def _takes_chunks(cfg, graph, parallel, perturbations, trace) -> bool:
    """Whether a decode runs its steps in chunks (:func:`..kernels.gdbf.
    gdbf_chunk`): the parallel rule on a QC or slot-array graph, with B4's
    keyed Gaussian noise or none, nothing injected and no trace."""
    return (parallel and graph is not None and perturbations is None
            and not trace and not cfg.uniform_noise
            and not cfg.noise_shaping)


def decode_gdbf(
    code: Code,
    yq: torch.Tensor,
    sigma: float,
    cfg: GDBFConfig,
    key: Optional[NoiseKey] = None,
    perturbations: Optional[torch.Tensor] = None,
    qc: Optional[QCCode] = None,
    stoch_uniforms: Optional[torch.Tensor] = None,
    dense: Optional[DenseGraph] = None,
    trace: bool = False,
) -> GDBFResult:
    """Batched GDBF-family decode.

    yq: [B, N] f32 channel samples, already saturated/quantized per the
    variant.  sigma: the channel's noise std-dev; the perturbation uses
    f32(sigma·noise_scale).  key: the frames' noise coordinates (needed
    when the config draws noise and nothing is injected).
    perturbations / stoch_uniforms: optional ``[max_phases·T, N, B]``
    pre-drawn sequences that replace the keyed draws (the perturbations
    bypass the uniform and shaping transforms, as in the JAX decoder).
    qc: optional QC structure of the SAME code — row-gather graph
    operations (:mod:`.qc_ops`), bit-identical to the generic ones.
    dense: optional :class:`.dense_ops.DenseGraph` of the SAME code — the
    two graph operations as matrix products (bit-identical; the sweep's
    route for codes without QC structure).  Ignored when ``qc`` is given.
    trace: run all ``max_phases·T`` steps with no early exit (frames that
    are done keep their state, as in the JAX decoder's masked scan) and
    return ``(result, d_steps)``: ``d_steps`` [max_phases·T, N, B] int32
    ±1, the decisions after every step, and ``result`` what
    ``trace=False`` returns (``steps`` then counts the whole budget).  It
    holds ``steps·N·B`` integers and reads nothing from the card per
    step: meant for a few frames.
    """
    if qc is not None and (qc.n != code.n or qc.m != code.m):
        raise ValueError("qc structure does not match code dimensions")
    if dense is not None and (dense.n != code.n or dense.m != code.m):
        raise ValueError("dense graph does not match code dimensions")
    if (
        (cfg.add_noise and perturbations is None)
        or (cfg.quantize_probabilities and stoch_uniforms is None)
    ) and key is None:
        raise ValueError("this GDBF config needs a noise key")

    y_t = yq.t().contiguous()  # [N, B]
    device, dtype = y_t.device, y_t.dtype
    n, b = y_t.shape
    T = cfg.num_iterations
    total_steps = cfg.max_phases * T
    ns = _f32(sigma * cfg.noise_scale)
    noise_sigma = torch.tensor(ns, dtype=dtype, device=device)
    if cfg.weight_syndromes and cfg.legacy_weight:
        w_vn = torch.tensor(cfg.alpha * cfg.weight_ymax, dtype=dtype,
                            device=device) / code.vn_deg.to(dtype)
        w = w_vn[:, None]
    else:
        w = w_vn = _f32(cfg.alpha if cfg.weight_syndromes else 1.0)
    theta0 = _f32(cfg.theta)
    lam = _f32(cfg.lam)
    mu0 = 0 if cfg.sequential else 1
    # The graph operations: kernel B6's syndrome on the QC or slot-array
    # table, else the dense products.  The parallel rule's VN side is
    # kernel B7 on the same graph; the sequential, mode-switching and
    # stochastic rules keep the plain torch VN side.
    graph = (qc_graph(qc, device) if qc is not None
             else None if dense is not None else slot_graph(code, device))
    parallel = not (cfg.sequential or cfg.mode_switching
                    or cfg.quantize_probabilities)

    # Channel decisions from the sign bit: quantizers with a zero level
    # emit signed zeros, and a y > 0 test would misread −0.0's sign.  The
    # decisions are int8 ±1 inside the decode; B7 flips d in place, so d
    # never shares r's memory.
    r = torch.where(torch.signbit(y_t), -1, 1).to(torch.int8)
    d = r.clone()
    thetas = torch.full((n, b), theta0, dtype=dtype, device=device)
    dsum = torch.zeros((n, b), dtype=torch.int32, device=device)
    mu = torch.full((b,), mu0, dtype=torch.int32, device=device)
    noise_prev = (torch.zeros((n, b), dtype=dtype, device=device)
                  if cfg.noise_shaping else None)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    act = torch.ones((b,), dtype=torch.bool, device=device)  # ~done
    iters = torch.full((b,), total_steps, dtype=torch.int32, device=device)
    phases = torch.full((b,), cfg.max_phases, dtype=torch.int32,
                        device=device)
    smooth_used = torch.zeros((b,), dtype=torch.int32, device=device)
    sat_at_exit = torch.zeros((b,), dtype=torch.bool, device=device)
    d_steps = (torch.empty((total_steps, n, b), dtype=torch.int32,
                           device=device) if trace else None)
    # smoothing-window steps of a phase: it >= window_start
    window_start = (T - cfg.window_size + 1 if cfg.output_smoothing
                    else T)
    chunked = _takes_chunks(cfg, graph, parallel, perturbations, trace)
    plan = None
    if chunked and device.type == "cuda":
        plan = gdbf_chunk_plan(
            graph.check_cols, graph.vn_checks, d, y_t, thetas, dsum, done,
            act, iters, phases, smooth_used, sat_at_exit, T, window_start,
            total_steps, w_vn, lam if cfg.threshold_adaptation else None,
            (key.seed, key.frame0, ns) if cfg.add_noise else None)

    step = 0
    while step < total_steps:
        if (not trace and step % DONE_CHECK_EVERY == 0
                and all_done(done)):
            break
        phase, it = divmod(step, T)
        in_window = it >= window_start

        # phase start: reset the per-phase state of active frames (step 0's
        # reset would give back the initial state)
        if it == 0 and step > 0:
            take = act[None, :]
            torch.where(take, r, d, out=d)
            thetas.masked_fill_(take, theta0)
            dsum.masked_fill_(take, 0)
            mu.masked_fill_(act, mu0)
            if cfg.output_smoothing:
                # the phase that just ran all T iterations unsatisfied
                smooth_used += act

        if plan is not None:
            # the steps up to the next exit check or phase start: one call
            stop = _chunk_end(step, T, total_steps)
            gdbf_chunk(plan, step, stop - step)
            step = stop
            continue

        # syndrome check at iteration start
        if graph is not None:
            satisfied, syn = parity_check(graph.check_cols, d, syndrome=True)
        else:
            syn = dense_syndrome_bipolar(dense, d)
            satisfied = (syn > 0).all(dim=0)
        gdbf_lanes_plain(satisfied, done, act, iters, phases, smooth_used,
                         sat_at_exit, step, phase, in_window)

        # perturbation
        pert = None
        if cfg.add_noise:
            if perturbations is not None:
                pert = perturbations[step]
            else:
                sample = _keyed_perturbation(cfg, key, n, b, step, ns,
                                             device)
                if cfg.noise_shaping:
                    pert = sample - noise_prev
                    noise_prev = torch.where(act[None, :], sample, noise_prev)
                else:
                    pert = sample

        if parallel and graph is not None:
            # metric, flip, adaptation and smoothing sum: kernel B7
            gdbf_parallel_step(
                d, y_t, syn, graph.vn_checks, thetas, dsum, act, w_vn, pert,
                lam if cfg.threshold_adaptation else None, in_window)
        else:
            rnum = None
            if cfg.quantize_probabilities:
                rnum = (stoch_uniforms[step] if stoch_uniforms is not None
                        else _keyed_uniforms(key, n, b, step, device))
            d, thetas, dsum, mu = _vn_side(
                cfg, graph, dense, d, y_t, syn, thetas, dsum, mu, act, w,
                pert, lam, noise_sigma, rnum, it, in_window)
        if trace:
            d_steps[step] = d
        step += 1
    build.PATHS["gdbf_step", "chunk" if chunked else "loop"] += step
    del plan  # its buffers

    satisfied = sat_at_exit
    d = d.to(torch.int32)
    if cfg.output_smoothing:
        # the last phase of a never-satisfied frame ran all T iterations
        smooth_used = smooth_used + (~satisfied).to(torch.int32)
        d_smoothed = torch.where(dsum > 0, 1, -1).to(torch.int32)
        d = torch.where(~satisfied[None, :], d_smoothed, d)
    result = GDBFResult(hard=d.t(), iterations=iters, satisfied=satisfied,
                        phases=phases, smoothing_used=smooth_used, steps=step)
    return (result, d_steps) if trace else result
