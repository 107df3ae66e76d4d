"""Deterministic frame replay with per-iteration traces.

Port of ``ldpcsimulation_tpu.tools.replay``.  Reference counterpart: the
record/replay pair ``newstat.cpp`` (``recordRanState``, GSL RNG state
snapshots per frame) and ``replayGDBF.cpp`` (``loadRanState``, trace files
of decisions and check messages per iteration).

Replay needs no state files.  :func:`..harness.montecarlo.simulate` keys
everything by the global frame index ``g``: the channel noise of frame
``g`` is kernel B2's row (seed, g), and its decoder noise (perturbations,
stochastic-flip uniforms) is kernels B4/B3's draws keyed (seed, g, step)
(:class:`..decoders.base.NoiseKey`).  So a B=1 ``decode_gdbf`` with
``key=NoiseKey(seed, g)`` sees exactly the noise the frame saw inside its
batch, and :func:`replay_decoder_randomness` (kept for the JAX package's
call pattern, whose decoder keys noise per batch) is never needed to
reproduce a decode.  :func:`trace_gdbf` re-runs one frame with
``decode_gdbf(trace=True)``, capturing its decisions and bipolar syndromes
after every round: the data ``errtopng`` renders (:mod:`.errimage`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, bpsk
from ..codes.code import Code
from ..decoders.base import NoiseKey, syndrome_from_hard
from ..decoders.gdbf import GDBFConfig, decode_gdbf, keyed_draws

__all__ = [
    "GDBFTrace",
    "replay_channel",
    "replay_decoder_randomness",
    "trace_gdbf",
    "write_trace",
]


def replay_decoder_randomness(
    n: int,
    cfg: GDBFConfig,
    kdec: NoiseKey,
    batch_size: int,
    frame_index: int,
    sigma: float,
    dtype=torch.float32,
    device="cuda",
):
    """One frame's decoder-internal random stream, for injection.

    ``kdec`` is the key of the batch the frame was decoded in (the
    ``NoiseKey(seed, batch_index·batch_size)`` that ``simulate`` passes to
    the decoder) and ``frame_index`` its column; the frame's global index
    is ``kdec.frame0 + frame_index``.  (The key :func:`replay_channel`
    returns is the frame's own: use it with ``batch_size=1, frame_index=0``,
    or pass it to the decoder directly, which needs no injection.)

    Returns ``(perturbations, stoch_uniforms)`` shaped ``[steps, N, 1]``
    (None where the config draws none): the column
    :func:`..decoders.gdbf.keyed_draws` gives that frame, with noise
    shaping (``pert_t = sample_t − sample_{t−1}``) applied, because the
    injection path bypasses it.  Only the frame's own column is drawn.
    """
    if not 0 <= frame_index < batch_size:
        raise ValueError(f"frame {frame_index} outside a batch of "
                         f"{batch_size}")
    steps = cfg.max_phases * cfg.num_iterations
    key = NoiseKey(kdec.seed, kdec.frame0 + frame_index)
    pert, stoch = keyed_draws(cfg, sigma, key, n, 1, steps, device)
    if pert is not None and cfg.noise_shaping:
        pert = pert - torch.cat([torch.zeros_like(pert[:1]), pert[:-1]])
    return tuple(None if x is None else x.to(dtype) for x in (pert, stoch))


def replay_channel(
    code: Code,
    seed: int,
    batch_index: int,
    frame_index: int,
    batch_size: int,
    sigma: float,
    bits: Optional[np.ndarray] = None,
    awgn_form: str = "multiplicative",
    device="cuda",
):
    """Reproduce one frame's channel output exactly as ``simulate`` drew it.

    ``simulate`` advances its first frame by each batch's size and only
    its last batch may be short, so frame ``frame_index`` of batch
    ``batch_index`` is the global frame ``g = batch_index·batch_size +
    frame_index``.  Returns ``(y [N] f32 on device, NoiseKey(seed, g))``:
    kernel B2's row (seed, g), ``y = 1 + σ·n`` for the all-zero word, and
    the key of a B=1 decode that draws the frame's decoder noise.
    ``bits``: the frame's codeword [N], or its batch's words
    [batch_size, N] (row ``frame_index`` is taken, as the JAX function
    takes it), applied in ``awgn_form`` as ``simulate`` applies it.
    """
    if not 0 <= frame_index < batch_size:
        raise ValueError(f"frame {frame_index} outside a batch of "
                         f"{batch_size}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "replay_channel: device 'cuda', but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch path)"
        )
    g = batch_index * batch_size + frame_index
    y = awgn_all_zero(seed, g, 1, code.n, sigma, device)[0]
    if bits is not None:
        bits = np.asarray(bits)
        if bits.ndim == 2:
            bits = bits[frame_index]
        c = bpsk(torch.as_tensor(bits, device=device))
        if awgn_form == "multiplicative":
            y = c * y
        elif awgn_form == "additive":
            y = y + (c - 1.0)
        else:
            raise ValueError(f"unknown AWGN form {awgn_form!r}")
    return y, NoiseKey(seed, g)


@dataclasses.dataclass
class GDBFTrace:
    """Per-iteration evolution of one frame's decode."""

    decisions: np.ndarray  # [rounds+1, N] ±1 (row 0 = channel decisions)
    syndromes: np.ndarray  # [rounds+1, M] ±1
    iterations: int
    satisfied: bool


def trace_gdbf(
    code: Code,
    yq,
    sigma: float,
    cfg: GDBFConfig,
    key: Optional[NoiseKey] = None,
    perturbations: Optional[torch.Tensor] = None,
    stoch_uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> GDBFTrace:
    """Decode one frame, capturing its state after every round.

    One instrumented decode (``decode_gdbf(trace=True)``), so a trace
    costs one decode.  ``yq``: the frame's [N] decoder input (a tensor,
    whose device the decode runs on, or an array for ``device``, the card
    by default).  Rows: the channel decisions, then one per executed
    round (up to the break for a satisfied frame, the whole budget
    otherwise); the last row of an unsatisfied frame with output smoothing
    is the smoothed output (decodeGDBF.cpp:358-367), the rows before it
    the raw decisions.
    """
    if device is None:
        device = yq.device if isinstance(yq, torch.Tensor) else "cuda"
    y1 = torch.as_tensor(yq, dtype=torch.float32, device=device)[None, :]
    code = code.to(y1.device)
    res, d_steps = decode_gdbf(
        code, y1, sigma, cfg, key=key, trace=True,
        perturbations=perturbations, stoch_uniforms=stoch_uniforms,
    )
    satisfied = bool(res.satisfied[0])
    iterations = int(res.iterations[0])
    # executed update rounds: the break index of a satisfied frame, the
    # full budget otherwise
    rounds = iterations if satisfied else cfg.max_phases * cfg.num_iterations
    rows = torch.cat([
        torch.where(y1 > 0, 1, -1).to(torch.int32),
        d_steps[: max(rounds, 1), :, 0],
    ])
    if cfg.output_smoothing and not satisfied:
        rows[-1] = res.hard[0]
    syn = syndrome_from_hard(code, rows.t().contiguous()).t()
    return GDBFTrace(
        decisions=rows.cpu().numpy(),
        syndromes=syn.cpu().numpy(),
        iterations=iterations,
        satisfied=satisfied,
    )


def write_trace(trace: GDBFTrace, path: str) -> None:
    """Text trace: one line of decisions then one of syndromes per
    iteration (the replayGDBF.cpp:316-373 format family)."""
    with open(path, "w") as f:
        for it in range(trace.decisions.shape[0]):
            f.write("d " + " ".join(map(str, trace.decisions[it])) + "\n")
            f.write("s " + " ".join(map(str, trace.syndromes[it])) + "\n")


def _main(argv=None):
    """CLI: replay one frame and write its decision/syndrome trace.

    python -m ldpcsimulation_tpu_torch.tools.replay --code qc_1008_504 \
        --snr 3.25 --seed 0 --batch-index 2 --frame 17 --batch 1024 \
        --preset SMNGDBF -T 100 --theta -0.9 --out frame.trace
    """
    import argparse

    from ..channel.awgn import snr_to_sigma
    from ..channel.quantize import saturate
    from ..codes import build_code, load_alist
    from ..codes.library import NAMED_CODES, load_named_code
    from ..decoders.gdbf import PRESETS, preset

    p = argparse.ArgumentParser(prog="replay", description=_main.__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES))
    src.add_argument("--alist")
    p.add_argument("--snr", type=float, required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch-index", type=int, required=True)
    p.add_argument("--frame", type=int, required=True)
    p.add_argument("--batch", type=int, required=True,
                   help="batch size of the original simulate() run")
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--theta", type=float, default=-0.9)
    p.add_argument("--noise-scale", type=float, default=0.975)
    p.add_argument("--lam", type=float, default=0.988)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--ymax", type=float, default=2.5)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU runs the "
                        "kernels' plain twins)")
    args = p.parse_args(argv)

    code = (
        load_named_code(args.code)
        if args.code
        else build_code(load_alist(args.alist))
    )
    rate = args.rate if args.rate is not None else code.rate
    sigma = snr_to_sigma(args.snr, rate)
    y, key = replay_channel(
        code, args.seed, args.batch_index, args.frame, args.batch, sigma,
        device=args.device,
    )
    cfg = preset(
        args.preset, num_iterations=args.iterations, theta=args.theta,
        noise_scale=args.noise_scale, lam=args.lam, alpha=args.alpha,
        window_size=args.window,
    )
    # the frame's own key draws the decoder noise it saw in its batch
    tr = trace_gdbf(code, saturate(y, args.ymax), sigma, cfg, key=key)
    write_trace(tr, args.out)
    print(
        f"frame ({args.seed},{args.batch_index},{args.frame}): "
        f"iterations={tr.iterations} satisfied={tr.satisfied} "
        f"trace -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
