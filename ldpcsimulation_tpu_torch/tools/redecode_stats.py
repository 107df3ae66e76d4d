"""Per-frame redecode statistics: frame-specific error probability Pe(f).

Port of ``ldpcsimulation_tpu.tools.redecode_stats``.  Reference
counterpart: ``newstat.cpp`` (binary ``redecodeStatistics``): for NF
frames, snapshot the RNG state, decode the same received frame NR times
with fresh decoder noise, and log one row per frame — ``framenum
outcome[0..NR-1]`` with each outcome the residual error weight of that
attempt (``newstat.cpp:432-436``).

Keys.  Frame ``f``'s channel is kernel B2's row (seed, f), the row
``simulate`` gives frame f.  Attempt ``a`` of frame ``f`` draws its decoder
noise (kernels B4/B3) under ``NoiseKey(seed, f·NR + a)``: no two attempts
share a key, and each attempt's outcome is that of a B=1
``decode_gdbf(y_f, key=NoiseKey(seed, f·NR + a))``.  The JAX package keys
its attempts by threefry folds of (seed, f), so the two packages agree in
distribution, not frame by frame.  Several frames' attempts decode as one
batch (``batch_frames`` frames, columns in (frame, attempt) order); since
every column is keyed by its own id, the outcomes do not depend on that
chunking.
"""

from __future__ import annotations

from typing import Optional, TextIO

import numpy as np
import torch

from ..channel.awgn import awgn_all_zero, snr_to_sigma
from ..codes.code import Code
from ..decoders.base import NoiseKey
from ..decoders.gdbf import GDBFConfig, decode_gdbf

__all__ = ["redecode_statistics", "attempt_key", "DEFAULT_BATCH_COLUMNS"]

#: columns (frames × attempts) per decode when ``batch_frames`` is not given
DEFAULT_BATCH_COLUMNS = 32768


def attempt_key(seed: int, frame: int, attempt: int,
                num_redecodes: int) -> NoiseKey:
    """The decoder-noise key of one attempt (a B=1 decode under it replays
    the attempt)."""
    return NoiseKey(seed, frame * num_redecodes + attempt)


def redecode_statistics(
    code: Code,
    cfg: GDBFConfig,
    snr_db: float,
    rate: Optional[float] = None,
    num_frames: int = 200,
    num_redecodes: int = 100,
    seed: int = 0,
    log: Optional[TextIO] = None,
    device="cuda",
    batch_frames: Optional[int] = None,
) -> np.ndarray:
    """Returns outcomes [num_frames, num_redecodes] int64: the error weight
    of each attempt.  Defaults mirror ``scripts/redecode_statistics_802.3.sh``
    (NR=100, NF=200).  Writes reference-format rows to ``log`` if given.
    ``batch_frames``: frames whose attempts share one decode (default: as
    many as fit in :data:`DEFAULT_BATCH_COLUMNS` columns).  ``device``
    defaults to the card; ``device="cpu"`` runs the plain PyTorch path.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "redecode_statistics: device 'cuda', but no CUDA device is "
            "available (pass device='cpu' to run the plain PyTorch path)"
        )
    rate = code.rate if rate is None else rate
    sigma = snr_to_sigma(snr_db, rate)
    nr = num_redecodes
    if batch_frames is None:
        batch_frames = max(1, DEFAULT_BATCH_COLUMNS // nr)
    code = code.to(device)
    outcomes = np.zeros((num_frames, nr), np.int64)
    for f0 in range(0, num_frames, batch_frames):
        c = min(batch_frames, num_frames - f0)
        y = awgn_all_zero(seed, f0, c, code.n, sigma, device)
        res = decode_gdbf(code, y.repeat_interleave(nr, dim=0), sigma, cfg,
                          key=attempt_key(seed, f0, 0, nr))
        errs = (res.hard != 1).sum(dim=1).reshape(c, nr)
        outcomes[f0:f0 + c] = errs.cpu().numpy()
        if log is not None:
            for f in range(f0, f0 + c):
                log.write(
                    str(f) + "\t" + "\t".join(map(str, outcomes[f])) + "\n"
                )
    return outcomes


def _main(argv=None):
    """CLI: per-frame redecode statistics (redecodeStatistics analog).

    python -m ldpcsimulation_tpu_torch.tools.redecode_stats \
        --code qc_1008_504 --snr 3.5 -T 300 --frames 200 --redecodes 100 \
        --log out.log
    """
    import argparse
    import sys

    from ..codes import build_code, load_alist
    from ..codes.library import NAMED_CODES, load_named_code
    from ..decoders.gdbf import PRESETS, preset

    p = argparse.ArgumentParser(
        prog="redecode_stats", description=_main.__doc__
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES))
    src.add_argument("--alist")
    p.add_argument("--snr", type=float, required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--redecodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("--theta", type=float, default=-0.9)
    p.add_argument("--noise-scale", type=float, default=0.975)
    p.add_argument("--lam", type=float, default=0.988)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--log", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU runs the "
                        "kernels' plain twins)")
    args = p.parse_args(argv)

    code = (
        load_named_code(args.code)
        if args.code
        else build_code(load_alist(args.alist))
    )
    cfg = preset(
        args.preset, num_iterations=args.iterations, theta=args.theta,
        noise_scale=args.noise_scale, lam=args.lam, alpha=args.alpha,
        window_size=args.window,
    )
    with open(args.log, "w") as f:
        out = redecode_statistics(
            code, cfg, snr_db=args.snr, rate=args.rate,
            num_frames=args.frames, num_redecodes=args.redecodes,
            seed=args.seed, log=f, device=args.device,
        )
    pe = (out > 0).mean(axis=1)
    print(
        f"{args.frames} frames x {args.redecodes} redecodes: mean Pe(f) = "
        f"{pe.mean():.4f}, frames with Pe>0: {(pe > 0).sum()}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
