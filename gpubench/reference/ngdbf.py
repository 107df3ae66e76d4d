"""Parallel noisy gradient-descent bit flipping with threshold adaptation
and output smoothing (SM-NGDBF), written out in plain PyTorch.

The decoder of Sundararajan, Winstead and Boutillon ("Noisy gradient
descent bit-flip decoding for LDPC codes", IEEE Trans. Commun. 62(10),
2014) as the reference's ``SMNGDBF`` binary runs it, on channel samples
``y`` saturated at ±Ymax:

* decisions start at the sign of y (a sign bit set gives −1);
* each step t = 0 … T − 1 starts with the syndrome ``s_c`` (+1 where check
  c's decisions have an even number of −1s): a frame whose checks are all
  satisfied is done, and reports t as its iterations; done frames keep
  their state;
* every active bit's metric is ``e = (d·y + α·Σ s_c) + q``, the sum over
  its checks in any order (integers), q the step's Gaussian perturbation of
  deviation ``σ·noise_scale`` (:func:`.philox.decoder_noise`), each
  operation rounded in ``Precision.arith`` in that order;
* a bit flips where ``e < θ``, and its threshold ``θ`` (from θ₀) is
  multiplied by λ where it does not;
* in the last ``window − 1`` steps each active frame adds its new
  decisions into ``dsum``; a frame never satisfied reports ``dsum > 0`` as
  +1, else −1, and T as its iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from . import Precision, philox
from .codes import Graph


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32 value."""
    return float(np.float32(x))


def syndrome(g: Graph, d: torch.Tensor) -> torch.Tensor:
    """[m, F] ±1 syndrome of decisions ``d [n, F]`` (+1 even)."""
    neg = torch.cat([d < 0, torch.zeros_like(d[:1], dtype=torch.bool)])
    odd = neg[g.check_cols].sum(dim=1) % 2 == 1
    return torch.where(odd, -1, 1).to(torch.int8)


def decode(g: Graph, y: torch.Tensor, p: dict, sigma: float, seed: int,
           frames: torch.Tensor, prec: Precision):
    """SM-NGDBF on ``y [F, n]`` (already saturated) of the frames
    ``frames [F]``: (hard [F, n] int8 ±1, iterations [F] int32, satisfied
    [F] bool).  ``p``: iterations, theta, noise_scale, lam, alpha,
    window."""
    ar = prec.arith
    yt = y.t().to(ar)
    frames_n = yt.shape[1]
    T = p["iterations"]
    scale = f32(sigma * p["noise_scale"])
    alpha, lam = f32(p["alpha"]), f32(p["lam"])
    d = torch.where(torch.signbit(yt), -1, 1).to(torch.int8)
    theta = torch.full_like(yt, f32(p["theta"]))
    dsum = torch.zeros(yt.shape, dtype=torch.int32, device=yt.device)
    done = torch.zeros(frames_n, dtype=torch.bool, device=yt.device)
    its = torch.full((frames_n,), T, dtype=torch.int32, device=yt.device)
    for t in range(T):
        syn = syndrome(g, d)
        ok = (syn > 0).all(dim=0)
        its = torch.where(~done & ok, t, its)
        done = done | ok
        act = ~done[None, :]
        q = philox.decoder_noise(seed, frames, g.n, t, scale).to(ar)
        s = torch.cat([syn.to(ar), torch.zeros_like(yt[:1])])[
            g.col_checks].sum(dim=1)
        e = (d.to(ar) * yt + alpha * s) + q
        flip = e < theta
        d = torch.where(act & flip, -d, d)
        theta = torch.where(act & ~flip, theta * lam, theta)
        if t > T - p["window"]:
            dsum = torch.where(act, dsum + d, dsum)
    smoothed = torch.where(dsum > 0, 1, -1).to(torch.int8)
    d = torch.where(done[None, :], d, smoothed)
    return d.t(), its, done
