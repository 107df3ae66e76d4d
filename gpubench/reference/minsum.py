"""Flooding min-sum, written out in plain PyTorch.

The decoder of Fossorier, Mihaljević and Imai ("Reduced complexity
iterative decoding of LDPC codes based on belief propagation", IEEE Trans.
Commun. 47(5), 1999) on channel samples ``y`` of the all-(+1) word:

* every edge's message starts at its column's sample, stored;
* a check sends each edge the product of the signs of its other edges'
  messages (``x ≥ 0`` counts as +) times the least of their magnitudes;
* a column adds its checks' messages in the order of its checks and then
  its sample (``total``), and sends each edge ``total`` less that edge's
  message, clamped to the storage type's range and stored;
* after T iterations the decision of a column is +1 where ``total > 0``,
  else −1, and a frame is satisfied when every check's decisions have an
  even number of −1s;
* with early termination (the port's, ``run_flooding_soft``): the
  decisions of the samples themselves are checked first, so a frame
  satisfied there uses 0 rounds; after each round only the frames not yet
  satisfied take the round's decisions and its count; the rounds stop once
  every frame of the call is satisfied, or at T.  A frame's result does not
  depend on the other frames it is decoded with, so a satisfied frame
  leaves the rounds (the port keeps updating its messages, which no output
  reads).

Messages are stored in ``Precision.storage`` and every sum is taken in
``Precision.arith``; the configuration states both.
"""

from __future__ import annotations

import torch

from . import Precision
from .codes import Graph


def stored(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the storage type, saturated at its largest finite value."""
    top = torch.finfo(dtype).max
    return torch.clamp(x, -top, top).to(dtype)


def parity_ok(g: Graph, d: torch.Tensor) -> torch.Tensor:
    """[F] bool: every check of ``d [n, F]`` (±1) has an even number of
    −1s."""
    neg = torch.cat([d < 0, torch.zeros_like(d[:1], dtype=torch.bool)])
    odd = neg[g.check_cols].sum(dim=1) % 2
    return (odd == 0).all(dim=0)


def decode(g: Graph, y: torch.Tensor, iterations: int, prec: Precision,
           early_termination: bool = False):
    """Min-sum on ``y [F, n]``: (hard [F, n] int8 ±1, iterations [F] int32,
    satisfied [F] bool)."""
    yt = y.t().to(prec.arith)  # [n, F]
    frames = yt.shape[1]
    owner = _owner(g.col_edges, g.e)
    v2c = stored(yt[owner], prec.storage)

    def decide(total):
        return torch.where(total > 0, 1, -1).to(torch.int8)

    def round_(v2c, yt):
        """One round on the frames of ``yt [n, f]``: (v2c', total)."""
        f = yt.shape[1]
        pad = torch.full((1, f), float("inf"), dtype=prec.arith,
                         device=yt.device)
        x = torch.cat([v2c.to(prec.arith), pad])[g.check_edges]  # [m, dc, f]
        neg = x < 0
        odd = neg.sum(dim=1, keepdim=True) % 2 == 1
        mag = x.abs()
        low, at = mag.min(dim=1, keepdim=True)
        rest = mag.scatter(1, at, float("inf")).min(dim=1, keepdim=True)[0]
        slot = torch.arange(x.shape[1], device=x.device)[None, :, None]
        least = torch.where(slot == at, rest, low)
        out = torch.where(odd ^ neg, -least, least).to(prec.storage)
        c2v = torch.empty((g.e + 1, f), dtype=prec.storage, device=yt.device)
        c2v[g.check_edges] = out
        c2v = torch.cat([c2v[:g.e].to(prec.arith), torch.zeros_like(pad)])
        acc = c2v[g.col_edges[:, 0]]
        for s in range(1, g.col_edges.shape[1]):
            acc = acc + c2v[g.col_edges[:, s]]
        total = yt + acc
        return stored(total[owner] - c2v[:g.e], prec.storage), total

    if not early_termination:
        total = yt
        for _ in range(iterations):
            v2c, total = round_(v2c, yt)
        d = decide(total)
        its = torch.full((frames,), iterations, dtype=torch.int32,
                         device=yt.device)
        return d.t(), its, parity_ok(g, d)

    # only the frames not yet satisfied go on: ``live`` names them, and
    # their messages and samples are carried alone (each frame's rounds are
    # its own, so dropping the others changes nothing of its result)
    d = decide(yt)
    done = parity_ok(g, d)
    its = torch.zeros(frames, dtype=torch.int32, device=yt.device)
    live = torch.nonzero(~done).flatten()
    v2c, y_live = v2c[:, live], yt[:, live]
    t = 0
    while t < iterations and live.numel():
        v2c, total = round_(v2c, y_live)
        d_live = decide(total)
        ok = parity_ok(g, d_live)
        d[:, live] = d_live
        its[live] = t + 1
        done[live] = ok
        go = torch.nonzero(~ok).flatten()
        live, v2c, y_live = live[go], v2c[:, go], y_live[:, go]
        t += 1
    return d.t(), its, done


def _owner(col_edges: torch.Tensor, e: int) -> torch.Tensor:
    """[e] the column of each edge."""
    owner = torch.empty(e + 1, dtype=torch.int64, device=col_edges.device)
    owner[col_edges] = torch.arange(
        col_edges.shape[0], device=col_edges.device)[:, None].expand_as(
            col_edges)
    return owner[:e]
