"""Flooding sum-product belief propagation, written out in plain PyTorch.

The decoder of Gallager (1963) and MacKay ("Good error-correcting codes
based on very sparse matrices", IEEE Trans. IT 45(2), 1999), in the log-
likelihood domain as the reference's ``decodeBP.cpp`` runs it, on channel
LLRs ``4y/N0`` clamped to ±``max_llr`` (its MAXLLR, 20) of the all-(+1)
word:

* every edge's message starts at its column's LLR, stored;
* a check sends each edge ``sign · log((1 + P)/(1 − P))``, with ``P`` the
  product of ``tanh(|m|/2)`` over its other edges' messages and ``sign``
  the product of their signs (``x ≥ 0`` counts as +): exact extrinsic
  exclusion, no approximation of the product;
* a column adds its LLR and its checks' messages (``total``), the messages
  in the order of its checks, and sends each edge ``total`` less that
  edge's message, clamped to ±``max_llr`` and stored;
* a column decides +1 where ``total > 0``, else −1;
* early termination (the port's extension of ``decodeBP.cpp``, which runs
  all T): the decisions of the channel LLRs are checked first; a frame's
  decisions and its count of update rounds latch at the first round after
  which every check holds, and the rounds stop once every frame of the
  call has latched, or at T.  A frame's result does not depend on the
  other frames it is decoded with.

How the product is computed.  With ``u = e^−|m|`` an edge's
``tanh(|m|/2) = (1 − u)/(1 + u)``, and the product over a set of edges is
``(s − d)/(s + d)`` for the pair ``(s, d) = (Π(1 + u) + Π(1 − u),
Π(1 + u) − Π(1 − u))/2``, which edges fold into one at a time as ``(s, d)
→ (s + d·u, d + s·u)`` from ``(1, 0)``.  Then ``(1 + P)/(1 − P) = s/d``,
so each output takes one ``log`` and each input one ``exp``; under the
±20 clamp ``u ≥ e^−20`` and every term of the folds stays a normal f32.
For each edge the pair of the others is the pair of the edges before it
(folded left to right) combined with the pair of those after it (folded
right to left) as ``(s, d)·(s', d') = (ss' + dd', sd' + ds')``: each
multiply and add separately rounded, in that order.  A check's spare slots
(past its degree) present ``u = 0``, which leaves a fold unchanged.

Departures from ``decodeBP.cpp``: the (s, d) pair domain in place of its
``tanh``/``atanh`` products (the same function, other roundings); messages
stored in ``Precision.storage`` and sums taken in ``Precision.arith``, as
the configuration states; early termination.
"""

from __future__ import annotations

import torch

from . import Precision
from .codes import Graph
from .minsum import _owner, parity_ok, stored


def check_update(g: Graph, v2c: torch.Tensor, arith: torch.dtype) -> list:
    """The check-to-variable messages of every check slot: ``[m, F]`` in
    ``arith`` for each slot ``j`` of ``g.check_edges`` (spare slots
    included; the caller drops them), from the stored ``v2c [e, F]``.
    Each slot is a tensor of its own, as the folds take them."""
    frames = v2c.shape[1]
    spare = torch.full((1, frames), float("inf"), dtype=arith,
                       device=v2c.device)
    x = torch.cat([v2c.to(arith), spare])
    msgs = [x[g.check_edges[:, j]] for j in range(g.check_edges.shape[1])]
    us = [torch.exp(-m.abs()) for m in msgs]
    k = len(us)
    one, zero = torch.ones_like(us[0]), torch.zeros_like(us[0])
    before = [(one, zero)]  # before[j]: the pair of slots 0 … j − 1
    for u in us[:-1]:
        s, d = before[-1]
        before.append((s + d * u, d + s * u))
    after = [(one, zero)]  # after[i]: the pair of slots k − i … k − 1
    for u in us[:0:-1]:
        s, d = after[-1]
        after.append((s + d * u, d + s * u))
    neg = torch.stack([m < 0 for m in msgs]).to(torch.int32)
    odd_all = neg.sum(dim=0)
    out = []
    for j in range(k):
        (sp, dp), (ss, ds) = before[j], after[k - 1 - j]
        mag = torch.log((sp * ss + dp * ds) / (sp * ds + dp * ss))
        odd = (odd_all - neg[j]) % 2 == 1
        out.append(torch.where(odd, -mag, mag))
    return out


def decode(g: Graph, llr: torch.Tensor, iterations: int, prec: Precision,
           max_llr: float):
    """Sum-product with early termination on the clamped LLRs ``llr [F,
    n]``: (hard [F, n] int8 ±1, iterations [F] int32, satisfied [F]
    bool)."""
    lt = llr.t().to(prec.arith)  # [n, F]
    frames = lt.shape[1]
    owner = _owner(g.col_edges, g.e)
    slots = g.check_edges  # [m, dc]: edge ids, ``g.e`` in a spare slot
    zero = torch.zeros((1, frames), dtype=prec.arith, device=lt.device)

    def decide(total):
        return torch.where(total > 0, 1, -1).to(torch.int8)

    v2c = stored(lt[owner], prec.storage)
    d = decide(lt)
    done = parity_ok(g, d)
    its = torch.zeros(frames, dtype=torch.int32, device=lt.device)
    t = 0
    while t < iterations and not bool(done.all()):
        c2v = torch.empty((g.e + 1, frames), dtype=prec.arith,
                          device=lt.device)
        for j, out in enumerate(check_update(g, v2c, prec.arith)):
            c2v[slots[:, j]] = out  # spare slots all land on row e
        c2v = torch.cat([c2v[:g.e], zero])
        acc = c2v[g.col_edges[:, 0]]
        for s in range(1, g.col_edges.shape[1]):
            acc = acc + c2v[g.col_edges[:, s]]
        total = lt + acc
        v2c = stored(torch.clamp(total[owner] - c2v[:g.e], -max_llr,
                                 max_llr), prec.storage)
        act = ~done
        d = torch.where(act, decide(total), d)
        its = torch.where(act, t + 1, its)
        done = done | parity_ok(g, d)
        t += 1
    return d.t(), its, done
