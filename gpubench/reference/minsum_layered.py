"""Row-layered normalized min-sum, written out in plain PyTorch.

The layered (serial-C) schedule of Hocevar ("A reduced complexity decoder
architecture via layered decoding of LDPC codes", IEEE SiPS 2004) with the
normalized check update of Chen, Dholakia, Eleftheriou, Fossorier and Hu
("Reduced-complexity decoding of LDPC codes", IEEE Trans. Commun. 53(8),
2005), on channel samples ``y`` of the all-(+1) word of a QC code,
quantized first (:func:`quantize`):

* the posterior ``q`` of every column starts at its sample, and every
  edge's stored check message ``L`` at zero;
* a round visits the layers in base-row order; layer ``bi`` is checks
  ``bi·z`` to ``bi·z + z − 1``, which meet each of their columns once;
* in a layer every edge's extrinsic is ``qext = q[col] − L``; a check sends
  each edge the product of the signs of its other edges' extrinsics
  (``x ≥ 0`` counts as +) times the least of their magnitudes, divided by
  α; each column of the layer then takes ``q = qext + out``, and each edge
  keeps ``L = out``;
* the decision of a column is +1 where ``q > 0``, else −1, and a frame is
  satisfied when every check's decisions have an even number of −1s;
* with early termination (the port's ``run_flooding``): the decisions of
  the samples themselves are checked first, so a frame satisfied there
  uses 0 rounds; after each round only the frames not yet satisfied take
  the round's decisions and its count; the rounds stop once every frame is
  satisfied, or at T.  A frame's result does not depend on the frames it
  is decoded with, so only the unsatisfied frames are carried on.

Departures from the published description, each the port's:

* ``L`` is stored in ``Precision.storage``, saturated at its largest finite
  value, while the posterior takes the unrounded ``out`` (the published
  decoder keeps one precision throughout);
* the division by α is a true division by a tensor on the samples' device
  (a CUDA division by a Python number is a multiply by its reciprocal,
  which rounds otherwise);
* a table with two circulants in one block (``extra``) is refused: its
  columns meet a layer twice, which the published schedule does not
  define.

Every sum is taken in ``Precision.arith``; the configuration states both
types.  No matrix product is taken, so TF32 cannot enter.
"""

from __future__ import annotations

import torch

from . import Precision
from .codes import Graph
from .minsum import parity_ok, stored


def quantize(y: torch.Tensor, ymax: float, levels: int) -> torch.Tensor:
    """The uniform floor quantizer with no zero level of the reference's
    fixed-point min-sum: ``levels`` levels over ±``ymax``, step ``2·ymax /
    (levels − 1)``; ``s·floor(|y| / step)·step`` with ``s`` the sign (0
    counting as +), a value that floors to 0 taking ``s·step``, one beyond
    ±``ymax`` taking ``s·ymax``.  Every scalar is an f32 tensor on ``y``'s
    device, so the division is a true one."""
    s = torch.where(y >= 0, 1.0, -1.0).to(y.dtype)
    step = torch.tensor(2.0 * ymax / (levels - 1.0), dtype=torch.float32,
                        device=y.device)
    top = torch.tensor(ymax, dtype=torch.float32, device=y.device)
    q = s * torch.floor(y.abs() / step) * step
    q = torch.where(q == 0.0, s * step, q)
    return torch.where(y.abs() > top, s * top, q)


def layers(g: Graph, table: dict) -> list:
    """[z, dc] columns of each layer's checks (``n`` in a spare slot), in
    base-row order; refuses a table with two circulants in a block."""
    if table.get("extra"):
        raise ValueError(
            f"the layered reference takes one circulant a block; table "
            f"{table.get('name', '?')!r} has extra circulants (pairs)")
    z = table["z"]
    return [g.check_cols[bi * z:(bi + 1) * z]
            for bi in range(len(table["base"]))]


class _Rounds:
    """The rounds of one code on one device: :meth:`start` the state of some
    frames, :meth:`run` one pass over the layers on it, in place."""

    def __init__(self, g: Graph, table: dict, alpha: float,
                 prec: Precision, device):
        rows = layers(g, table)
        self.prec, self.device = prec, device
        self.a = torch.tensor(alpha, dtype=prec.arith, device=device)
        self.slot = torch.arange(rows[0].shape[1],
                                 device=device)[None, :, None]
        self.writes = [(cols.to(device), (cols < g.n).to(device))
                       for cols in rows]

    def start(self, y_t: torch.Tensor):
        """(the posterior [n + 1, f], its spare row +inf; the stored
        messages of each layer [z, dc, f], zero) of the samples ``y_t [n,
        f]``."""
        f, p = y_t.shape[1], self.prec
        spare = torch.full((1, f), float("inf"), dtype=p.arith,
                           device=self.device)
        L = [torch.zeros((*cols.shape, f), dtype=p.storage,
                         device=self.device) for cols, _ in self.writes]
        return torch.cat([y_t.to(p.arith), spare]), L

    def run(self, q: torch.Tensor, L: list) -> None:
        p = self.prec
        for i, (cols, valid) in enumerate(self.writes):
            qext = q[cols] - L[i].to(p.arith)  # [z, dc, f]; spare +inf
            neg = qext < 0
            odd = neg.sum(dim=1, keepdim=True) % 2 == 1
            mag = qext.abs()
            low, at = mag.min(dim=1, keepdim=True)
            rest = mag.scatter(1, at, float("inf")).min(dim=1,
                                                        keepdim=True)[0]
            least = torch.where(self.slot == at, rest, low)
            out = torch.where(odd ^ neg, -least, least) / self.a
            q[cols[valid]] = (qext + out)[valid]
            L[i] = stored(out, p.storage)


def posterior(g: Graph, table: dict, y: torch.Tensor, iterations: int,
              alpha: float, prec: Precision) -> torch.Tensor:
    """The posterior [F, n] of every frame of ``y [F, n]`` after
    ``iterations`` rounds."""
    rounds = _Rounds(g, table, alpha, prec, y.device)
    q, L = rounds.start(y.t())
    for _ in range(iterations):
        rounds.run(q, L)
    return q[:g.n].t()


def _decide(q: torch.Tensor) -> torch.Tensor:
    return torch.where(q > 0, 1, -1).to(torch.int8)


def decode(g: Graph, table: dict, y: torch.Tensor, iterations: int,
           alpha: float, prec: Precision, early_termination: bool = False):
    """Layered normalized min-sum on ``y [F, n]``: (hard [F, n] int8 ±1,
    iterations [F] int32, satisfied [F] bool)."""
    frames, dev = y.shape[0], y.device
    if not early_termination:
        d = _decide(posterior(g, table, y, iterations, alpha, prec).t())
        its = torch.full((frames,), iterations, dtype=torch.int32,
                         device=dev)
        return d.t(), its, parity_ok(g, d)

    rounds = _Rounds(g, table, alpha, prec, dev)
    yt = y.t().to(prec.arith)  # [n, F]
    d = _decide(yt)
    done = parity_ok(g, d)
    its = torch.zeros(frames, dtype=torch.int32, device=dev)
    live = torch.nonzero(~done).flatten()
    q, L = rounds.start(yt[:, live])
    t = 0
    while t < iterations and live.numel():
        rounds.run(q, L)
        d_live = _decide(q[:g.n])
        ok = parity_ok(g, d_live)
        d[:, live] = d_live
        its[live] = t + 1
        done[live] = ok
        go = torch.nonzero(~ok).flatten()
        live, q, L = live[go], q[:, go], [x[..., go] for x in L]
        t += 1
    return d.t(), its, done
