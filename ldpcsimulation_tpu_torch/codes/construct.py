"""Code constructions: PEG, random regular ensembles, QC expansion.

Numpy ports of ``ldpcsimulation_tpu.codes.construct``; each construction
draws the same numbers from the same seed, so both packages build the same
H.  Only the Python PEG is here: the JAX package's native C++ PEG (used for
n > 2000) is ROADMAP item A1, and ``nb_regular`` waits for the non-binary
item (A12).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .alist import Alist
from .code import Code, build_code

__all__ = ["peg", "random_regular", "qc_expand", "make_regular_code"]


def peg(
    n: int,
    m: int,
    dv: int | Sequence[int],
    seed: int = 0,
    backend: str = "auto",
) -> Alist:
    """Progressive-Edge-Growth construction of an (n, m) binary LDPC code.

    For each variable node (in order) and each of its ``dv`` edges: the first
    edge goes to a minimum-degree check; subsequent edges BFS the current
    subgraph from the variable and connect to a check at maximum distance
    (preferring unreachable checks), breaking ties by minimum current check
    degree, then by seeded random choice.

    Deterministic given (n, m, dv, seed).  Returns an :class:`Alist` whose
    per-node adjacency is ascending within each column.

    backend: "python" | "auto".  The JAX package's "auto" switches to its
    native C++ PEG (an independent RNG stream) for regular codes with
    n > 2000, so those codes — and ``backend="native"`` — raise here until
    the native PEG is ported (ROADMAP item A1).
    """
    native = backend == "native" or (
        backend == "auto" and isinstance(dv, int) and n > 2000
    )
    if native:
        raise NotImplementedError(
            "the native PEG backend is not ported yet (ROADMAP item A1)"
        )
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown PEG backend {backend!r}")
    rng = np.random.default_rng(seed)
    dv_list = [dv] * n if isinstance(dv, int) else list(dv)
    if len(dv_list) != n:
        raise ValueError("dv sequence must have length n")

    check_deg = np.zeros(m, dtype=np.int64)
    nlist: List[List[int]] = [[] for _ in range(n)]
    # adjacency for BFS: check -> list of variables
    check_vars: List[List[int]] = [[] for _ in range(m)]

    for v in range(n):
        for e in range(dv_list[v]):
            if e == 0:
                # lowest-degree check, ties broken randomly
                cands = np.flatnonzero(check_deg == check_deg.min())
            else:
                # BFS from v over the bipartite graph built so far
                dist = np.full(m, -1, dtype=np.int64)
                seen_v = np.zeros(n, dtype=bool)
                seen_v[v] = True
                frontier = list(nlist[v])
                depth = 0
                for c in frontier:
                    dist[c] = 0
                while frontier:
                    nxt: List[int] = []
                    for c in frontier:
                        for v2 in check_vars[c]:
                            if not seen_v[v2]:
                                seen_v[v2] = True
                                for c2 in nlist[v2]:
                                    if dist[c2] < 0:
                                        dist[c2] = depth + 1
                                        nxt.append(c2)
                    frontier = nxt
                    depth += 1
                unreached = np.flatnonzero(dist < 0)
                if unreached.size:
                    cands = unreached
                else:
                    far = dist.max()
                    cands = np.flatnonzero(dist == far)
                    # exclude direct neighbors (dist 0) if any alternative
                    cands = cands[dist[cands] > 0] if far > 0 else cands
                # among candidates, minimum degree
                dmin = check_deg[cands].min()
                cands = cands[check_deg[cands] == dmin]
            c = int(rng.choice(cands))
            nlist[v].append(c)
            check_vars[c].append(v)
            check_deg[c] += 1
        nlist[v].sort()

    mlist: List[List[int]] = [[] for _ in range(m)]
    for v in range(n):
        for c in nlist[v]:
            mlist[c].append(v)
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def random_regular(n: int, m: int, dv: int, seed: int = 0) -> Alist:
    """Random (dv, dc)-regular ensemble via a shuffled edge interleaver.

    Requires n*dv divisible by m.  Double edges are resolved by local swaps.
    """
    if (n * dv) % m:
        raise ValueError(f"n*dv={n*dv} not divisible by m={m}")
    dc = n * dv // m
    rng = np.random.default_rng(seed)
    for _attempt in range(50):
        sockets = rng.permutation(np.repeat(np.arange(m), dc))
        cols = np.repeat(np.arange(n), dv)
        # Resolve duplicate (v, c) pairs by reshuffling the clashing sockets.
        ok = True
        for _ in range(200):
            pairs = cols * m + sockets
            order = np.argsort(pairs, kind="stable")
            dup = np.flatnonzero(np.diff(pairs[order]) == 0)
            if dup.size == 0:
                ok = True
                break
            ok = False
            clash = order[dup]
            partners = rng.integers(0, n * dv, size=clash.size)
            # Swap one pair at a time: a vectorized fancy-index swap is not
            # a permutation when partners repeat or hit clash itself.
            for i, j in zip(clash, partners):
                sockets[i], sockets[j] = sockets[j], sockets[i]
        if ok:
            break
    if not ok:
        raise RuntimeError("failed to remove parallel edges")
    nlist: List[List[int]] = [[] for _ in range(n)]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for v, c in zip(cols, sockets):
        nlist[int(v)].append(int(c))
        mlist[int(c)].append(int(v))
    for v in range(n):
        nlist[v].sort()
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def qc_expand(base: np.ndarray, z: int) -> Alist:
    """Expand a quasi-cyclic prototype matrix into an Alist.

    ``base`` entry -1 denotes an all-zero z×z block and s ≥ 0 the identity
    cyclically right-shifted by s (row r of the block has its one at column
    (r + s) mod z).
    """
    mb, nb = base.shape
    n, m = nb * z, mb * z
    nlist: List[List[int]] = [[] for _ in range(n)]
    mlist: List[List[int]] = [[] for _ in range(m)]
    for bi in range(mb):
        for bj in range(nb):
            s = int(base[bi, bj])
            if s < 0:
                continue
            s %= z
            for r in range(z):
                row = bi * z + r
                col = bj * z + (r + s) % z
                mlist[row].append(col)
                nlist[col].append(row)
    for v in range(n):
        nlist[v].sort()
    for c in range(m):
        mlist[c].sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def make_regular_code(
    n: int, m: int, dv: int, seed: int = 0, method: str = "peg",
    device="cpu",
) -> Code:
    """One-stop (n, m) regular code -> :class:`Code` on ``device``."""
    if method == "peg":
        a = peg(n, m, dv, seed=seed)
    elif method == "random":
        a = random_regular(n, m, dv, seed=seed)
    else:
        raise ValueError(f"unknown method {method!r}")
    return build_code(a, device=device)
