"""Real standard code tables: IEEE 802.11n and DVB-S2 (exact structures).

Port of ``ldpcsimulation_tpu.codes.standards``: the tables are copied as
data (equal to the JAX package's element for element, tested) and the
constructions are the same numpy code, so both packages build the same H.

* :data:`WIFI_648_RATE12_Z27` — the IEEE 802.11n rate-1/2, n=648 (z=27)
  prototype shift table.
* :data:`WIFI_1944_RATE12_Z81` — the IEEE 802.11n rate-1/2, n=1944 (z=81)
  prototype shift table (IEEE Std 802.11-2012 Annex F).
* :data:`DVBS2_RATE12_ADDRESSES` — the ETSI EN 302 307 DVB-S2 rate-1/2
  (64800, 32400) accumulator address table: info column ``(g, j)``
  connects to rows ``(x + j*q) mod M`` for each address x of group g,
  q = M/360 = 90, with the staircase parity H[p,p] = H[p+1,p] = 1.

The JAX module's docstring tells how each table was recovered and
verified against the reference's matrices.
"""

from __future__ import annotations

import functools

import numpy as np

from .alist import Alist
from .code import Code, build_code
from .qc import QCCode, build_qc_code, build_qc_code_edges

__all__ = [
    "WIFI_648_RATE12_Z27",
    "WIFI_1944_RATE12_Z81",
    "wifi_648_rate12_qc",
    "wifi_648_rate12",
    "wifi_1944_rate12_qc",
    "wifi_1944_rate12",
    "wifi_encode",
    "DVBS2_RATE12_ADDRESSES",
    "DVBS2_RATE12_Q",
    "dvbs2_rate12_alist",
    "dvbs2_rate12",
    "dvbs2_rate12_qc",
    "dvbs2_rate12_encode",
]

# IEEE 802.11n rate-1/2, z=27 (n=648, k=324) prototype matrix.  −1 = zero
# block, s ≥ 0 = identity cyclically shifted by s.  12×24; columns 0-11 are
# information, 12 the weight-3 encoding column, 13-23 the dual-diagonal
# accumulator.  Extracted from the reference's 802.11n.alist (see the JAX
# module's docstring for provenance/verification).
WIFI_648_RATE12_Z27 = (
    (0, -1, -1, -1, 0, 0, -1, -1, 0, -1, -1, 0, 26, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (5, 0, -1, -1, 10, -1, 0, 0, 15, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (21, -1, 0, -1, 17, -1, -1, -1, 3, -1, 0, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1),
    (25, -1, -1, 0, 7, -1, -1, -1, 2, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1),
    (4, -1, -1, -1, 24, -1, -1, -1, 0, -1, 18, 16, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1),
    (3, -1, 4, 26, 10, -1, 24, -1, 17, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1),
    (2, -1, -1, -1, 19, -1, -1, -1, 20, 9, -1, -1, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1),
    (14, 3, -1, -1, 0, -1, 19, -1, 21, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1),
    (20, 7, -1, 11, 5, 17, -1, -1, 4, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1),
    (16, -1, -1, -1, 8, -1, -1, -1, 14, -1, 24, 10, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1),
    (2, -1, 19, -1, 4, 9, -1, 13, 18, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0),
    (24, -1, -1, -1, 11, -1, -1, 25, 2, 22, -1, -1, 26, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0),
)


@functools.lru_cache(maxsize=None)
def wifi_648_rate12_qc() -> QCCode:
    """The real 802.11n (648, 324) rate-1/2 code as a QC structure."""
    return build_qc_code(np.array(WIFI_648_RATE12_Z27, np.int64), 27)


def wifi_648_rate12(device="cpu") -> Code:
    """The real 802.11n (648, 324) code as a generic slot-array Code."""
    return wifi_648_rate12_qc().to_code(device)


# IEEE 802.11n rate-1/2, z=81 (n=1944, k=972) prototype matrix (IEEE Std
# 802.11-2012 Annex F).  Same conventions as WIFI_648_RATE12_Z27; the JAX
# module's docstring tells the verification story (no reference file exists
# for this size — the standard's structural invariants pin the table).
WIFI_1944_RATE12_Z81 = (
    (57, -1, -1, -1, 50, -1, 11, -1, 50, -1, 79, -1, 1, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (3, -1, 28, -1, 0, -1, -1, -1, 55, 7, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1, -1),
    (30, -1, -1, -1, 24, 37, -1, -1, 56, 14, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1, -1),
    (62, 53, -1, -1, 53, -1, -1, 3, 35, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1, -1),
    (40, -1, -1, 20, 66, -1, -1, 22, 28, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1, -1),
    (0, -1, -1, -1, 8, -1, 42, -1, 50, -1, -1, 8, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1, -1),
    (69, 79, 79, -1, -1, -1, 56, -1, 52, -1, -1, -1, 0, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1, -1),
    (65, -1, -1, -1, 38, 57, -1, -1, 72, -1, 27, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1, -1),
    (64, -1, -1, -1, 14, 52, -1, -1, 30, -1, -1, 32, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1, -1),
    (-1, 45, -1, 70, 0, -1, -1, -1, 77, 9, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0, -1),
    (2, 56, -1, 57, 35, -1, -1, -1, -1, -1, 12, 40, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0, 0),
    (24, -1, 61, -1, 60, -1, -1, 27, 51, -1, -1, 16, 1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 0),
)


@functools.lru_cache(maxsize=None)
def wifi_1944_rate12_qc() -> QCCode:
    """The real 802.11n (1944, 972) rate-1/2 code as a QC structure."""
    return build_qc_code(np.array(WIFI_1944_RATE12_Z81, np.int64), 81)


def wifi_1944_rate12(device="cpu") -> Code:
    """The real 802.11n (1944, 972) code as a generic slot-array Code."""
    return wifi_1944_rate12_qc().to_code(device)


def wifi_encode(base, z: int, info_bits: np.ndarray) -> np.ndarray:
    """Systematic 802.11n encoder via the dual-diagonal structure.

    ``base``: prototype shift table (rows × 24, −1 = absent); info_bits:
    [..., kb*z].  Returns [..., nb*z] codewords with H·c = 0: summing all
    base rows cancels the accumulator chain and leaves p_0 (the weight-3
    column's shifts are x, 0, x), then the rows are back-substituted down
    the staircase.
    """
    base = np.asarray(base)
    mb, nb = base.shape
    kb = nb - mb
    info = np.asarray(info_bits, np.uint8) % 2
    lead = info.shape[:-1]
    if info.shape[-1] != kb * z:
        raise ValueError(f"info length {info.shape[-1]} != {kb * z}")
    s = info.reshape(lead + (kb, z))

    def shift(block, sh):
        return np.roll(block, -sh, axis=-1)

    # lambda_i = sum_j A_ij s_j  (info part of each base row)
    lam = np.zeros(lead + (mb, z), np.uint8)
    for i in range(mb):
        for j in range(kb):
            if base[i, j] >= 0:
                lam[..., i, :] ^= shift(s[..., j, :], base[i, j])
    # weight-3 column kb: rows (top, mid, bot) with shifts (x, 0, x)
    wcol = [i for i in range(mb) if base[i, kb] >= 0]
    if len(wcol) != 3:
        raise ValueError("column kb is not the weight-3 encoding column")
    top, mid, bot = wcol
    x = base[top, kb]
    if base[bot, kb] != x or base[mid, kb] != 0:
        raise ValueError("the weight-3 column's shifts are not (x, 0, x)")
    # XOR of all rows: every dual-diagonal parity appears twice and
    # cancels; p0's three terms reduce to σ_x ⊕ σ_0 ⊕ σ_x = σ_0 → p0.
    p0 = lam.sum(axis=-2).astype(np.uint8) % 2
    # forward substitution down the staircase: p_{i+1} is a running XOR
    p = np.zeros(lead + (mb, z), np.uint8)
    p[..., 0, :] = p0
    run = np.zeros(lead + (z,), np.uint8)
    for i in range(mb - 1):
        term = lam[..., i, :].copy()
        if base[i, kb] >= 0:
            term = term ^ shift(p0, base[i, kb])
        run = run ^ term
        p[..., i + 1, :] = run
    return np.concatenate([s, p], axis=-2).reshape(lead + (nb * z,))


# DVB-S2 rate-1/2 accumulator addresses (ETSI EN 302 307 Annex B/C form):
# row g lists the parity addresses of information column g*360; column
# (g, j) connects to rows (x + j*DVBS2_RATE12_Q) mod 32400.  36 weight-8
# groups then 54 weight-3 groups.  Extracted from (and verified against)
# the reference's dvbs2_1_2.alist.
DVBS2_RATE12_Q = 90
DVBS2_RATE12_ADDRESSES = (
    (54, 2534, 8597, 9318, 10219, 14392, 26909, 27561),
    (55, 2530, 3033, 3651, 4635, 7263, 23830, 28130),
    (56, 792, 5750, 9169, 17299, 23583, 24731, 26036),
    (57, 5811, 11551, 13685, 15447, 16264, 18653, 26154),
    (58, 2792, 3174, 11347, 12610, 12997, 28768, 29371),
    (59, 3186, 6165, 15850, 16018, 16789, 21202, 21449),
    (60, 6213, 8334, 12166, 17618, 18212, 21449, 31016),
    (61, 718, 5896, 9308, 11327, 11727, 14213, 22836),
    (62, 2091, 5444, 9013, 15587, 23634, 24941, 29966),
    (63, 3983, 16904, 21415, 22207, 25912, 27524, 28534),
    (64, 4501, 5491, 14665, 14798, 16158, 22193, 25687),
    (65, 4264, 4520, 16941, 17094, 21526, 22370, 23397),
    (66, 2762, 6182, 9597, 10490, 25954, 30841, 32370),
    (67, 13668, 14955, 15147, 19235, 22120, 22865, 29870),
    (68, 5443, 6689, 9918, 18346, 18408, 20645, 25746),
    (69, 4746, 10023, 12529, 13858, 24828, 29982, 30370),
    (70, 1262, 7863, 13063, 21951, 24033, 28032, 29888),
    (71, 6594, 9335, 9509, 14831, 29642, 31451, 31552),
    (72, 624, 1358, 5265, 6454, 16633, 20354, 24598),
    (73, 295, 3080, 8032, 13364, 15323, 18011, 19529),
    (74, 1510, 7960, 9129, 11370, 11981, 21462, 25741),
    (75, 4543, 9276, 20646, 21921, 28050, 29656, 30699),
    (76, 5520, 13715, 15975, 19605, 21949, 25634, 31119),
    (77, 4608, 10706, 13103, 18688, 29224, 30165, 31755),
    (78, 12245, 21514, 23117, 25631, 26035, 30699, 31656),
    (79, 9674, 17042, 24588, 24966, 29908, 31285, 31857),
    (80, 7122, 11409, 14897, 21856, 27000, 27777, 29919),
    (81, 263, 4877, 20545, 22092, 23310, 28622, 29773),
    (82, 3967, 5651, 14419, 15605, 15896, 21864, 22757),
    (83, 1759, 5098, 10139, 10556, 26086, 29223, 30145),
    (84, 505, 2936, 6030, 16575, 18815, 24457, 26738),
    (85, 6247, 20131, 22298, 24791, 26390, 27562, 30326),
    (86, 928, 12400, 15311, 18608, 21246, 29246, 32309),
    (87, 2296, 3244, 6025, 16302, 19613, 20314, 26689),
    (88, 6237, 11943, 15112, 15642, 20947, 22851, 23857),
    (89, 7093, 8882, 12719, 18384, 19038, 25168, 26403),
    (0, 14567, 24965),
    (1, 100, 3908),
    (2, 240, 10279),
    (3, 764, 24102),
    (4, 4173, 12383),
    (5, 13861, 15918),
    (6, 1046, 21327),
    (7, 5288, 14579),
    (8, 8069, 28158),
    (9, 11098, 16583),
    (10, 16681, 28363),
    (11, 13980, 24725),
    (12, 17989, 32169),
    (13, 2767, 10907),
    (14, 3818, 21557),
    (15, 12422, 26676),
    (16, 7676, 8754),
    (17, 14905, 20232),
    (18, 15719, 24646),
    (19, 8589, 31942),
    (20, 19978, 27197),
    (21, 15071, 27060),
    (22, 6071, 26649),
    (23, 10393, 11176),
    (24, 9597, 13370),
    (25, 7081, 17677),
    (26, 1433, 19513),
    (27, 9014, 26925),
    (28, 8900, 19202),
    (29, 18152, 30647),
    (30, 1737, 20803),
    (31, 11804, 25221),
    (32, 17783, 31683),
    (33, 9345, 29694),
    (34, 12280, 26611),
    (35, 6526, 26122),
    (36, 11241, 26165),
    (37, 7666, 26962),
    (38, 8480, 16290),
    (39, 10120, 11774),
    (40, 30051, 30426),
    (41, 1335, 15424),
    (42, 6865, 17742),
    (43, 12489, 31779),
    (44, 21001, 32120),
    (45, 6996, 14508),
    (46, 979, 25024),
    (47, 4554, 21896),
    (48, 7989, 21777),
    (49, 4972, 20661),
    (50, 2730, 6612),
    (51, 4418, 12742),
    (52, 595, 29194),
    (53, 19267, 20113),
)


@functools.lru_cache(maxsize=None)
def dvbs2_rate12_alist() -> Alist:
    """The real DVB-S2 rate-1/2 (64800, 32400) H as an Alist, regenerated
    from :data:`DVBS2_RATE12_ADDRESSES`."""
    m = 32400
    k = 32400
    n = k + m
    q = DVBS2_RATE12_Q
    nlist = [[] for _ in range(n)]
    mlist = [[] for _ in range(m)]
    for g, addrs in enumerate(DVBS2_RATE12_ADDRESSES):
        base = np.asarray(addrs, np.int64)
        for j in range(360):
            c = g * 360 + j
            rows = (base + j * q) % m
            for r in rows:
                nlist[c].append(int(r))
                mlist[int(r)].append(c)
    for p in range(m):  # staircase accumulator
        c = k + p
        nlist[c].append(p)
        mlist[p].append(c)
        if p + 1 < m:
            nlist[c].append(p + 1)
            mlist[p + 1].append(c)
    for lst in nlist:
        lst.sort()
    for lst in mlist:
        lst.sort()
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def dvbs2_rate12(device="cpu") -> Code:
    """The real DVB-S2 rate-1/2 code as a generic slot-array Code."""
    return build_code(dvbs2_rate12_alist(), device=device)


@functools.lru_cache(maxsize=None)
def dvbs2_rate12_qc():
    """The real DVB-S2 rate-1/2 code as a generalized QC structure.

    Under the q-interleave relabeling (q = 90) of rows and parity columns
    — ``i -> (i mod q, i div q)`` as (block, offset) — the standard's H is
    block-circulant at z = 360 (info column group g, address x: block row
    ``x mod q``, shift ``-(x div q) mod z``; staircase parity: shift-0
    identity pairs plus one shift-359 corner block missing a single edge,
    the weight-1 final column).  Eight info blocks carry two shifts
    (addresses colliding mod q) and the corner defect is recorded in
    ``minus_edges``.

    Returns a :class:`..codes.qc_detect.DetectedQC`:
    ``expand(qc) == H[row_perm][:, col_perm]`` edge for edge.
    """
    from .qc_detect import DetectedQC

    z = 360
    q = DVBS2_RATE12_Q  # 90
    m = z * q
    k = 32400
    gi = k // z  # 90 info groups
    edges = []
    for g, addrs in enumerate(DVBS2_RATE12_ADDRESSES):
        for x in addrs:
            edges.append((x % q, g, (-(x // q)) % z))
    # staircase parity: col group gi+w holds parity cols t ≡ w (mod q)
    for w in range(q):
        edges.append((w, gi + w, 0))
        if w + 1 < q:
            edges.append((w + 1, gi + w, 0))
        else:
            edges.append((0, gi + w, z - 1))
    minus = ((0, gi + q - 1, z - 1, 0),)
    qc = build_qc_code_edges(edges, z, mb=q, nb=gi + q, minus_edges=minus)
    i = np.arange(m)
    # stored index i sits at permuted position (i mod q)*z + i div q;
    # perm arrays give the ORIGINAL index at each permuted position
    interleave = np.argsort((i % q) * z + i // q)
    col_perm = np.concatenate([np.arange(k), k + interleave])
    return DetectedQC(qc=qc, row_perm=interleave, col_perm=col_perm)


@functools.lru_cache(maxsize=None)
def _dvbs2_rate12_info_edges():
    """(cols, rows) int32 arrays of the info-part edges of the rate-1/2 H."""
    m = 32400
    q = DVBS2_RATE12_Q
    cols = []
    rows = []
    for g, addrs in enumerate(DVBS2_RATE12_ADDRESSES):
        base = np.asarray(addrs, np.int64)
        for j in range(360):
            r = (base + j * q) % m
            cols.append(np.full(r.size, g * 360 + j, np.int64))
            rows.append(r)
    return (
        np.concatenate(cols).astype(np.int32),
        np.concatenate(rows).astype(np.int32),
    )


def dvbs2_rate12_encode(info: np.ndarray) -> np.ndarray:
    """Systematic DVB-S2 rate-1/2 encoder (ETSI EN 302 307 §5.3.2), O(E):
    accumulate each information bit into its address rows, then a running
    XOR over the staircase gives the parity bits (``p_r = acc_r ^
    p_{r-1}``).

    info: [B, 32400] or [32400] 0/1 array -> codeword(s) [B, 64800]
    (systematic: information first, parity appended), uint8.
    """
    info = np.atleast_2d(np.asarray(info)).astype(np.uint8) & 1
    b, k = info.shape
    if k != 32400:
        raise ValueError(f"info length {k} != 32400")
    cols, rows = _dvbs2_rate12_info_edges()
    acc = np.zeros((32400, b), np.uint8)
    np.bitwise_xor.at(acc, rows, info.T[cols])
    parity = np.bitwise_xor.accumulate(acc, axis=0)
    return np.concatenate([info, parity.T], axis=1)
