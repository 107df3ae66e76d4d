"""The port's stratified family against the JAX package: the structure
(``codes/stratified.py``) field by field, with the port's index tables held
to the ones JAX's one-hot implies; ``detect_stratified``'s accept/reject
decisions; the slot moves and the syndrome check; min-sum on kernel B1's
twin bit for bit (every variant, f16 and f32 storage, early termination,
alphas and deltas f16 cannot hold, tied magnitudes) and equal to the port's
slot-array decoder; DD-BMP bit for bit; BP by tolerance and frame
agreement.

Codes: the JAX test suite's synthetic irregular stratified alists (the
port's own copy of the generator, held to JAX's), a permutation-array
(RS-LDPC-like) code over GF(16) on which the RS exact column partition
succeeds, and the 802.3an geometry (2048 columns, 6 strata of 64 rows,
every column in every stratum).  Inputs come from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import stratified as jst
from ldpcsimulation_tpu.codes.alist import Alist as JAlist
from ldpcsimulation_tpu.codes.construct import peg as jpeg
from ldpcsimulation_tpu.decoders import bp_stratified as jbps
from ldpcsimulation_tpu.decoders import ddbmp as jdd
from ldpcsimulation_tpu.decoders import minsum_stratified as jms
from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    quantize_no_zero,
    snr_to_n0,
)
from ldpcsimulation_tpu_torch.codes import (
    Alist,
    build_code,
    detect_qc,
    detect_stratified,
    nb_regular,
    peg,
    stratify,
)
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp,
    decode_bp_stratified,
    decode_ddbmp,
    decode_ddbmp_stratified,
    decode_minsum,
    decode_minsum_stratified,
    stratified_bp_step,
    stratified_check_satisfied,
)
from ldpcsimulation_tpu_torch.decoders import minsum_stratified as pms
from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
    stratified_grid,
    stratified_init,
    stratified_to_cn,
    stratified_to_vn,
)
from tests.test_stratified import synthetic_irregular_stratified as jsynth
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

#: BP check-update tolerance and frame agreement (the port's BP tests')
BP_RTOL, BP_ATOL = 2e-5, 2e-5
BP_FRAME_AGREEMENT = 0.97


def synthetic_stratified(n=512, h=64, mb=4, p_edge=0.9, seed=9):
    """Irregular non-QC alist with dense row strata (the port's copy of
    the JAX suite's generator): each stratum deals a shuffled round-robin
    of the columns to its rows, keeping each (column, stratum) edge with
    probability ``p_edge`` (a column with no edge yet always keeps its last
    one); rows keep degree >= 2."""
    rng = np.random.default_rng(seed)
    m = h * mb
    nlist = [[] for _ in range(n)]
    mlist = [[] for _ in range(m)]
    for b in range(mb):
        perm = rng.permutation(n)
        for i, c in enumerate(perm):
            last_chance = not nlist[c] and b == mb - 1
            if rng.random() < p_edge or last_chance:
                r = b * h + (i % h)
                nlist[c].append(r)
                mlist[r].append(c)
    for c in range(n):
        nlist[c].sort()
    for r in range(m):
        mlist[r].sort()
        assert len(mlist[r]) >= 2, "degenerate row"
    return Alist(n=n, m=m, nlist=nlist, mlist=mlist)


def _gf_mul(a, b, k, poly):
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> k:
            a ^= poly
    return r


def permutation_array(k=4, poly=0b10011, mb=6, nslopes=8, seed=1):
    """An RS-LDPC-like code over GF(2^k): column (a, b) has its stratum-i
    edge at row i·h + (a·x_i + b), for ``nslopes`` random slopes a, all b
    and distinct nonzero x_i; columns shuffled.  The RS exact column
    partition recovers the slope classes (cost 1.0)."""
    h = 1 << k
    rng = np.random.default_rng(seed)
    slopes = rng.choice(h, nslopes, replace=False)
    xs = rng.choice(np.arange(1, h), mb, replace=False)
    cols = [(int(a), b) for a in slopes for b in range(h)]
    cols = [cols[i] for i in rng.permutation(len(cols))]
    nlist = [[i * h + (_gf_mul(a, int(xs[i]), k, poly) ^ b)
              for i in range(mb)] for a, b in cols]
    mlist = [[] for _ in range(mb * h)]
    for c, rows in enumerate(nlist):
        for r in rows:
            mlist[r].append(c)
    return Alist(n=len(cols), m=mb * h, nlist=nlist, mlist=mlist)


def _jalist(a):
    return JAlist(n=a.n, m=a.m, nlist=a.nlist, mlist=a.mlist)


CODES = {
    "irregular_512": lambda: synthetic_stratified(512, h=64, mb=4, seed=9),
    "irregular_192": lambda: synthetic_stratified(192, h=24, mb=4, seed=3),
    "rs_gf16": permutation_array,
}


@pytest.fixture(scope="module")
def codes():
    """name -> (port alist, port structure, JAX structure, port Code)."""
    out = {}
    for name, make in CODES.items():
        a = make()
        out[name] = (a, detect_stratified(a), jst.detect_stratified(
            _jalist(a)), build_code(a))
    return out


def _samples(seed, b, n, sigma, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (1.0 + sigma * rng.standard_normal((b, n))).astype(dtype)


def assert_structure_equal(ps, js):
    for f in ("n", "m", "mb", "h", "kg", "w", "num_edges"):
        assert getattr(ps, f) == getattr(js, f), f
    for f in ("col_slot", "pos_of_col", "row_of", "vn_valid", "cn_valid",
              "cn_rank"):
        got, want = getattr(ps, f).numpy(), np.asarray(getattr(js, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # the index tables are the one-hot's nonzeros: (b, g, j, i) = 1 iff
    # CN slot (b, i, g) and VN slot (b, g, j) hold one edge
    b, g, j, i = np.nonzero(np.asarray(js.onehot))
    cn = np.full((js.mb, js.h, js.kg), -1, np.int32)
    vn = np.full((js.mb, js.kg, js.w), -1, np.int32)
    cn[b, i, g] = (b * js.kg + g) * js.w + j
    vn[b, g, j] = (b * js.h + i) * js.kg + g
    np.testing.assert_array_equal(ps.cn_from_vn.numpy(), cn)
    np.testing.assert_array_equal(ps.vn_from_cn.numpy(), vn)
    assert ps.cost == js.cost


# ---------------------------------------------------------------- structure


@pytest.mark.parametrize("kw", [dict(n=512, h=64, mb=4, seed=9),
                                dict(n=192, h=24, mb=4, seed=3),
                                dict(n=2048, h=64, mb=6, p_edge=1.0,
                                     seed=0)],
                         ids=["512", "192", "2048"])
def test_generator_copy_equals_jax(kw):
    a, ja = synthetic_stratified(**kw), jsynth(**kw)
    assert (a.n, a.m, a.nlist, a.mlist) == (ja.n, ja.m, ja.nlist, ja.mlist)


@pytest.mark.parametrize("name", list(CODES))
def test_structure_equals_jax(codes, name):
    a, ps, js, _ = codes[name]
    assert ps is not None and js is not None
    assert_structure_equal(ps, js)
    assert detect_qc(a) is None
    if name == "rs_gf16":  # the RS exact partition: h-wide groups, no pad
        assert (ps.mb, ps.h, ps.kg, ps.w, ps.cost) == (6, 16, 8, 16, 1.0)
    else:
        assert len(set(a.dv)) > 1  # irregular


def test_802_3an_geometry_equals_jax():
    """n=2048, 6 contiguous 64-row strata, dv 6, dc 32: the RS exact
    partition is tried in full and fails (random permutations), greedy
    coloring gives 60 groups of up to 47 columns."""
    a = synthetic_stratified(2048, h=64, mb=6, p_edge=1.0, seed=0)
    ps, js = detect_stratified(a), jst.detect_stratified(_jalist(a))
    assert_structure_equal(ps, js)
    assert (ps.mb, ps.h, ps.kg, ps.w) == (6, 64, 60, 47)
    assert round(ps.cost, 3) == 1.626 and ps.num_edges == 12288
    assert set(a.dv) == {6} and set(a.dc) == {32}


def test_greedy_row_strata_equal_jax(codes):
    """Rows relabeled so no contiguous strata exist: the greedy row
    coloring finds the same strata in the same order."""
    a = codes["irregular_192"][0]
    perm = np.random.default_rng(5).permutation(a.m)
    inv = np.argsort(perm)
    nlist = [sorted(int(inv[r]) for r in rows) for rows in a.nlist]
    mlist = [a.mlist[int(perm[r])] for r in range(a.m)]
    b = Alist(n=a.n, m=a.m, nlist=nlist, mlist=mlist)
    from ldpcsimulation_tpu_torch.codes import stratified as pst

    assert pst._contiguous_strata(b) is None
    ps, js = stratify(b), jst.stratify(_jalist(b))
    assert_structure_equal(ps, js)
    assert ps.row_of.numpy().tolist() != list(range(a.m))


def _rejections(a):
    """stratify's outcome for one alist in both packages: the structure's
    dims or the exception's type."""
    out = []
    for fn, alist in ((stratify, a), (jst.stratify, _jalist(a))):
        try:
            sc = fn(alist)
            out.append((sc.mb, sc.h, sc.kg, sc.w))
        except ValueError as e:
            out.append(type(e))
    return out


def test_detect_returns_none_where_jax_does(codes):
    a = peg(120, 60, 3, seed=5)
    assert detect_stratified(a) is None
    assert jst.detect_stratified(jpeg(120, 60, 3, seed=5)) is None
    a = peg(512, 256, 3, seed=7)
    assert detect_stratified(a, max_cost=0.01) is None
    assert jst.detect_stratified(jpeg(512, 256, 3, seed=7),
                                 max_cost=0.01) is None
    assert detect_stratified(nb_regular(24, 12, 3, q=4, seed=1)) is None
    # a code that stratifies, with a cost bound below its cost
    a, ps, _, _ = codes["irregular_512"]
    assert detect_stratified(a, max_cost=ps.cost - 0.01) is None
    assert jst.detect_stratified(_jalist(a), max_cost=ps.cost - 0.01) is None
    assert detect_stratified(a, max_cost=ps.cost) is not None


def test_stratify_rejects_bad_partitions(codes):
    """Two columns that share a row forced into one group, and a column's
    two edges forced into one stratum: ValueError in both packages."""
    a = codes["irregular_512"][0]
    partner = next(c for c in a.mlist[a.nlist[0][0]] if c != 0)
    groups = [[c for c in range(a.n) if c not in (0, partner)],
              [0, partner]]
    for fn, alist in ((stratify, a), (jst.stratify, _jalist(a))):
        with pytest.raises(ValueError, match="independent sets"):
            fn(alist, col_groups=groups)
        r0, r1 = a.nlist[0][:2]
        strata = [[r0, r1], [r for r in range(a.m) if r not in (r0, r1)]]
        with pytest.raises(ValueError, match="invalid strata"):
            fn(alist, row_strata=strata)
        with pytest.raises(ValueError, match="cover"):
            fn(alist, row_strata=[list(range(a.m - 1))])


def test_one_hot_size_limit_rejects_as_jax():
    """One stratum per row and one group per column of a 46400 x 23200 code:
    an [m, n, 1, 1] JAX one-hot of 1.08e9 > 2^30 entries.  Both packages
    refuse it, although the port would never allocate it."""
    n, m = 46400, 23200
    nlist = [[c % m, (c + 7) % m] for c in range(n)]
    mlist = [[] for _ in range(m)]
    for c, rows in enumerate(nlist):
        for r in sorted(rows):
            mlist[r].append(c)
    a = Alist(n=n, m=m, nlist=[sorted(r) for r in nlist], mlist=mlist)
    strata = [[r] for r in range(m)]
    groups = [[c] for c in range(n)]
    for fn, alist in ((stratify, a), (jst.stratify, _jalist(a))):
        with pytest.raises(ValueError, match="too large"):
            fn(alist, row_strata=strata, col_groups=groups)


# ------------------------------------------------------- moves and syndrome


@pytest.mark.parametrize("name", list(CODES))
def test_moves_and_syndrome_equal_jax(codes, name):
    a, ps, js, code = codes[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((ps.mb, ps.kg, ps.w, 8)).astype(np.float32)
    x = np.where(np.asarray(js.vn_valid)[..., None], x, 0.0).astype(
        np.float32)
    cn = stratified_to_cn(ps, torch.from_numpy(x))
    jcn = np.asarray(jms.stratified_to_cn(js, jnp.asarray(x)))
    np.testing.assert_array_equal(cn.numpy(), jcn)
    vn = stratified_to_vn(ps, cn)
    np.testing.assert_array_equal(
        vn.numpy(), np.asarray(jms.stratified_to_vn(js, jnp.asarray(jcn))))
    np.testing.assert_array_equal(vn.numpy(), x)  # partial permutations
    # f16 payloads move exactly too
    x16 = x.astype(np.float16)
    np.testing.assert_array_equal(
        stratified_to_cn(ps, torch.from_numpy(x16)).numpy(),
        np.asarray(jms.stratified_to_cn(js, jnp.asarray(x16))))
    # the syndrome check on random decisions and on codewords' signs
    d = rng.choice([-1, 1], size=(a.n, 64)).astype(np.int32)
    d[:, :8] = 1
    grid = stratified_grid(ps, torch.from_numpy(d))
    jgrid = np.asarray(jms.stratified_grid(js, jnp.asarray(d)))
    np.testing.assert_array_equal(grid.numpy(), jgrid)
    got = stratified_check_satisfied(ps, grid).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jms.stratified_check_satisfied(js, jnp.asarray(
            jgrid))))
    assert got[:8].all() and not got[8:].all()
    init = stratified_init(ps, grid.float(), torch.float16)
    np.testing.assert_array_equal(init.numpy(), np.asarray(
        jms.stratified_init(js, jnp.asarray(jgrid, jnp.float32),
                            jnp.float16)))


# ----------------------------------------------------------------- min-sum


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.hard.numpy(), np.asarray(want.hard))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.satisfied.numpy(),
                                  np.asarray(want.satisfied))


MINSUM_CASES = {
    "plain": dict(),
    "normalized_1.25": dict(variant="normalized", alpha=1.25),
    "normalized_1.3": dict(variant="normalized", alpha=1.3),
    "offset_0.15": dict(variant="offset", delta=0.15),
    "et": dict(early_termination=True),
    "f16": dict(storage_dtype="f16"),
    "f16_et": dict(early_termination=True, storage_dtype="f16"),
    "f16_normalized_1.3": dict(variant="normalized", alpha=1.3,
                               storage_dtype="f16"),
    "f16_offset_0.15": dict(variant="offset", delta=0.15,
                            storage_dtype="f16"),
}


def _kw(case, f16):
    kw = dict(MINSUM_CASES[case])
    if kw.get("storage_dtype") == "f16":
        kw["storage_dtype"] = f16
    return kw


@pytest.mark.parametrize("case", list(MINSUM_CASES))
def test_minsum_equals_jax_and_the_slot_array(codes, case):
    """Bit for bit: JAX's stratified decoder (one-hot einsums, the
    order-independent check update) and the port's slot-array decoder on
    the same samples, T=12 (f16 messages saturate on the strongest
    frames)."""
    a, ps, js, code = codes["irregular_512"]
    y = _samples(17, 96, a.n, 0.8)
    got = decode_minsum_stratified(ps, torch.from_numpy(y), 12,
                                   **_kw(case, torch.float16))
    want = jms.decode_minsum_stratified(js, jnp.asarray(y), 12,
                                        **_kw(case, jnp.float16))
    _assert_result_equal(got, want)
    slot = decode_minsum(code, torch.from_numpy(y), 12,
                         **_kw(case, torch.float16))
    for f in ("hard", "iterations", "satisfied"):
        assert torch.equal(getattr(got, f), getattr(slot, f)), f
    sat = got.satisfied.float().mean().item()
    assert 0.05 < sat < 0.95, sat  # both outcomes exercised


@pytest.mark.parametrize("name,case", [
    ("irregular_192", "plain"), ("irregular_192", "f16_offset_0.15"),
    ("rs_gf16", "et"), ("rs_gf16", "f16_normalized_1.3"),
])
def test_minsum_other_codes_equal_jax(codes, name, case):
    a, ps, js, code = codes[name]
    y = _samples(23, 64, a.n, 0.75)
    got = decode_minsum_stratified(ps, torch.from_numpy(y), 10,
                                   **_kw(case, torch.float16))
    _assert_result_equal(got, jms.decode_minsum_stratified(
        js, jnp.asarray(y), 10, **_kw(case, jnp.float16)))
    slot = decode_minsum(code, torch.from_numpy(y), 10,
                         **_kw(case, torch.float16))
    assert torch.equal(got.hard, slot.hard)
    assert torch.equal(got.iterations, slot.iterations)


@pytest.mark.parametrize("case", ["plain", "f16_normalized_1.3",
                                  "f16_offset_0.15"])
def test_minsum_step_equals_jax_on_the_named_slots(codes, case):
    """Three steps from the same messages: the totals equal JAX's
    everywhere, the stored messages in every VN slot with an edge (the
    port leaves ``total`` in the others, which no reader takes; JAX stores
    0 there)."""
    a, ps, js, code = codes["irregular_192"]
    kw = _kw(case, torch.float16)
    jkw = _kw(case, jnp.float16)
    kw.pop("early_termination", None), jkw.pop("early_termination", None)
    y = _samples(29, 16, a.n, 0.8)
    yg = stratified_grid(ps, torch.from_numpy(y).t())
    jyg = jms.stratified_grid(js, jnp.asarray(y).T)
    sdt = kw.get("storage_dtype", torch.float32)
    v2c = stratified_init(ps, yg, sdt)
    jv2c = jms.stratified_init(js, jyg, jkw.get("storage_dtype",
                                                jnp.float32))
    step = pms.stratified_minsum_step(ps, **kw)
    jstep = jms.stratified_minsum_step(js, **jkw)
    named = ps.vn_valid.numpy()
    assert not named.all()  # pad slots exist on this code
    for _ in range(3):
        v2c, total = step(v2c, yg)
        jv2c, jtotal = jstep(jv2c, jyg)
        np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
        got, want = v2c.numpy(), np.asarray(jv2c)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got[named], want[named])


def test_tied_minima_equal_jax(codes):
    """Integer samples make tied magnitudes common: B1's slot-order scan
    (CN slots in group order) gives the values of JAX's alist-rank
    tie-break, since tied minima all receive min1."""
    a, ps, js, code = codes["irregular_512"]
    rng = np.random.default_rng(7)
    y = rng.integers(-3, 4, size=(64, a.n)).astype(np.float32)
    y = np.where(y == 0, 1.0, y).astype(np.float32)
    got = decode_minsum_stratified(ps, torch.from_numpy(y), 4)
    _assert_result_equal(got, jms.decode_minsum_stratified(
        js, jnp.asarray(y), 4))
    assert torch.equal(got.hard, decode_minsum(code, torch.from_numpy(y),
                                               4).hard)
    # ties actually occur at the check update's input
    v = stratified_to_cn(ps, stratified_init(
        ps, stratified_grid(ps, torch.from_numpy(y).t()), torch.float32))
    mags = torch.where(ps.cn_valid[..., None], v.abs(), float("inf"))
    top2 = mags.topk(2, dim=2, largest=False).values
    assert (top2[:, :, 0] == top2[:, :, 1]).float().mean() > 0.3


def test_f16_channel_folds_in_f16(codes):
    """f16 samples with no storage type: the fold runs in f16, as in the
    JAX decoder and the slot-array one."""
    a, ps, js, code = codes["irregular_512"]
    y = _samples(5, 64, a.n, 0.8, np.float16)
    got = decode_minsum_stratified(ps, torch.from_numpy(y), 8)
    _assert_result_equal(got, jms.decode_minsum_stratified(
        js, jnp.asarray(y), 8))
    assert torch.equal(got.hard, decode_minsum(code, torch.from_numpy(y),
                                               8).hard)


@pytest.mark.parametrize("route", ["slot_array", "qc"])
def test_f16_channel_equals_jax_on_the_other_routes(route):
    """The slot-array and QC min-sum steps fold an f16 channel in f16 too
    (the JAX steps cast c2v to the channel's dtype)."""
    from ldpcsimulation_tpu.codes import library as jlib
    from ldpcsimulation_tpu.codes import qc as jqc_mod
    from ldpcsimulation_tpu.decoders import minsum as jminsum
    from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
    from ldpcsimulation_tpu_torch.codes import QCCode, load_named_code
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc

    if route == "qc":
        jqc = jqc_mod.qc_peg(8, 4, 3, z=16, seed=0)
        code, jcode = QCCode.from_reference(jqc), jqc
        port, jdec = decode_minsum_qc, jmsqc.decode_minsum_qc
    else:
        code, jcode = load_named_code("peg_96_48"), jlib.load_named_code(
            "peg_96_48")
        port, jdec = decode_minsum, jminsum.decode_minsum
    y = _samples(5, 128, code.n, 0.8, np.float16)
    for kw in (dict(), dict(variant="offset", delta=0.15,
                            early_termination=True)):
        _assert_result_equal(port(code, torch.from_numpy(y), 8, **kw),
                             jdec(jcode, jnp.asarray(y), 8, **kw))


def test_the_check_update_is_kernel_b1(codes, monkeypatch):
    """Every iteration calls B1's wrapper once, on the VN-slot planes
    through the stratified routing table; a table of more than 64 groups
    reaches the wrapper whole (the card refuses it by name, never the twin
    silently)."""
    a, ps, js, code = codes["irregular_192"]
    seen = []
    real = pms.minsum_cn_scan

    def spy(v2c, cn_rows, *args):
        seen.append((tuple(v2c.shape), tuple(cn_rows.shape)))
        return real(v2c, cn_rows, *args)

    monkeypatch.setattr(pms, "minsum_cn_scan", spy)
    decode_minsum_stratified(ps, torch.from_numpy(_samples(1, 8, a.n, 0.8)),
                             5)
    assert seen == [((ps.mb * ps.kg * ps.w, 8), (ps.mb * ps.h, ps.kg))] * 5
    wide = stratify(a, col_groups=[[c] for c in range(a.n)])
    assert wide.kg == a.n > 64
    seen.clear()
    decode_minsum_stratified(wide, torch.from_numpy(
        _samples(1, 8, a.n, 0.8)), 1)
    assert seen == [((wide.mb * a.n, 8), (wide.mb * wide.h, a.n))]


# ------------------------------------------------------------ DD-BMP and BP


@pytest.mark.parametrize("name", list(CODES))
def test_ddbmp_equals_jax_and_the_slot_array(codes, name):
    a, ps, js, code = codes[name]
    y = _samples(31, 64, a.n, 0.6)
    yq = quantize_no_zero(torch.from_numpy(y), 1.5, 8.0)
    got = decode_ddbmp_stratified(ps, yq, 15)
    _assert_result_equal(got, jdd.decode_ddbmp_stratified(
        js, jnp.asarray(yq.numpy()), 15))
    slot = decode_ddbmp(code, yq, 15)
    for f in ("hard", "iterations", "satisfied"):
        assert torch.equal(getattr(got, f), getattr(slot, f)), f
    assert 0 < got.satisfied.float().mean().item() < 1


def test_bp_step_within_tolerance_of_jax(codes):
    """One BP iteration from the same f16 messages: the stored messages
    and totals within the BP tolerance of JAX's (XLA contracts the pair
    fold into fused multiply-adds)."""
    a, ps, js, code = codes["irregular_512"]
    n0 = snr_to_n0(2.0, 0.5)
    llr = llr_from_channel(torch.from_numpy(_samples(3, 64, a.n, 0.8)), n0)
    yg = stratified_grid(ps, llr.t().contiguous())
    v2c = stratified_init(ps, yg, torch.float16)
    for _ in range(3):  # a few rounds in, messages of every size
        v2c, total = stratified_bp_step(ps, storage_dtype=torch.float16)(
            v2c, yg)
    jv, jt = jbps.stratified_bp_step(js, storage_dtype=jnp.float16)(
        jnp.asarray(v2c.numpy()), jnp.asarray(yg.numpy()))
    v2c, total = stratified_bp_step(ps, storage_dtype=torch.float16)(v2c, yg)
    np.testing.assert_allclose(total.numpy(), np.asarray(jt), rtol=BP_RTOL,
                               atol=BP_ATOL)
    np.testing.assert_allclose(v2c.float().numpy(),
                               np.asarray(jv).astype(np.float32),
                               rtol=2e-3, atol=BP_ATOL)  # one f16 ulp
    assert v2c.dtype == torch.float16


@pytest.mark.parametrize("name", ["irregular_512", "rs_gf16"])
def test_bp_decode_agrees_with_jax_and_the_slot_array(codes, name):
    a, ps, js, code = codes[name]
    n0 = snr_to_n0(1.5, 0.5)
    llr = llr_from_channel(torch.from_numpy(_samples(8, 128, a.n, 0.85)), n0)
    got = decode_bp_stratified(ps, llr, 10, early_termination=True,
                               storage_dtype=torch.float16)
    want = jbps.decode_bp_stratified(js, jnp.asarray(llr.numpy()), 10,
                                     early_termination=True,
                                     storage_dtype=jnp.float16)
    slot = decode_bp(code, llr, 10, early_termination=True,
                     storage_dtype=torch.float16)
    for other in (want, slot):
        frames = ((got.hard.numpy() == np.asarray(other.hard)).all(axis=1)
                  & (got.iterations.numpy()
                     == np.asarray(other.iterations)))
        assert frames.mean() >= BP_FRAME_AGREEMENT, frames.mean()
    assert 0 < got.satisfied.float().mean().item() < 1


def test_jax_codes_from_the_same_alist_agree(codes):
    """The slot-array codes the comparisons above use are JAX's tables."""
    a, _, _, code = codes["irregular_192"]
    j = jbuild_code(_jalist(a))
    np.testing.assert_array_equal(code.cn_vn.numpy(), np.asarray(j.cn_vn))
    np.testing.assert_array_equal(code.vn_cn.numpy(), np.asarray(j.vn_cn))
