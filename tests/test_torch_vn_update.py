"""Kernel B5, the flooding min-sum VN update, on the CPU (the CUDA kernel
itself runs only on the card), bit for bit: the port's steps (B1's twin with
its storage-typed store, then B5's twin) against the JAX steps on peg_96_48,
wifi_648_324 (padding slots), an irregular QC code in all three variants and
a QC structure with pairs and an absent edge, in the four (channel, storage)
dtype pairs; one DVB-S2 QC step against the JAX step run op by op; the table
``vn_rows`` against ``QCPlan.fold``; B1's f16 store against its f32 output
cast; and the kernel's per-element arithmetic written out in numpy against
the twin on ±0 terms, subnormals and the 65504 clamp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu_torch.codes import (
    QCCode,
    load_named_code,
    load_named_qc,
)
from ldpcsimulation_tpu_torch.decoders import (
    minsum_plan,
    minsum_step,
    qc_minsum_step,
    qc_plan,
)
from ldpcsimulation_tpu_torch.kernels.minsum import (
    NO_TERM,
    minsum_cn_scan_plain,
    minsum_vn_update,
    minsum_vn_update_plain,
    vn_lane_width,
    zero_term,
)
from tests.test_torch_minsum import _bits, _samples, _tied_messages
from tests.test_torch_minsum_general import _random_structure
from tests.test_torch_minsum_qc import _carry_planes, _jax_carry
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
B = 32
# (channel dtype, storage dtype) as numpy types
PAIRS = {
    "y32-s16": (np.float32, np.float16),
    "y32-s32": (np.float32, np.float32),
    "y16-s16": (np.float16, np.float16),
    "y16-s32": (np.float16, np.float32),
}
VARIANTS = {
    "plain": {},
    "normalized": dict(alpha=1.25),
    "offset": dict(delta=0.15),
}
TORCH = {np.float16: torch.float16, np.float32: torch.float32}


def _channel(rng, n, dtype):
    """[N, B] samples with a few near the f16 range: sums past 65504
    reach the clamp (f32 channel) or inf before it (f16 channel)."""
    y = _samples(rng, B, n).T.copy()
    big = rng.random(y.shape) < 0.03
    y[big] = rng.choice(np.float32([65500.0, 65510.0, -65515.0, 40000.0]),
                        size=int(big.sum()))
    return y.astype(dtype)


def _equal(got, want):
    assert torch.equal(torch.from_numpy(_bits(got.numpy())),
                       torch.from_numpy(_bits(np.array(want))))


def _assert_step_equal(port_step, jax_step, planes, jplanes, y, jy, skip=()):
    """The port's step against the JAX step run op by op (compiled, XLA
    turns ``/ alpha`` by a closed-over constant into a reciprocal multiply:
    ROADMAP's standing divergences): v2c' (but for the rows in ``skip``)
    and total, under ``torch.equal`` on the bits."""
    with jax.disable_jit():
        jv2c, jtot = jax_step(jplanes, jy)
    before = planes.clone()
    v2c, tot = port_step(planes, torch.from_numpy(y))
    assert torch.equal(planes.view(torch.int16 if planes.dtype ==
                                   torch.float16 else torch.int32),
                       before.view(torch.int16 if planes.dtype ==
                                   torch.float16 else torch.int32))
    assert v2c.dtype == planes.dtype and tot.dtype == TORCH[y.dtype.type]
    want = np.asarray(jv2c) if not isinstance(jv2c, (tuple, list)) else (
        _carry_planes(jv2c))
    want = want.reshape(planes.shape)
    keep = np.ones(len(want), bool)
    keep[list(skip)] = False
    _equal(v2c[torch.from_numpy(keep)], want[keep])
    _equal(tot, np.asarray(jtot).reshape(tot.shape))


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("name,variant", [
    ("peg_96_48", "plain"), ("peg_96_48", "normalized"),
    ("peg_96_48", "offset"), ("wifi_648_324", "plain"),
])
def test_slot_array_step_equals_jax(name, variant, pair):
    """``minsum_step`` (B1's twin storing c2v in the storage type, B5's twin
    over it) equals the JAX ``minsum_step``; wifi_648_324 has padding slots
    (+0.0 terms whose v2c' is the total)."""
    ydt, sdt = PAIRS[pair]
    jcode, code = jlib.load_named_code(name), load_named_code(name)
    rng = np.random.default_rng(15)
    v2c = _tied_messages(rng, (code.n * code.dv_max, B), sdt)
    y = _channel(rng, code.n, ydt)
    jstep = jminsum.minsum_step(jcode, variant, storage_dtype=jnp.dtype(sdt),
                                **VARIANTS[variant])
    step = minsum_step(code, variant, storage_dtype=TORCH[sdt],
                       **VARIANTS[variant])
    _assert_step_equal(step, jstep, torch.from_numpy(v2c), jnp.asarray(v2c),
                       y, jnp.asarray(y))


def _qc_codes():
    return {
        "qc_ira_z8": jqc_mod.qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3),
        "pairs_absent": _random_structure(np.random.default_rng(2025)),
    }


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("name,variant", [
    ("qc_ira_z8", "plain"), ("qc_ira_z8", "normalized"),
    ("qc_ira_z8", "offset"), ("pairs_absent", "plain"),
])
def test_qc_step_equals_jax(name, variant, pair):
    """``qc_minsum_step`` equals the JAX ``qc_minsum_step`` on an irregular
    code (columns of degree 1 to 3: ``NO_TERM`` past a column's degree) and
    on a structure with two-circulant pairs and an absent edge, whose row
    no check reads (the JAX step subtracts its scan's output for the +inf
    it read there, the port a zero: a standing divergence in ROADMAP)."""
    ydt, sdt = PAIRS[pair]
    jqc = _qc_codes()[name]
    qc = QCCode.from_reference(jqc)
    plan = qc_plan(qc, CPU)
    rng = np.random.default_rng(16)
    planes = _tied_messages(rng, (plan.num_planes * qc.z, B), sdt)
    y = _channel(rng, qc.n, ydt)
    jstep = jmsqc.qc_minsum_step(jqc, variant, storage_dtype=jnp.dtype(sdt),
                                 **VARIANTS[variant])
    step = qc_minsum_step(qc, variant, storage_dtype=TORCH[sdt],
                          **VARIANTS[variant])
    skip = () if plan.absent_rows is None else plan.absent_rows.tolist()
    assert bool(skip) == (name == "pairs_absent")
    _assert_step_equal(step, jstep, torch.from_numpy(planes),
                       _jax_carry(jqc, planes), y,
                       jnp.asarray(y).reshape(qc.nb, qc.z, B), skip)


def test_dvbs2_step_equals_jax_op_by_op():
    """One DVB-S2 QC step (eight pairs, the absent edge, degrees 2, 3 and
    8), f16 storage and an f32 channel, B=4: equal to the JAX step run op
    by op (no compile) on v2c' but for the absent edge's row, and on the
    total."""
    jqc, qc = jlib.load_named_qc("dvbs2_1_2_qc"), load_named_qc(
        "dvbs2_1_2_qc")
    plan = qc_plan(qc, CPU)
    rng = np.random.default_rng(17)
    planes = _tied_messages(rng, (plan.num_planes * qc.z, 4), np.float16)
    y = _samples(rng, 4, qc.n).T.copy()
    with jax.disable_jit():
        jv2c, jtot = jmsqc.qc_minsum_step(jqc, storage_dtype=jnp.float16)(
            _jax_carry(jqc, planes), jnp.asarray(y).reshape(qc.nb, qc.z, 4))
    v2c, tot = qc_minsum_step(qc, storage_dtype=torch.float16)(
        torch.from_numpy(planes), torch.from_numpy(y))
    _equal(tot, np.asarray(jtot).reshape(qc.n, 4))
    keep = torch.ones(len(planes), dtype=torch.bool)
    keep[plan.absent_rows] = False
    assert int((~keep).sum()) == 1
    _equal(v2c[keep], _carry_planes(jv2c)[keep.numpy()])


# ------------------------------------------------------------- the table


@pytest.mark.parametrize("name", ["qc_1008_504", "qc_ira_z8",
                                  "pairs_absent", "dvbs2_1_2_qc"])
def test_vn_rows_follows_the_fold(name):
    """``QCPlan.vn_rows`` names every message row once, column by column in
    ``QCPlan.fold``'s order (a pair's terms swapped per column as the fold
    swaps them), absent edges as +0.0 terms and ``NO_TERM`` past a column's
    degree."""
    jqc = _qc_codes().get(name)
    qc = (QCCode.from_reference(jqc) if jqc is not None
          else load_named_qc(name))
    plan = qc_plan(qc, CPU)
    t = plan.vn_rows.numpy().astype(np.int64)
    assert t.shape == (qc.n, qc.dv_max) and plan.vn_rows.dtype == torch.int32
    rows = np.where(t >= 0, t, zero_term(t))
    named = rows[t != NO_TERM]
    assert sorted(named.tolist()) == list(range(plan.num_planes * qc.z))
    absent = [] if plan.absent_rows is None else plan.absent_rows.tolist()
    assert sorted(rows[(t != NO_TERM) & (t < 0)].tolist()) == sorted(absent)
    want = np.full_like(t, NO_TERM)
    for s, (cols, fold_rows) in enumerate(plan.fold):
        want[slice(None) if cols is None else cols.numpy(), s] = (
            fold_rows.numpy())
    assert np.array_equal(np.where(t == NO_TERM, NO_TERM, rows), want)
    # positions with a term come first in every column
    has = t != NO_TERM
    assert (has[:, :-1] | ~has[:, 1:]).all() and has[:, 0].all()
    if name == "qc_ira_z8":
        assert (~has).any()
    if name in ("pairs_absent", "dvbs2_1_2_qc"):
        assert qc.extra_edges and len(absent) >= 1
        assert not all(torch.equal(a, b) for (_, a), (_, b)
                       in zip(plan.fold, plan.fold_phys))


def test_slot_array_vn_rows():
    """``MinSumPlan.vn_rows`` is the VN-slot index ``v * dv_max + s``, with
    every padding slot as a +0.0 term on its own row."""
    code = load_named_code("wifi_648_324")
    t = minsum_plan(code, CPU).vn_rows.numpy().astype(np.int64)
    slots = np.arange(code.n * code.dv_max).reshape(code.n, code.dv_max)
    mask = code.vn_mask.numpy()
    assert (~mask).any()
    assert np.array_equal(t[mask], slots[mask])
    assert np.array_equal(t[~mask], zero_term(slots[~mask]))


# ------------------------------------------------------ B1's f16 store


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["peg_96_48", "wifi_648_324"])
def test_b1_f16_store_equals_f32_output_cast(name, variant):
    """B1's twin with ``out_dtype=f16`` on f16 messages equals its f32
    output cast to f16 on every named row, bit for bit (signed zeros too):
    every output already is an f16 value."""
    code = load_named_code(name)
    cn_rows = minsum_plan(code, CPU).cn_rows
    rng = np.random.default_rng(18)
    v2c = torch.from_numpy(_tied_messages(rng, (code.n * code.dv_max, B),
                                          np.float16))
    named = cn_rows[cn_rows >= 0].long()
    kw = VARIANTS[variant]
    f32 = minsum_cn_scan_plain(v2c, cn_rows, variant, **kw)
    f16 = minsum_cn_scan_plain(v2c, cn_rows, variant,
                               out_dtype=torch.float16, **kw)
    assert f16.dtype == torch.float16
    assert torch.equal(f16[named].view(torch.int16),
                       f32[named].half().view(torch.int16))
    assert torch.equal(f16[named].float().view(torch.int32),
                       f32[named].view(torch.int32))
    with pytest.raises(ValueError, match="c2v is f32"):
        minsum_cn_scan_plain(v2c.float(), cn_rows, out_dtype=torch.float16)


# ---------------------------------------------- the kernel's arithmetic


def _round(x, dt):
    """f32 values rounded to ``dt``'s precision, kept as f32."""
    return x.astype(dt).astype(np.float32)


def _b5_model(c2v, y, table):
    """csrc/minsum_vn_update.cu per element, in numpy f32: terms rounded to
    the channel's type, a fold from -0.0 with each add rounded to it, the
    total, each difference rounded to it, the clamp to +-65504 for f16
    storage before the cast, written over the term's own row."""
    cdt, sdt = y.dtype.type, c2v.dtype.type
    out, totals = c2v.copy(), []
    for j in range(table.shape[0]):
        acc = np.full(y.shape[1], -0.0, np.float32)
        terms = []
        for e in table[j]:
            if e == NO_TERM:
                continue
            t = (_round(c2v[e].astype(np.float32), cdt) if e >= 0
                 else np.zeros(y.shape[1], np.float32))
            terms.append((e if e >= 0 else -e - 2, t))
            acc = _round(acc + t, cdt)
        total = _round(y[j].astype(np.float32) + acc, cdt)
        for row, t in terms:
            x = _round(total - t, cdt)
            if sdt == np.float16:
                x = np.where(x > 65504, np.float32(65504),
                             np.where(x < -65504, np.float32(-65504), x))
            out[row] = x.astype(sdt)
        totals.append(total.astype(cdt))
    return out, np.stack(totals)


def _hazard_values(rng, shape, dtype):
    """Ties, ±0, f16 and f32 subnormals, values that round to the f16
    limits, and sums past 65504."""
    pool = np.float32([0.0, -0.0, 1.0, -1.0, 0.5, 2.0 ** -24, -2.0 ** -24,
                       3 * 2.0 ** -25, 1e-40, -1e-40, 65504.0, -65504.0,
                       65519.0, -65519.0, 32768.0, 1.0009765625,
                       1.00048828125, 2049.0, -2047.5, 1e5, 0.1])
    v = rng.choice(pool, size=shape)
    noise = rng.random(shape) < 0.3
    v[noise] = rng.normal(size=int(noise.sum())).astype(np.float32) * 3
    return v.astype(dtype)


@pytest.mark.parametrize("pair", PAIRS)
def test_numpy_model_equals_twin(pair):
    """The kernel's arithmetic in numpy equals the twin bit for bit on a
    table with every entry kind (a term, a +0.0 term, no term) and a column
    of dv 10 (past the kernel's 8 register-held terms), on hazard values:
    the f16 channel's fold rounds after every add, -0.0 + 0.0 = +0.0, and
    an f32 difference in (65504, 65520) stores 65504, not inf."""
    ydt, sdt = PAIRS[pair]
    rng = np.random.default_rng(19)
    rows = rng.permutation(40)
    table = np.full((5, 10), NO_TERM, np.int64)
    table[0, :10] = rows[:10]
    table[1, :3] = rows[10:13]
    table[2, :4] = [rows[13], zero_term(rows[14]), rows[15],
                    zero_term(rows[16])]
    table[3, :1] = zero_term(rows[17])
    table[4, :8] = rows[18:26]
    with np.errstate(over="ignore", invalid="ignore"):  # f16 inf, inf-inf
        c2v = _hazard_values(rng, (40, 64), sdt)
        y = _hazard_values(rng, (5, 64), ydt)
        want_v2c, want_total = _b5_model(c2v, y, table)
    named = np.zeros(40, bool)
    named[rows[:26]] = True
    got_v2c, got_total = minsum_vn_update_plain(
        torch.from_numpy(c2v.copy()), torch.from_numpy(y),
        torch.from_numpy(table.astype(np.int32)))
    np.testing.assert_array_equal(_bits(got_total.numpy()),
                                  _bits(want_total))
    np.testing.assert_array_equal(_bits(got_v2c.numpy()), _bits(want_v2c))
    # rows the table does not name are left as they were
    np.testing.assert_array_equal(_bits(got_v2c.numpy()[~named]),
                                  _bits(c2v[~named]))
    if sdt == np.float16 and ydt == np.float32:
        assert (got_v2c.numpy()[named] == 65504).any()
        assert not np.isinf(got_v2c.numpy()[named]).any()  # NaN: inf-inf


def test_f16_fold_rounds_every_add():
    """1 + 2^-11 + 2^-11 in f16: rounding after each add keeps 1 (a tie to
    even, twice); one rounding at the end would give 1 + 2^-10."""
    c2v = torch.tensor([[1.0], [2.0 ** -11], [2.0 ** -11]],
                       dtype=torch.float16)
    y = torch.zeros((1, 1), dtype=torch.float16)
    table = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    _, total = minsum_vn_update(c2v, y, table)
    assert float(total) == 1.0
    assert float(torch.tensor(1 + 2 * 2.0 ** -11).half()) != 1.0


def test_zero_terms_and_signed_zeros():
    """A column whose terms are -0.0 and a +0.0 term, on a -0.0 channel:
    the fold gives +0.0 (as the JAX decoders' added zero does), and each
    extrinsic output is total - term."""
    c2v = torch.tensor([[-0.0], [-0.0], [7.0]])
    y = torch.tensor([[-0.0]])
    table = torch.tensor([[0, 1, zero_term(2)]], dtype=torch.int32)
    v2c, total = minsum_vn_update(c2v, y, table)
    assert total.view(torch.int32).item() == 0  # +0.0
    assert v2c[:2].view(torch.int32).tolist() == [[0], [0]]
    assert v2c[2].view(torch.int32).item() == 0  # +0.0 - +0.0
    only_neg = minsum_vn_update(torch.tensor([[-0.0]]), torch.tensor([[-0.0]]),
                                torch.tensor([[0]], dtype=torch.int32))[1]
    assert only_neg.view(torch.int32).item() == -2 ** 31  # -0.0 kept


# ---------------------------------------------------------- the wrapper


def test_wrapper_runs_the_twin_in_place_and_checks_inputs():
    """On CPU tensors the wrapper is the twin; v2c' lands in c2v's own
    memory; the inputs are checked."""
    code = load_named_code("wifi_648_324")
    plan = minsum_plan(code, CPU)
    rng = np.random.default_rng(20)
    c2v = torch.from_numpy(_tied_messages(rng, (code.n * code.dv_max, 8),
                                          np.float16))
    y = torch.from_numpy(_samples(rng, 8, code.n).T.copy())
    ptr = c2v.data_ptr()
    want = minsum_vn_update_plain(c2v.clone(), y, plan.vn_rows)
    got = minsum_vn_update(c2v, y, plan.vn_rows)
    assert got[0].data_ptr() == ptr
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="vn_rows"):
        minsum_vn_update(c2v, y, plan.vn_rows.long())
    with pytest.raises(ValueError, match="y"):
        minsum_vn_update(c2v, y[:, :4].contiguous(), plan.vn_rows)
    with pytest.raises(ValueError, match="contiguous"):
        minsum_vn_update(c2v, y.t().contiguous().t(), plan.vn_rows)


@pytest.mark.parametrize("mdt,sdt", [(np.float32, np.float16),
                                     (np.float16, np.float32)])
@pytest.mark.parametrize("route", ["slot-array", "qc"])
def test_steps_take_messages_outside_the_storage_dtype(route, mdt, sdt):
    """Messages whose dtype is not the storage dtype (f32 messages with f16
    storage, and the reverse): B1 scans them into f32, B5 runs on f32
    storage and v2c' is cast, saturating, to the storage dtype; v2c' and
    the total equal the JAX step's, run op by op, which scans v2c in its
    own dtype and ends in ``storage_cast(total - c2v, sdt)``."""
    rng = np.random.default_rng(21)
    if route == "slot-array":
        jcode, code = jlib.load_named_code("peg_96_48"), load_named_code(
            "peg_96_48")
        msgs = _tied_messages(rng, (code.n * code.dv_max, B), mdt)
        y = _channel(rng, code.n, np.float32)
        jstep = jminsum.minsum_step(jcode, storage_dtype=jnp.dtype(sdt))
        step = minsum_step(code, storage_dtype=TORCH[sdt])
        jmsgs, jy = jnp.asarray(msgs), jnp.asarray(y)
    else:
        jqc = _qc_codes()["qc_ira_z8"]
        qc = QCCode.from_reference(jqc)
        msgs = _tied_messages(
            rng, (qc_plan(qc, CPU).num_planes * qc.z, B), mdt)
        y = _channel(rng, qc.n, np.float32)
        jstep = jmsqc.qc_minsum_step(jqc, storage_dtype=jnp.dtype(sdt))
        step = qc_minsum_step(qc, storage_dtype=TORCH[sdt])
        jmsgs = _jax_carry(jqc, msgs)
        jy = jnp.asarray(y).reshape(qc.nb, qc.z, B)
    with jax.disable_jit():
        jv2c, jtot = jstep(jmsgs, jy)
    want = (np.asarray(jv2c) if route == "slot-array"
            else _carry_planes(jv2c)).reshape(msgs.shape)
    assert want.dtype == sdt
    v2c, tot = step(torch.from_numpy(msgs), torch.from_numpy(y))
    assert v2c.dtype == TORCH[sdt]
    _equal(v2c, want)
    _equal(tot, np.asarray(jtot).reshape(tot.shape))


@pytest.mark.parametrize("batch,offsets,want", [
    (32768, (0, 0, 0), 4),
    (32770, (0, 0, 0), 2),    # even, not a multiple of 4
    (32771, (0, 0, 0), 1),    # odd: the 1-lane instance
    (1, (0, 0, 0), 1),        # msg_trace's B=1
    (32768, (2, 0, 0), 2),    # c2v two f16 elements in: 4-byte rows
    (32768, (1, 0, 0), 1),
    (32768, (0, 2, 0), 2),    # y two f32 elements in
])
def test_vn_lane_width(batch, offsets, want):
    """B5's instance: the widest lane count that divides the batch and
    keeps c2v's f16 rows and y's and total's f32 rows aligned."""
    bufs = [torch.zeros(batch + 4, dtype=dt)
            for dt in (torch.float16, torch.float32, torch.float32)]
    views = [b[o:o + batch].view(1, batch) for b, o in zip(bufs, offsets)]
    assert vn_lane_width(*views) == want
