"""The port's flooding sum-product decoders against the JAX package.

BP is the first slice that cannot be bit-exact: XLA's CPU ``exp``/``log``
and PyTorch's differ by ulps, and 20 iterations amplify that near decision
boundaries.  What can be exact is held exactly — the hyperbolic-pair fold
up to the argument of the ``log`` (multiplies, adds and one division in a
fixed order, against the JAX function run op by op; compiled, XLA contracts
the fold into fused multiply-adds, which a test shows), the neutral elements, the clamped variable update — then one check update at a
stated tolerance, and T=20 decodes by frame agreement.  JAX inputs are f32
arrays: ``tests/conftest.py`` enables x64, and a float64 input would make the
JAX side compute in f64."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import bp as jbp
from ldpcsimulation_tpu.decoders import bp_qc as jbpqc
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_code
from ldpcsimulation_tpu_torch.decoders import (
    MAXLLR,
    bp_cn_update,
    decode_bp,
    decode_bp_qc,
    gather_cn,
    gather_vn,
    pair_excl_logmags,
    qc_bp_step,
    qc_cn_bp,
    qc_plan,
    sgn_pos,
    vn_update,
)
from ldpcsimulation_tpu_torch.decoders.bp import pair_excl_sums
from tests.test_torch_layered import PAIR_EDGES
from tests.test_torch_minsum import _bits, _samples
from tests.test_torch_minsum_qc import _carry_planes, _jax_carry
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

#: one check update against the JAX one: |Δ| <= ATOL + RTOL·|want| (f32; the
#: log of a ratio near 1 turns an ulp of the ratio into ~1e-7 absolute, the
#: exp of a clamped message an ulp of u into ~1e-6 relative)
CN_RTOL, CN_ATOL = 2e-5, 2e-6
#: f16-stored planes: one f16 ulp at |m| in [16, 32)
F16_ULP_AT_20 = 2.0 ** -6
#: share of frames whose T=20 decisions must equal the JAX decoder's in
#: every bit, and whose iteration counts and flags must agree
FRAME_AGREEMENT = 0.97


def _phi(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = -log(tanh(x/2)), stable for x in [~1e-30, ~1e30]: the
    classical form of the check-node magnitude map, the oracle of the pair
    evaluation (``phi(Σ phi(|m|))`` gives the same magnitudes)."""
    return torch.log1p(2.0 / torch.expm1(x))


def _llr(rng, b, n, sigma):
    y = _samples(rng, b, n, sigma=sigma)
    return (2.0 * y / np.float32(sigma) ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def small_qcs():
    return {
        "qc_ira_z8": jqc_mod.qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3),
        "pair_absent_z5": jqc_mod.build_qc_code_edges(
            PAIR_EDGES, 5, 2, 3, minus_edges=((1, 2, 4, 1),)),
    }


def _get(name, small_qcs):
    jqc = small_qcs.get(name) or jlib.load_named_qc(name)
    return jqc, QCCode.from_reference(jqc)


# ------------------------------------------------------------ the pair fold


def _fold_inputs(k):
    rng = np.random.default_rng(k)
    us = np.exp(-np.abs(rng.normal(0, 6, (k, 64, 32)))).astype(np.float32)
    us[rng.random(us.shape) < 0.05] = 0.0  # absent edges
    us[rng.random(us.shape) < 0.03] = 1.0  # zero messages
    return us


def _jax_log_arguments(us, compiled):
    """The argument of every ``log`` of the JAX ``pair_excl_logmags``."""
    with mock.patch.object(jbp.jnp, "log", lambda x: x):
        fn = lambda *u: jbp.pair_excl_logmags(list(u))  # noqa: E731
        if compiled:
            fn = jax.jit(fn)
        return [np.asarray(r) for r in fn(*[jnp.asarray(u) for u in us])]


@pytest.mark.parametrize("k", [2, 3, 7, 20])
def test_pair_fold_before_the_log_is_bit_exact(k):
    """The same u arrays (seeded; in (e^-20, 1], with exact 0 and 1
    entries) through the JAX ``pair_excl_logmags`` with its ``log`` replaced
    by the identity, run op by op, and through the port's fold: the argument
    of every log equals in every bit (multiplies, adds and one division in a
    fixed order)."""
    us = _fold_inputs(k)
    want = _jax_log_arguments(us, compiled=False)
    sums = pair_excl_sums([torch.from_numpy(u) for u in us])
    with np.errstate(divide="ignore", invalid="ignore"):
        for t, ((num, den), w) in enumerate(zip(sums, want)):
            assert w.dtype == np.float32
            np.testing.assert_array_equal(
                _bits((num / den).numpy()), _bits(w), err_msg=f"output {t}")


@pytest.mark.parametrize("k", [3, 7, 20])
def test_compiled_jax_fold_differs_by_fused_multiply_adds(k):
    """Compiled by XLA for the CPU, the same JAX function differs from its
    own op-by-op run (and so from the port) by ulps: XLA contracts the
    fold's ``s + d·u`` and ``d + s·u`` into fused multiply-adds.  Shown on
    the first and last outputs, whose only non-trivial fold is one chain:
    they equal a fold with an exactly rounded ``fma`` (evaluated in f64) in
    every bit.  Every output stays within 8 ulps of the port's."""
    us = _fold_inputs(k)
    want = _jax_log_arguments(us, compiled=True)

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)

    s, d = np.ones_like(us[0]), np.zeros_like(us[0])
    for t in range(k - 1, 0, -1):  # the suffix chain of output 0
        s, d = fma(d, us[t], s), fma(s, us[t], d)
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(_bits(s / d), _bits(want[0]))
        sums = pair_excl_sums([torch.from_numpy(u) for u in us])
        differs = 0
        for (num, den), w in zip(sums, want):
            got = (num / den).numpy()
            ok = np.isfinite(w)
            np.testing.assert_array_equal(got[~ok], w[~ok])
            ulps = np.abs(_bits(got[ok]).astype(np.int64) - _bits(w[ok]))
            assert ulps.max() <= 8
            differs += int((ulps > 0).sum())
    assert differs > 0


def test_pair_fold_neutral_elements():
    """``exp(−inf)`` is exactly 0 and leaves the fold untouched bit for bit;
    ``sgn_pos(+inf)`` is +1; a zero message (u = 1) forces every other
    output of its check to exactly 0 and drops out of its own exclusion."""
    rng = np.random.default_rng(2)
    m = torch.from_numpy(rng.normal(0, 5, (5, 16)).astype(np.float32))
    u = [torch.exp(-m[t].abs()) for t in range(5)]
    inf = torch.full((16,), float("inf"))
    u_inf = torch.exp(-inf.abs())
    assert (u_inf == 0).all() and (sgn_pos(inf) == 1).all()
    base = pair_excl_logmags(u)
    for at in (0, 2, 5):  # an absent slot before, inside and after
        ext = u[:at] + [u_inf] + u[at:]
        got = pair_excl_logmags(ext)
        for t, b in enumerate(base):
            assert torch.equal(got[t + (t >= at)], b)
    one = torch.ones(16)
    got = pair_excl_logmags([u[0], one, u[1], u[2]])
    for t in (0, 2, 3):
        assert (got[t] == 0).all()
    ref = pair_excl_logmags([u[0], u[1], u[2], u_inf])[3]
    torch.testing.assert_close(got[1], ref, rtol=1e-5, atol=1e-6)
    assert (got[1] > 0).all()
    # the JAX fold has the same neutral elements
    jgot = jbp.pair_excl_logmags(
        [jnp.asarray(x.numpy()) for x in (u[0], one, u[1], u[2])])
    for t in (0, 2, 3):
        assert (np.asarray(jgot[t]) == 0).all()


def test_pair_magnitudes_equal_the_phi_form():
    """``log(s/d)`` equals ``phi(Σ_{k≠t} phi(|m_k|))`` (evaluated in f64)."""
    rng = np.random.default_rng(3)
    m = np.abs(rng.normal(0, 4, (6, 200))).clip(0.05, 20).astype(np.float32)
    got = pair_excl_logmags([torch.exp(-torch.from_numpy(x)) for x in m])
    phi = _phi(torch.from_numpy(m).double())
    for t in range(6):
        want = _phi(phi.sum(0) - phi[t])
        np.testing.assert_allclose(got[t].numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-6)


# --------------------------------------------------- generic check update


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_bp_cn_update_meets_jax(dtype):
    """peg_96_48 (dc 6–7, so CN padding slots too), messages within ±20
    with exact zeros, B=64: ``bp_cn_update`` lands in VN-slot layout
    (exact zeros in any VN padding slot); read back in CN-slot order every
    c2v is within CN_RTOL/CN_ATOL of the JAX update's, f32 out whatever
    the storage type."""
    jcode = jlib.load_named_code("peg_96_48")
    code = load_named_code("peg_96_48")
    rng = np.random.default_rng(41)
    v2c = np.clip(rng.normal(1.0, 6.0, (jcode.n * jcode.dv_max, 64)),
                  -20, 20).astype(dtype)
    v2c[rng.random(v2c.shape) < 0.02] = 0.0
    want = np.asarray(jbp.bp_cn_update(jcode, jnp.asarray(v2c)))
    c2v = bp_cn_update(code, torch.from_numpy(v2c))
    assert c2v.dtype == torch.float32 and want.dtype == np.float32
    assert c2v.shape == v2c.shape
    vn_pad = ~code.vn_mask.reshape(-1).numpy()
    assert (c2v.numpy()[vn_pad] == 0).all()
    assert np.isfinite(c2v.numpy()).all()
    got = gather_cn(code, c2v).numpy()
    want = want.reshape(code.m, code.dc_max, -1)
    mask = np.asarray(jcode.cn_mask)
    assert (~mask).any() and (want[~mask] == 0).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=CN_RTOL,
                               atol=CN_ATOL)
    # signs are exact
    np.testing.assert_array_equal(np.signbit(got[mask]),
                                  np.signbit(want[mask]))


def test_vn_update_with_clamp_equals_jax():
    """The clamped variable update has no transcendental: bit for bit."""
    jcode = jlib.load_named_code("peg_96_48")
    code = load_named_code("peg_96_48")
    rng = np.random.default_rng(42)
    c2v = rng.normal(0, 9, (jcode.m * jcode.dc_max, 32)).astype(np.float32)
    y = rng.normal(0, 8, (jcode.n, 32)).astype(np.float32)
    jv2c, jtot, jd = jminsum.vn_update(jcode, jnp.asarray(y),
                                       jnp.asarray(c2v), clamp=MAXLLR)
    msgs = gather_vn(code, torch.from_numpy(c2v))
    msgs = torch.where(code.vn_mask[:, :, None], msgs, torch.zeros_like(msgs))
    v2c, tot, d = vn_update(code, torch.from_numpy(y),
                            msgs.reshape(-1, 32), clamp=MAXLLR)
    np.testing.assert_array_equal(_bits(v2c.numpy()), _bits(np.asarray(jv2c)))
    np.testing.assert_array_equal(_bits(tot.numpy()), _bits(np.asarray(jtot)))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert np.abs(v2c.numpy()).max() == MAXLLR


# --------------------------------------------------------------- QC step


@pytest.mark.parametrize("name,storage", [
    ("qc_1008_504", (jnp.float16, torch.float16)),
    ("qc_ira_z8", (None, None)),
    ("pair_absent_z5", (None, None)),
    ("pair_absent_z5", (jnp.float16, torch.float16)),
])
def test_qc_bp_step_meets_jax(name, storage, small_qcs):
    """One qc_bp_step from the same planes and LLRs: totals within
    CN_RTOL/CN_ATOL (scaled by the column degree), new planes within the
    same, or within one f16 ulp when stored in f16; the rows of absent
    edges, which no check reads, are left out."""
    jqc, qc = _get(name, small_qcs)
    plan = qc_plan(qc, torch.device("cpu"))
    rng = np.random.default_rng(5)
    sdt = np.float16 if storage[0] is not None else np.float32
    planes = np.clip(rng.normal(1.0, 6.0, (plan.num_planes * qc.z, 32)),
                     -20, 20).astype(sdt)
    yb = np.clip(_llr(rng, 32, qc.n, 0.8).T, -20, 20).copy()
    carry = _jax_carry(jqc, planes)
    jv2c, jtot = jax.jit(jbpqc.qc_bp_step(jqc, storage_dtype=storage[0]))(
        carry, jnp.asarray(yb).reshape(jqc.nb, jqc.z, -1))
    v2c, tot = qc_bp_step(qc, storage_dtype=storage[1])(
        torch.from_numpy(planes), torch.from_numpy(yb))
    assert v2c.dtype == (storage[1] or torch.float32)
    np.testing.assert_allclose(
        tot.numpy(), np.asarray(jtot).reshape(qc.n, -1),
        rtol=CN_RTOL, atol=CN_ATOL * qc.dv_max)
    want = _carry_planes(jv2c).astype(np.float32)
    read = np.ones(len(want), bool)
    if plan.absent_rows is not None:
        read[plan.absent_rows.numpy()] = False
    atol = F16_ULP_AT_20 if storage[0] is not None else CN_ATOL * qc.dv_max
    np.testing.assert_allclose(v2c.float().numpy()[read], want[read],
                               rtol=CN_RTOL, atol=atol)
    assert np.abs(v2c.float().numpy()).max() <= MAXLLR
    # the check update alone: absent rows hold exact zeros
    c2v = qc_cn_bp(qc, torch.from_numpy(planes))
    assert c2v.dtype == torch.float32 and c2v.shape == planes.shape
    if plan.absent_rows is not None:
        assert (c2v[plan.absent_rows] == 0).all()


# ---------------------------------------------------------------- decodes


def _agreement(res, jres):
    same = (res.hard.numpy() == np.asarray(jres.hard)).all(axis=1)
    its = res.iterations.numpy() == np.asarray(jres.iterations)
    sat = res.satisfied.numpy() == np.asarray(jres.satisfied)
    return same.mean(), its.mean(), sat.mean()


@pytest.mark.parametrize("name,b,sigma,et,storage", [
    ("peg_96_48", 256, 0.75, False, (None, None)),
    ("peg_96_48", 256, 0.75, True, (jnp.float16, torch.float16)),
    ("peg_24_12", 256, 0.8, True, (None, None)),
    ("peg_1008_504", 64, 0.8318, False, (None, None)),
])
def test_decode_bp_agrees_with_jax(name, b, sigma, et, storage):
    """T=20 decodes (peg_1008_504 at 1.6 dB, full width): at least
    FRAME_AGREEMENT of the frames equal the JAX decoder's in every
    decision, in the iteration count and in the flag."""
    jcode, code = jlib.load_named_code(name), load_named_code(name)
    llr = _llr(np.random.default_rng(50), b, jcode.n, sigma)
    jres = jbp.decode_bp(jcode, jnp.asarray(llr), 20, early_termination=et,
                         storage_dtype=storage[0])
    res = decode_bp(code, torch.from_numpy(llr), 20, early_termination=et,
                    storage_dtype=storage[1])
    assert res.hard.dtype == torch.int32 and res.hard.shape == llr.shape
    for rate in _agreement(res, jres):
        assert rate >= FRAME_AGREEMENT, _agreement(res, jres)
    if et:
        assert res.iterations.min() < 20


@pytest.mark.parametrize("name,b,sigma,et,storage", [
    ("qc_1008_504", 128, 0.7943, True, (jnp.float16, torch.float16)),
    ("qc_ira_z8", 256, 0.75, False, (None, None)),
    ("pair_absent_z5", 256, 0.9, True, (None, None)),
])
def test_decode_bp_qc_agrees_with_jax_and_generic(name, b, sigma, et, storage,
                                                  small_qcs):
    """T=20 QC decodes (qc_1008_504 at 2.0 dB, full width, f16, early
    termination: the BASELINE configuration) agree with the JAX QC decoder
    and with the port's slot-array decoder on the expanded H at
    FRAME_AGREEMENT."""
    jqc, qc = _get(name, small_qcs)
    llr = _llr(np.random.default_rng(51), b, jqc.n, sigma)
    kw = dict(early_termination=et)
    jres = jbpqc.decode_bp_qc(jqc, jnp.asarray(llr), 20,
                              storage_dtype=storage[0], **kw)
    res = decode_bp_qc(qc, torch.from_numpy(llr), 20,
                       storage_dtype=storage[1], **kw)
    for rate in _agreement(res, jres):
        assert rate >= FRAME_AGREEMENT, _agreement(res, jres)
    gen = decode_bp(qc.to_code("cpu"), torch.from_numpy(llr), 20,
                    storage_dtype=storage[1], **kw)
    assert (gen.hard == res.hard).all(dim=1).float().mean() >= FRAME_AGREEMENT


def test_decode_bp_clamps_its_input_and_checks_shapes():
    """LLRs of ±300 would underflow u to 0 and poison the frame with NaN
    (log(s/0) = inf, then inf − inf); the input clamp keeps every decoder
    finite and equal to the JAX decisions on such frames.  T=0 decides on
    the channel."""
    jcode, code = jlib.load_named_code("peg_24_12"), load_named_code("peg_24_12")
    rng = np.random.default_rng(6)
    llr = (rng.choice([-300.0, 300.0], (32, 24), p=[0.1, 0.9])
           ).astype(np.float32)
    jres = jbp.decode_bp(jcode, jnp.asarray(llr), 5)
    res = decode_bp(code, torch.from_numpy(llr), 5)
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(jres.hard))
    np.testing.assert_array_equal(res.satisfied.numpy(),
                                  np.asarray(jres.satisfied))
    r0 = decode_bp(code, torch.from_numpy(llr), 0)
    assert torch.equal(r0.hard, torch.where(torch.from_numpy(llr) > 0, 1, -1
                                            ).to(torch.int32))
    with pytest.raises(ValueError, match="columns"):
        decode_bp(code, torch.zeros(2, 23), 3)
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8)
    with pytest.raises(ValueError, match="columns"):
        decode_bp_qc(QCCode.from_reference(jqc), torch.zeros(2, 95), 3)
    assert jmsqc.qc_block_uniform(jqc)
