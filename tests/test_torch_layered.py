"""The port's row-layered decoders and the tuple-state loop against the JAX
package.  Layered min-sum is exact: one step's posterior and stored check
messages bit for bit, and whole decodes (hard decisions, iteration counts,
satisfied flags) for the three variants, both storage types and both loop
forms, on qc_1008_504 at full width, wifi_1944_972, a pair + absent-edge
code, tied samples, and the real DVB-S2 structure.  Layered BP meets the JAX
step at a stated tolerance (``exp``/``log`` differ by ulps between XLA and
PyTorch) and the JAX decode by frame agreement.  JAX inputs are f32 arrays:
``tests/conftest.py`` enables x64, and a float64 input would make the JAX
side compute in f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import base as jbase
from ldpcsimulation_tpu.decoders import bp_layered as jbpl
from ldpcsimulation_tpu.decoders import minsum_layered as jmsl
from ldpcsimulation_tpu_torch.channel import quantize_no_zero
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_qc
from ldpcsimulation_tpu_torch.decoders import (
    assert_layered_compatible,
    decode_bp_layered_qc,
    decode_minsum_layered_qc,
    layered_l0,
    qc_bp_layered_step,
    qc_minsum_layered_step,
    qc_plan,
    run_flooding,
)
from tests.test_torch_minsum import (
    F16,
    F32,
    _assert_equal,
    _bits,
    _samples,
    _tied_messages,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

PAIR_EDGES = [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2),
              (1, 0, 2), (1, 1, 2), (1, 2, 4)]

#: layered BP against the JAX step: |Δ| <= ATOL + RTOL·|want| on every
#: posterior and stored message (f32; XLA's and PyTorch's exp/log differ by
#: ulps, and log(num/den) near num == den amplifies them absolutely)
BP_RTOL, BP_ATOL = 2e-5, 2e-5
#: share of frames whose T=20 layered-BP decisions must equal the JAX
#: decoder's in every bit
BP_FRAME_AGREEMENT = 0.97


@pytest.fixture(scope="module")
def small_qcs():
    return {
        "qc_peg_z8": jqc_mod.qc_peg(12, 6, 3, z=8),
        "qc_ira_z8": jqc_mod.qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3),
        "pair_absent_z5": jqc_mod.build_qc_code_edges(
            PAIR_EDGES, 5, 2, 3, minus_edges=((1, 2, 4, 1),)),
    }


def _get(name, small_qcs):
    jqc = small_qcs.get(name) or jlib.load_named_qc(name)
    return jqc, QCCode.from_reference(jqc)


def _jax_state(jqc, q, L):
    """Port state (q [N, B], L per layer [dc*z, B]) -> the JAX tuples."""
    b = q.shape[-1]
    return (
        tuple(jnp.asarray(q.reshape(jqc.nb, jqc.z, b))),
        tuple(jnp.asarray(l.reshape(-1, jqc.z, b)) for l in L),
    )


def _random_state(rng, qc, b, ldtype, tied):
    plan = qc_plan(qc, torch.device("cpu"))
    if tied:
        q = _tied_messages(rng, (qc.n, b), np.float32)
        L = [_tied_messages(rng, (lp.dc * qc.z, b), ldtype)
             for lp in plan.layers]
    else:
        q = rng.normal(1.0, 3.0, (qc.n, b)).astype(np.float32)
        L = [rng.normal(0.0, 2.0, (lp.dc * qc.z, b)).astype(ldtype)
             for lp in plan.layers]
    return q, L


# ------------------------------------------------------------- run_flooding


@pytest.mark.parametrize("et", [False, True])
@pytest.mark.parametrize("T", [0, 1, 6])
def test_run_flooding_equals_jax(et, T):
    """A toy tuple-state decoder (the state drifts towards +1 at a
    per-frame rate; a frame is satisfied when every entry is positive): the
    loop's decisions, round counts and flags equal the JAX loop's,
    frames already satisfied at the start included."""
    rng = np.random.default_rng(4)
    x0 = rng.normal(-0.5, 1.0, (5, 16)).astype(np.float32)
    x0[:, :3] = np.abs(x0[:, :3]) + 0.1  # satisfied before any round
    rate = rng.uniform(0.0, 0.6, 16).astype(np.float32)
    rate[-2:] = 0.0  # never satisfied

    def run(xp, where, loop, x, r):
        return loop(
            (x, (r,)),
            lambda st: (st[0] + st[1][0], st[1]),
            lambda st: where(st[0] > 0, 1, -1),
            lambda d: (d > 0).all(0),
            T, et, 16,
        )

    jd, jit_, jdone = run(jnp, jnp.where, jbase.run_flooding,
                          jnp.asarray(x0), jnp.asarray(rate))
    d, it, done = run(torch, torch.where, run_flooding,
                      torch.from_numpy(x0), torch.from_numpy(rate))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit_))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    assert it.dtype == torch.int32 and done.dtype == torch.bool
    if et and T == 6:
        assert (it.numpy()[:3] == 0).all() and not done.numpy()[-2:].any()
        assert 0 < it.numpy()[3:-2].min() and done.numpy()[:3].all()


# ----------------------------------------------------- layered min-sum step


@pytest.mark.parametrize("name,variant,kw,storage,tied", [
    ("qc_1008_504", "plain", {}, F16, True),
    ("qc_ira_z8", "normalized", dict(alpha=0.8), F16, True),
    ("qc_ira_z8", "offset", dict(delta=0.15), F32, True),
    ("qc_ira_z8", "offset", dict(delta=0.15), F16, False),
    ("pair_absent_z5", "plain", {}, F32, True),
    ("pair_absent_z5", "normalized", dict(alpha=1.25), F16, False),
])
def test_minsum_layered_step_equals_jax(name, variant, kw, storage, tied,
                                        small_qcs):
    """One pass over all layers from the same state: the posterior and every
    layer's stored messages equal the JAX step's bits."""
    jqc, qc = _get(name, small_qcs)
    rng = np.random.default_rng(31)
    ldt = np.float16 if storage[0] is not None else np.float32
    q, L = _random_state(rng, qc, 32, ldt, tied)
    # alpha and delta enter the jit as arguments, as in the JAX decoder
    # (closed over as constants, XLA turns ``/ alpha`` into a multiply by
    # the reciprocal, an ulp away from the division)
    jstep = jax.jit(lambda st, alpha, delta: jmsl.qc_minsum_layered_step(
        jqc, variant, alpha, delta, storage_dtype=storage[0])(st))
    (jq, jL), jtot = jstep(_jax_state(jqc, q, L), kw.get("alpha", 1.0),
                           kw.get("delta", 0.0))
    state = (torch.from_numpy(q), tuple(torch.from_numpy(l) for l in L))
    (q2, L2), tot = qc_minsum_layered_step(
        qc, variant, storage_dtype=storage[1], **kw)(state)
    assert torch.equal(state[0], torch.from_numpy(q)), "input state changed"
    assert tot is q2 and q2.dtype == torch.float32
    np.testing.assert_array_equal(
        _bits(q2.numpy()), _bits(np.asarray(jtot).reshape(qc.n, -1)))
    for bi, (l2, jl) in enumerate(zip(L2, jL)):
        assert l2.dtype == (storage[1] or torch.float32)
        np.testing.assert_array_equal(
            _bits(l2.numpy()), _bits(np.asarray(jl).reshape(l2.shape)),
            err_msg=f"layer {bi}")


def test_layer_plan_tables(small_qcs):
    """The pair + absent-edge code's layer tables: physical order, −1 and
    the absent list at the removed edge, the pair's rows column for
    column."""
    jqc, qc = _get("pair_absent_z5", small_qcs)
    plan = qc_plan(qc, torch.device("cpu"))
    z = qc.z
    l0, l1 = plan.layers
    assert (l0.dc, l1.dc) == (4, 3)
    assert l0.absent is None and l0.single_rows.tolist() == list(range(10, 20))
    assert l0.cols[l0.pair_first].tolist() == l0.cols[l0.pair_second].tolist()
    assert l0.pair_first.tolist() == list(range(5))
    # layer 1: the edge (bi=1, bj=2, shift 4) misses row offset 1
    assert l1.single_rows is None and l1.pair_first is None
    assert l1.absent.tolist() == [2 * z + 1]
    scan = l1.scan_rows.numpy()
    assert scan[1, 2] == -1 and (scan >= 0).sum() == 3 * z - 1
    assert l1.cols.tolist()[2 * z:] == [2 * z + (r + 4) % z for r in range(z)]
    assert plan.fold_phys is not plan.fold
    assert qc_plan(load_named_qc("qc_1008_504"),
                   torch.device("cpu")).fold_phys is qc_plan(
        load_named_qc("qc_1008_504"), torch.device("cpu")).fold


def test_layered_rejects_absent_edge_in_pair():
    jqc = jqc_mod.build_qc_code_edges(
        [(0, 0, 1), (0, 0, 3), (0, 1, 0), (1, 1, 2), (1, 0, 0)],
        5, 2, 2, minus_edges=((0, 0, 3, 2),))
    qc = QCCode.from_reference(jqc)
    for fn in (assert_layered_compatible, qc_minsum_layered_step,
               qc_bp_layered_step):
        with pytest.raises(NotImplementedError, match="inside a pair"):
            fn(qc)
    with pytest.raises(NotImplementedError):
        jmsl.decode_minsum_layered_qc(jqc, jnp.ones((1, qc.n), jnp.float32), 2)
    with pytest.raises(ValueError, match="variant"):
        qc_minsum_layered_step(load_named_qc("qc_1008_504"), "bogus")
    with pytest.raises(ValueError, match="columns"):
        decode_minsum_layered_qc(qc, torch.zeros(2, qc.n - 1), 2)


# -------------------------------------------------- layered min-sum decodes


def _assert_layered_equal(jqc, qc, y, T, variant, kw, storage, et):
    jres = jmsl.decode_minsum_layered_qc(
        jqc, jnp.asarray(y, jnp.float32), T, variant=variant,
        early_termination=et, storage_dtype=storage[0], **kw)
    res = decode_minsum_layered_qc(
        qc, torch.from_numpy(y), T, variant=variant, early_termination=et,
        storage_dtype=storage[1], **kw)
    assert res.hard.dtype == torch.int32
    assert res.iterations.dtype == torch.int32
    assert res.hard.shape == y.shape
    _assert_equal(res, jres)
    return res


@pytest.mark.parametrize("variant,kw,storage,et", [
    ("plain", {}, F16, False),
    ("plain", {}, F32, True),
    ("plain", {}, F16, True),
    ("normalized", dict(alpha=1.25), F16, True),
    ("offset", dict(delta=0.15), F16, False),
])
def test_minsum_layered_flagship_full_width_equals_jax(variant, kw, storage,
                                                       et):
    """qc_1008_504 at full width, B=64, T=10, 2.0 dB."""
    jqc, qc = _get("qc_1008_504", {})
    y = _samples(np.random.default_rng(100), 64, jqc.n)
    res = _assert_layered_equal(jqc, qc, y, 10, variant, kw, storage, et)
    if variant == "plain":
        assert res.satisfied.any() and not res.satisfied.all()
    if et:
        assert res.iterations.min() < 10


@pytest.mark.parametrize("variant,kw,storage,et", [
    ("normalized", dict(alpha=1.25), F16, True),
    ("plain", {}, F32, False),
])
def test_minsum_layered_wifi_equals_jax(variant, kw, storage, et):
    """The 802.11n (1944, 972) code, B=32, T=6, 1.5 dB."""
    jqc, qc = _get("wifi_1944_972", {})
    y = _samples(np.random.default_rng(11), 32, jqc.n, sigma=0.8414)
    _assert_layered_equal(jqc, qc, y, 6, variant, kw, storage, et)


@pytest.mark.parametrize("name,variant,kw,storage,et,tied", [
    ("qc_peg_z8", "plain", {}, F32, True, False),
    ("qc_ira_z8", "plain", {}, F16, False, True),
    ("qc_ira_z8", "normalized", dict(alpha=0.8), F32, True, False),
    ("qc_ira_z8", "offset", dict(delta=0.15), F16, True, True),
    ("pair_absent_z5", "plain", {}, F32, True, False),
    ("pair_absent_z5", "plain", {}, F16, False, True),
    ("pair_absent_z5", "offset", dict(delta=0.15), F16, True, True),
    ("pair_absent_z5", "normalized", dict(alpha=1.25), F32, False, False),
])
def test_minsum_layered_small_codes_equal_jax(name, variant, kw, storage, et,
                                              tied, small_qcs):
    """Small regular, irregular and pair + absent-edge codes, B=96, T=8, on
    Gaussian samples and on tied samples (zeros, −0.0 and exact ties)."""
    jqc, qc = _get(name, small_qcs)
    rng = np.random.default_rng(7)
    y = (_tied_messages(rng, (96, jqc.n), np.float32) + np.float32(0.5)
         if tied else _samples(rng, 96, jqc.n, sigma=0.7))
    _assert_layered_equal(jqc, qc, y, 8, variant, kw, storage, et)
    _assert_layered_equal(jqc, qc, y, 0, variant, kw, storage, et)


def test_minsum_layered_dvbs2_tied_equals_jax():
    """dvbs2_1_2_qc (eight pairs, one absent edge), offset variant on
    quantize_no_zero samples — eight levels, so the scan meets exact ties in
    almost every check, where the walk order of a pair's two slots could
    show — B=4, f16 storage: one iteration from the decoder's initial
    state, posterior and stored messages equal in every bit.
    The JAX step runs op by op, not under ``jit``: XLA takes many minutes to
    compile its 90 unrolled layers on the CPU."""
    jqc, qc = _get("dvbs2_1_2_qc", {})
    b = 4
    y = _samples(np.random.default_rng(3), b, jqc.n, sigma=0.8)
    y = quantize_no_zero(torch.from_numpy(y), 2.0, 8.0).numpy()
    assert len(np.unique(y)) == 8
    kw = dict(variant="offset", delta=0.15)
    jstep = jmsl.qc_minsum_layered_step(jqc, storage_dtype=jnp.float16, **kw)
    step = qc_minsum_layered_step(qc, storage_dtype=torch.float16, **kw)
    state = (torch.from_numpy(y.T.copy()),
             layered_l0(qc, b, torch.float16, torch.device("cpu")))
    jstate = _jax_state(jqc, y.T.copy(), [l.numpy() for l in state[1]])
    for it in range(1):
        state, tot = step(state)
        jstate, jtot = jstep(jstate)
        np.testing.assert_array_equal(
            _bits(tot.numpy()), _bits(np.asarray(jtot).reshape(qc.n, b)),
            err_msg=f"iteration {it}")
        for bi, (l2, jl) in enumerate(zip(state[1], jstate[1])):
            np.testing.assert_array_equal(
                _bits(l2.numpy()), _bits(np.asarray(jl).reshape(l2.shape)),
                err_msg=f"iteration {it}, layer {bi}")


# ----------------------------------------------------------------- layered BP


@pytest.mark.parametrize("name", ["qc_1008_504", "qc_ira_z8",
                                  "pair_absent_z5"])
def test_bp_layered_step_meets_jax(name, small_qcs):
    """One pass from the same state (posteriors up to ±30, so the clamp of
    the check input is active while the posterior keeps the unclamped
    extrinsic): posterior and stored messages within BP_RTOL/BP_ATOL."""
    jqc, qc = _get(name, small_qcs)
    rng = np.random.default_rng(17)
    plan = qc_plan(qc, torch.device("cpu"))
    q = rng.normal(2.0, 12.0, (qc.n, 32)).astype(np.float32)
    L = [rng.normal(0.0, 3.0, (lp.dc * qc.z, 32)).astype(np.float32)
         for lp in plan.layers]
    (jq, jL), jtot = jax.jit(jbpl.qc_bp_layered_step(jqc))(
        _jax_state(jqc, q, L))
    (q2, L2), tot = qc_bp_layered_step(qc)(
        (torch.from_numpy(q), tuple(torch.from_numpy(l) for l in L)))
    assert np.asarray(jtot).dtype == np.float32 and np.abs(q).max() > 25
    np.testing.assert_allclose(
        q2.numpy(), np.asarray(jtot).reshape(qc.n, -1),
        rtol=BP_RTOL, atol=BP_ATOL)
    for l2, jl, lp in zip(L2, jL, plan.layers):
        np.testing.assert_allclose(
            l2.numpy(), np.asarray(jl).reshape(l2.shape),
            rtol=BP_RTOL, atol=BP_ATOL)
        if lp.absent is not None:  # stores an exact zero, on both sides
            assert (l2.numpy()[lp.absent.numpy()] == 0).all()
            assert (np.asarray(jl).reshape(l2.shape)[lp.absent.numpy()]
                    == 0).all()


@pytest.mark.parametrize("name,b,snr_sigma,et", [
    ("qc_1008_504", 128, 0.7943, True),
    ("qc_ira_z8", 256, 0.75, False),
    ("pair_absent_z5", 256, 0.9, True),
])
def test_bp_layered_decode_agrees_with_jax(name, b, snr_sigma, et, small_qcs):
    """T=20 decodes on LLRs 2y/σ²: at least BP_FRAME_AGREEMENT of the frames
    equal the JAX decoder's in every decision; with early termination the
    iteration counts of those frames agree at the same rate."""
    jqc, qc = _get(name, small_qcs)
    y = _samples(np.random.default_rng(23), b, jqc.n, sigma=snr_sigma)
    llr = (2.0 * y / np.float32(snr_sigma) ** 2).astype(np.float32)
    jres = jbpl.decode_bp_layered_qc(jqc, jnp.asarray(llr), 20,
                                     early_termination=et)
    res = decode_bp_layered_qc(qc, torch.from_numpy(llr), 20,
                               early_termination=et)
    same = (res.hard.numpy() == np.asarray(jres.hard)).all(axis=1)
    assert same.mean() >= BP_FRAME_AGREEMENT, same.mean()
    it_same = res.iterations.numpy() == np.asarray(jres.iterations)
    assert it_same.mean() >= BP_FRAME_AGREEMENT, it_same.mean()
    assert (res.satisfied.numpy()
            == np.asarray(jres.satisfied)).mean() >= BP_FRAME_AGREEMENT
    assert torch.isfinite(res.hard.float()).all()


def test_layered_l0_shapes():
    qc = load_named_qc("wifi_1944_972")
    L = layered_l0(qc, 3, torch.float16, torch.device("cpu"))
    assert len(L) == qc.mb
    for l, blocks in zip(L, qc.cn_blocks):
        assert l.shape == (len(blocks) * qc.z, 3) and l.dtype == torch.float16
        assert not l.any()
