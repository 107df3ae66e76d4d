"""The port's DD-BMP decoders against the JAX package, bit for bit: hard
decisions, iteration counts (the 0-based break index, T when the syndrome
never checks out) and satisfied flags of the slot-array decoder and of the
QC decoder, the QC decoder against the slot-array one on the expanded H,
one round's memories, and the ``fresh=`` read-site select against a merged
initial state.  Inputs are ``quantize_no_zero`` samples, whose levels f32
does not represent: the fold order and the grouping of the memory update
show at the ulp there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import ddbmp as jdd
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu_torch.channel import quantize_no_zero
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_code
from ldpcsimulation_tpu_torch.decoders import (
    decode_ddbmp,
    decode_ddbmp_qc,
    qc_ddbmp_round,
    qc_plan,
)
from tests.test_torch_layered import PAIR_EDGES
from tests.test_torch_minsum import _assert_equal, _bits, _samples
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)


def _quantized(seed, b, n, sigma, ymax=1.5, nq=8.0):
    y = _samples(np.random.default_rng(seed), b, n, sigma=sigma)
    return quantize_no_zero(torch.from_numpy(y), ymax, nq).numpy()


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


# ------------------------------------------------------------- slot-array


@pytest.mark.parametrize("name,b,sigma,T,ymax", [
    ("peg_96_48", 128, 0.6, 30, 1.5),
    ("peg_24_12", 128, 0.7, 12, 1.5),
    ("peg_96_48", 64, 0.6, 1, 1.6),
    ("reg4_4000_2000", 8, 0.6383, 40, 1.6),
])
def test_decode_ddbmp_equals_jax(name, b, sigma, T, ymax):
    """peg_96_48 has VN and CN padding slots; reg4_4000_2000 at 3.9 dB and
    Ymax 1.6 is the validated operating point, full width."""
    jcode, code = jlib.load_named_code(name), load_named_code(name)
    yq = _quantized(60, b, jcode.n, sigma, ymax)
    jres = jdd.decode_ddbmp(jcode, jnp.asarray(yq), T)
    res = decode_ddbmp(code, torch.from_numpy(yq), T)
    assert res.hard.dtype == torch.int32 and res.hard.shape == yq.shape
    assert res.iterations.dtype == torch.int32
    _assert_equal(res, jres)
    if T >= 12:  # both outcomes, and a spread of break indices
        assert res.satisfied.any()
        assert len(res.iterations.unique()) > 2
    # the break index is 0-based and T marks "never satisfied"
    assert (res.iterations[~res.satisfied] == T).all()
    assert (res.iterations[res.satisfied] < T).all()


def test_decode_ddbmp_runs_one_round_on_a_codeword():
    """The syndrome is checked after each round: a clean codeword costs one
    round and reports break index 0; T=0 runs none and reports 0 == T."""
    code = load_named_code("peg_24_12")
    y = torch.full((4, 24), 0.9375)
    res = decode_ddbmp(code, y, 5)
    assert (res.iterations == 0).all() and res.satisfied.all()
    assert (res.hard == 1).all()
    res0 = decode_ddbmp(code, y, 0)
    assert (res0.iterations == 0).all() and not res0.satisfied.any()
    jres0 = jdd.decode_ddbmp(jlib.load_named_code("peg_24_12"),
                             jnp.asarray(y.numpy()), 0)
    _assert_equal(res0, jres0)
    with pytest.raises(ValueError, match="columns"):
        decode_ddbmp(code, torch.zeros(2, 23), 3)


# --------------------------------------------------------------------- QC


@pytest.mark.parametrize("name,b,sigma,T", [
    ("qc_1008_504", 64, 0.6683, 40),
    ("qc_peg_z8", 128, 0.6, 20),
    ("qc_ira_z8", 128, 0.6, 20),
    ("pair_absent_z5", 128, 0.7, 15),
])
def test_decode_ddbmp_qc_equals_jax_and_generic(name, b, sigma, T, small_qcs):
    """The QC decoder equals the JAX QC decoder, the JAX slot-array decoder
    on the expanded H and the port's slot-array decoder (qc_1008_504 at
    full width, 3.5 dB)."""
    jqc, qc = _get(name, small_qcs)
    yq = _quantized(61, b, jqc.n, sigma)
    res = decode_ddbmp_qc(qc, torch.from_numpy(yq), T)
    assert res.hard.dtype == torch.int32
    _assert_equal(res, jdd.decode_ddbmp_qc(jqc, jnp.asarray(yq), T))
    _assert_equal(res, jdd.decode_ddbmp(jqc.to_code(), jnp.asarray(yq), T))
    gen = decode_ddbmp(qc.to_code("cpu"), torch.from_numpy(yq), T)
    for f in ("hard", "iterations", "satisfied"):
        assert torch.equal(getattr(res, f), getattr(gen, f)), f
    assert res.satisfied.any() and len(res.iterations.unique()) > 2


def _jax_mem(jqc, mem):
    """Port memories [P*z, B] -> the JAX [nb, dv_max, z, B] planes (zeros
    in the slots an irregular block lacks)."""
    z, b = jqc.z, mem.shape[-1]
    out = np.zeros((jqc.nb, jqc.dv_max, z, b), mem.dtype)
    p = 0
    for bj, blocks in enumerate(jqc.vn_blocks):
        deg = len(blocks)
        out[bj, :deg] = mem[p * z:(p + deg) * z].reshape(deg, z, b)
        p += deg
    return jnp.asarray(out)


def _port_mem(jqc, jmem):
    jmem = np.asarray(jmem)
    b = jmem.shape[-1]
    return np.concatenate([
        jmem[bj, :len(blocks)].reshape(-1, b)
        for bj, blocks in enumerate(jqc.vn_blocks)
    ])


@pytest.mark.parametrize("name", ["qc_ira_z8", "pair_absent_z5"])
@pytest.mark.parametrize("with_fresh", [False, True])
def test_qc_ddbmp_round_equals_jax(name, with_fresh, small_qcs):
    """One round from the same accumulated memories: memories (but for the
    rows of absent edges, which nothing reads) and int8 decisions equal the
    JAX round's bits; with ``fresh=``, the marked lanes read as freshly
    initialized, the same as merging them into the memories first."""
    jqc, qc = _get(name, small_qcs)
    plan = qc_plan(qc, torch.device("cpu"))
    rng = np.random.default_rng(9)
    b = 48
    yq = _quantized(62, b, jqc.n, 0.7).T.copy()  # [N, B]
    mem = (yq[plan.row_col.numpy()]
           + rng.integers(-6, 7, (plan.num_planes * qc.z, b))
           ).astype(np.float32)
    fresh = rng.random(b) < 0.3 if with_fresh else None
    cn_plan, vn_plan = jmsqc.qc_slot_plan(jqc)
    jmem2, jd = jdd.qc_ddbmp_round(
        jqc, cn_plan, vn_plan, _jax_mem(jqc, mem),
        jnp.asarray(yq).reshape(jqc.nb, jqc.z, b),
        fresh=None if fresh is None else jnp.asarray(fresh))
    mem2, d = qc_ddbmp_round(
        qc, torch.from_numpy(mem), torch.from_numpy(yq),
        fresh=None if fresh is None else torch.from_numpy(fresh))
    assert d.dtype == torch.int8 and np.asarray(jd).dtype == np.int8
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd).reshape(qc.n, b))
    read = np.ones(len(mem), bool)
    if plan.absent_rows is not None:
        read[plan.absent_rows.numpy()] = False
    np.testing.assert_array_equal(_bits(mem2.numpy()[read]),
                                  _bits(_port_mem(jqc, jmem2)[read]))
    if with_fresh:
        merged = np.where(fresh, yq[plan.row_col.numpy()], mem)
        mem3, d3 = qc_ddbmp_round(qc, torch.from_numpy(merged),
                                  torch.from_numpy(yq))
        assert torch.equal(mem3, mem2) and torch.equal(d3, d)
        assert fresh.any() and not fresh.all()


def test_decode_ddbmp_qc_guards():
    qc = QCCode.from_reference(jqc_mod.qc_peg(12, 6, 3, z=8))
    with pytest.raises(ValueError, match="columns"):
        decode_ddbmp_qc(qc, torch.zeros(2, 95), 3)
