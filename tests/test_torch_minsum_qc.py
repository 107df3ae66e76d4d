"""The port's min-sum path against the JAX package, bit for bit: the plain
twin of kernel B1 against the Pallas CN scan (interpret mode) and the XLA
CN update, one QC iteration from the same message state, and whole decodes
(hard decisions, iteration counts, satisfied flags) on the flagship code at
full width and on small regular and irregular QC codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu.decoders.base import gather_cn
from ldpcsimulation_tpu.kernels.minsum_pallas import minsum_cn_scan_pallas
from ldpcsimulation_tpu_torch.codes import QCCode
from ldpcsimulation_tpu_torch.decoders import (
    decode_minsum_qc,
    qc_check_satisfied,
    qc_minsum_step,
    qc_plan,
    qc_ragged_init,
)
from ldpcsimulation_tpu_torch.kernels.minsum import minsum_cn_scan
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

SIGMA_2DB = 0.7943282347242815  # snr_to_sigma(2.0, 0.5)
F16 = (jnp.float16, torch.float16)
F32 = (None, None)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int16 if a.dtype == np.float16 else np.int32)


def _tied_messages(rng, shape, dtype):
    """Messages with many exact ties, zeros and −0.0 (the tie-break and
    sgn(0) hazards)."""
    v = np.round(rng.normal(size=shape) * 4.0) / 2.0
    v[rng.random(shape) < 0.05] = -0.0
    return v.astype(dtype)


@pytest.fixture(scope="module")
def small_qcs():
    return {
        "qc_peg_z8": jqc_mod.qc_peg(12, 6, 3, z=8),
        "qc_ira_z8": jqc_mod.qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3),
    }


def _samples(rng, b, n, sigma=SIGMA_2DB):
    return (1.0 + sigma * rng.standard_normal((b, n))).astype(np.float32)


# --------------------------------------------------------------- kernel B1


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_plain_cn_scan_equals_pallas_and_xla(dtype):
    """Twin of B1 == minsum_cn_scan_pallas (interpret mode) == the XLA
    minsum_cn_update on peg_96_48's gathered messages (dc 6–7, so absent
    slots too), B=128."""
    jcode = jlib.load_named_code("peg_96_48")
    rng = np.random.default_rng(21)
    v2c = _tied_messages(rng, (jcode.n * jcode.dv_max, 128), dtype)
    cn_from_vn = np.asarray(jcode.cn_from_vn)
    mask = np.asarray(jcode.cn_mask)
    cn_rows = np.where(mask, cn_from_vn, -1).astype(np.int32)
    c2v = minsum_cn_scan(torch.from_numpy(v2c), torch.from_numpy(cn_rows))
    got = c2v.numpy()[cn_from_vn]  # [M, dc_max, B] in CN-slot order

    xla = np.asarray(jminsum.minsum_cn_update(jcode, jnp.asarray(v2c)))
    xla = xla.reshape(jcode.m, jcode.dc_max, -1).astype(np.float32)
    np.testing.assert_array_equal(_bits(got[mask]), _bits(xla[mask]))
    if dtype == np.float32:
        g = gather_cn(jcode, jnp.asarray(v2c))
        with pltpu.force_tpu_interpret_mode():
            pal = np.asarray(minsum_cn_scan_pallas(g, jcode.cn_mask))
        np.testing.assert_array_equal(_bits(got[mask]), _bits(pal[mask]))
        assert (pal[~mask] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("variant,kw", [
    ("normalized", dict(alpha=0.8)),
    ("normalized", dict(alpha=1.25)),
    ("offset", dict(delta=0.15)),
])
def test_plain_cn_scan_variants_equal_jax(dtype, variant, kw):
    """The variant post-op runs in the storage precision, with alpha/delta
    rounded to it, exactly as the JAX decoder's weakly typed scalars."""
    jcode = jlib.load_named_code("peg_96_48")
    rng = np.random.default_rng(22)
    v2c = _tied_messages(rng, (jcode.n * jcode.dv_max, 64), dtype)
    cn_from_vn = np.asarray(jcode.cn_from_vn)
    mask = np.asarray(jcode.cn_mask)
    cn_rows = np.where(mask, cn_from_vn, -1).astype(np.int32)
    c2v = minsum_cn_scan(torch.from_numpy(v2c), torch.from_numpy(cn_rows),
                         variant, **kw)
    got = c2v.numpy()[cn_from_vn]

    out = jminsum.minsum_cn_update(jcode, jnp.asarray(v2c))
    if variant == "normalized":
        out = jminsum.apply_normalization(out, kw["alpha"])
    else:
        out = jminsum.apply_offset(out, kw["delta"])
    want = np.asarray(out).reshape(jcode.m, jcode.dc_max, -1)
    np.testing.assert_array_equal(
        _bits(got[mask]), _bits(want[mask].astype(np.float32))
    )


def test_cn_scan_rejects_bad_inputs():
    v2c = torch.zeros((8, 4))
    rows = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        minsum_cn_scan(v2c, rows, "bogus")
    with pytest.raises(ValueError, match="int32"):
        minsum_cn_scan(v2c, rows.long())
    with pytest.raises(ValueError, match="f16/f32"):
        minsum_cn_scan(v2c.double(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        minsum_cn_scan(torch.zeros((4, 8)).t(), rows)
    with pytest.raises(ValueError, match="unsupported device"):
        minsum_cn_scan(v2c.to("meta"), rows.to("meta"))


# --------------------------------------------------------------- one step


def _jax_carry(jqc, planes):
    """Port planes [P*z, B] -> the JAX carry (stacked or ragged)."""
    z, b = jqc.z, planes.shape[-1]
    out, p = [], 0
    for bj in range(jqc.nb):
        deg = len(jqc.vn_blocks[bj])
        out.append(jnp.asarray(planes[p * z:(p + deg) * z].reshape(deg, z, b)))
        p += deg
    return jnp.stack(out) if jmsqc.qc_block_uniform(jqc) else tuple(out)


def _carry_planes(carry):
    leaves = carry if isinstance(carry, tuple) else list(carry)
    b = leaves[0].shape[-1]
    return np.concatenate([np.asarray(x).reshape(-1, b) for x in leaves])


@pytest.mark.parametrize("name,variant,kw", [
    ("qc_1008_504", "plain", {}),
    ("qc_ira_z8", "plain", {}),
    ("qc_ira_z8", "normalized", dict(alpha=0.8)),
    ("qc_ira_z8", "offset", dict(delta=0.15)),
])
def test_one_step_equals_jax(name, variant, kw, small_qcs):
    """One qc_minsum_step from the same v2c state (JAX carry -> port planes):
    equal v2c' bits and totals, f16 storage."""
    jqc = small_qcs.get(name) or jlib.load_named_qc(name)
    qc = QCCode.from_reference(jqc)
    rng = np.random.default_rng(5)
    num_planes = sum(len(v) for v in jqc.vn_blocks)
    planes = _tied_messages(rng, (num_planes * jqc.z, 64), np.float16)
    yb = _samples(rng, 64, jqc.n).T.copy()  # [N, B]

    jstep = jax.jit(jmsqc.qc_minsum_step(jqc, variant, storage_dtype=jnp.float16, **kw))
    jv2c, jtot = jstep(_jax_carry(jqc, planes), jnp.asarray(yb).reshape(jqc.nb, jqc.z, -1))
    v2c, tot = qc_minsum_step(qc, variant, storage_dtype=torch.float16, **kw)(
        torch.from_numpy(planes), torch.from_numpy(yb)
    )
    assert v2c.dtype == torch.float16 and v2c.shape == planes.shape
    np.testing.assert_array_equal(_bits(v2c.numpy()), _bits(_carry_planes(jv2c)))
    np.testing.assert_array_equal(
        _bits(tot.numpy()), _bits(np.asarray(jtot).reshape(jqc.n, -1))
    )


def test_ragged_init_and_plan_tables(small_qcs):
    jqc = small_qcs["qc_ira_z8"]
    qc = QCCode.from_reference(jqc)
    yb = np.arange(qc.n * 3, dtype=np.float32).reshape(qc.n, 3)
    got = qc_ragged_init(qc, torch.from_numpy(yb), torch.float32).numpy()
    want = _carry_planes(jmsqc.qc_ragged_init(jqc, jnp.asarray(yb).reshape(qc.nb, qc.z, 3), jnp.float32))
    np.testing.assert_array_equal(got, want)
    plan = qc_plan(qc, torch.device("cpu"))
    rows = plan.cn_rows.numpy()
    # every message row is read and written by exactly one check slot
    assert sorted(rows[rows >= 0].tolist()) == list(range(plan.num_planes * qc.z))


def test_check_satisfied_equals_jax(small_qcs):
    jqc = small_qcs["qc_ira_z8"]
    qc = QCCode.from_reference(jqc)
    rng = np.random.default_rng(8)
    d = np.where(rng.random((qc.n, 32)) < 0.97, 1, -1).astype(np.int32)
    d[:, :4] = 1  # the all-(+1) word is a codeword
    got = qc_check_satisfied(qc, torch.from_numpy(d)).numpy()
    want = np.asarray(jmsqc.qc_check_satisfied(jqc, jnp.asarray(d).reshape(qc.nb, qc.z, -1)))
    np.testing.assert_array_equal(got, want)
    assert got[:4].all() and not got.all()


# ----------------------------------------------------------- whole decodes


def _assert_decode_equal(jqc, y, T, variant, kw, storage, et):
    jres = jmsqc.decode_minsum_qc(
        jqc, jnp.asarray(y), T, variant=variant, early_termination=et,
        storage_dtype=storage[0], **kw,
    )
    res = decode_minsum_qc(
        QCCode.from_reference(jqc), torch.from_numpy(y), T, variant=variant,
        early_termination=et, storage_dtype=storage[1], **kw,
    )
    want = {f: torch.from_numpy(np.array(getattr(jres, f)))
            for f in ("hard", "iterations", "satisfied")}
    assert res.hard.dtype == torch.int32 and res.iterations.dtype == torch.int32
    assert res.hard.shape == (y.shape[0], jqc.n)
    for f, w in want.items():
        assert torch.equal(getattr(res, f), w.to(getattr(res, f).dtype)), f
    return res


@pytest.mark.parametrize("variant,kw,storage,et", [
    ("plain", {}, F16, False),
    ("plain", {}, F32, False),
    ("plain", {}, F16, True),
    ("normalized", dict(alpha=1.25), F16, False),
    ("normalized", dict(alpha=0.8), F16, False),
    ("offset", dict(delta=0.15), F16, False),
])
def test_decode_flagship_full_width_equals_jax(variant, kw, storage, et):
    """qc_1008_504 at full width, B=64, T=10, 2.0 dB."""
    jqc = jlib.load_named_qc("qc_1008_504")
    y = _samples(np.random.default_rng(100), 64, jqc.n)
    res = _assert_decode_equal(jqc, y, 10, variant, kw, storage, et)
    if variant == "plain":  # the operating point exercises both outcomes
        assert res.satisfied.any() and not res.satisfied.all()


@pytest.mark.parametrize("name,variant,kw,storage,et", [
    ("qc_peg_z8", "plain", {}, F32, True),
    ("qc_peg_z8", "normalized", dict(alpha=1.25), F32, False),
    ("qc_ira_z8", "plain", {}, F16, False),
    ("qc_ira_z8", "plain", {}, F32, True),
    ("qc_ira_z8", "normalized", dict(alpha=0.8), F32, True),
    ("qc_ira_z8", "offset", dict(delta=0.15), F16, True),
])
def test_decode_small_codes_equal_jax(name, variant, kw, storage, et,
                                      small_qcs):
    jqc = small_qcs[name]
    y = _samples(np.random.default_rng(7), 96, jqc.n, sigma=0.7)
    _assert_decode_equal(jqc, y, 8, variant, kw, storage, et)


def test_decode_zero_iterations_and_guards(small_qcs):
    jqc = small_qcs["qc_ira_z8"]
    y = _samples(np.random.default_rng(9), 16, jqc.n)
    _assert_decode_equal(jqc, y, 0, "plain", {}, F32, False)
    _assert_decode_equal(jqc, y, 0, "plain", {}, F32, True)
    qc = QCCode.from_reference(jqc)
    with pytest.raises(ValueError, match="columns"):
        decode_minsum_qc(qc, torch.from_numpy(y[:, :-1]), 3)
    pair = jqc_mod.build_qc_code_edges([(0, 0, 1), (0, 0, 3), (1, 1, 0)], 8, 2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_minsum_qc(QCCode.from_reference(pair), torch.zeros(2, 16), 3)
