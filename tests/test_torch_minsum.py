"""The port's slot-array min-sum decoder against the JAX package, bit for
bit: kernel B1's twin in its generic form (the 64-slot range included)
against the Pallas CN scan and the XLA CN update, one step from the same
state, and whole decodes (hard decisions, iteration counts, satisfied
flags) on peg_96_48 and peg_1008_504 at full width for every variant, both
storage types and both loop forms.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders.base import gather_cn as jgather_cn
from ldpcsimulation_tpu.kernels.minsum_pallas import minsum_cn_scan_pallas
from ldpcsimulation_tpu_torch.codes import load_named_code
from ldpcsimulation_tpu_torch.decoders import (
    decode_minsum,
    gather_cn,
    gather_vn,
    minsum_cn_update,
    minsum_plan,
    minsum_step,
    vn_update,
)
from ldpcsimulation_tpu_torch.kernels.minsum import minsum_cn_scan
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

F16 = (jnp.float16, torch.float16)
F32 = (None, None)
FIELDS = ("hard", "iterations", "satisfied")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int16 if a.dtype == np.float16 else np.int32)


def _tied_messages(rng, shape, dtype):
    """Messages with many exact ties, zeros and −0.0."""
    v = np.round(rng.normal(size=shape) * 4.0) / 2.0
    v[rng.random(shape) < 0.05] = -0.0
    return v.astype(dtype)


def _samples(rng, b, n, sigma=0.7943282347242815, loc=1.0):
    return (loc + sigma * rng.standard_normal((b, n))).astype(np.float32)


def _assert_equal(res, jres):
    for f in FIELDS:
        want = torch.from_numpy(np.array(getattr(jres, f)))
        got = getattr(res, f)
        assert torch.equal(got, want.to(got.dtype)), f


# --------------------------------------------------------------- kernel B1


def test_twin_at_dc63_equals_pallas_on_highrate_slice():
    """highrate_4376_282 has dc_max 63 (the kernel's 64-slot instance):
    the twin on its first 24 checks equals minsum_cn_scan_pallas in
    interpret mode, tied messages, B=16."""
    jcode = jlib.load_named_code("highrate_4376_282")
    assert jcode.dc_max == 63
    rng = np.random.default_rng(63)
    v2c = _tied_messages(rng, (jcode.n * jcode.dv_max, 16), np.float32)
    rows = slice(0, 24)
    cn_from_vn = np.asarray(jcode.cn_from_vn)[rows]
    mask = np.asarray(jcode.cn_mask)[rows]
    assert mask.sum(axis=1).max() >= 62
    cn_rows = np.where(mask, cn_from_vn, -1).astype(np.int32)
    c2v = minsum_cn_scan(torch.from_numpy(v2c), torch.from_numpy(cn_rows))
    got = c2v.numpy()[cn_from_vn]  # [24, 63, B] in CN-slot order
    g = jgather_cn(jcode, jnp.asarray(v2c))[rows]
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(minsum_cn_scan_pallas(g, jnp.asarray(mask)))
    np.testing.assert_array_equal(_bits(got[mask]), _bits(pal[mask]))
    assert (pal[~mask] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("variant,kw", [
    ("plain", {}), ("normalized", dict(alpha=1.25)),
    ("offset", dict(delta=0.15)),
])
def test_cn_update_equals_jax(dtype, variant, kw):
    """minsum_cn_update lands in VN-slot layout with zero padding; read
    back in CN-slot order it is the JAX CN update with its post-op."""
    jcode = jlib.load_named_code("wifi_648_324")  # padding on both sides
    code = load_named_code("wifi_648_324")
    rng = np.random.default_rng(5)
    v2c = _tied_messages(rng, (code.n * code.dv_max, 32), dtype)
    c2v = minsum_cn_update(code, torch.from_numpy(v2c), variant, **kw)
    assert c2v.dtype == torch.float32 and c2v.shape == v2c.shape
    got = gather_cn(code, c2v).numpy()
    out = jminsum.minsum_cn_update(jcode, jnp.asarray(v2c))
    if variant == "normalized":
        out = jminsum.apply_normalization(out, kw["alpha"])
    elif variant == "offset":
        out = jminsum.apply_offset(out, kw["delta"])
    want = np.asarray(out).reshape(code.m, code.dc_max, -1)
    mask = np.asarray(jcode.cn_mask)
    np.testing.assert_array_equal(_bits(got[mask]),
                                  _bits(want[mask].astype(np.float32)))
    vn_mask = code.vn_mask.reshape(-1).numpy()
    assert (c2v.numpy()[~vn_mask] == 0).all() and (~vn_mask).any()
    # gather_vn of the CN-layout messages is the VN layout back
    cn_layout = torch.from_numpy(want.astype(np.float32).reshape(
        code.m * code.dc_max, -1))
    back = gather_vn(code, cn_layout).reshape(-1, 32).numpy()
    np.testing.assert_array_equal(_bits(back[vn_mask]),
                                  _bits(c2v.numpy()[vn_mask]))


def test_vn_update_and_step_equal_jax():
    """One step from the same state: v2c' bits (f16 store) and totals."""
    jcode = jlib.load_named_code("peg_96_48")
    code = load_named_code("peg_96_48")
    rng = np.random.default_rng(6)
    v2c = _tied_messages(rng, (code.n * code.dv_max, 32), np.float16)
    y_t = _samples(rng, 32, code.n).T.copy()
    jstep = jminsum.minsum_step(jcode, storage_dtype=jnp.float16)
    jv2c, jtot = jstep(jnp.asarray(v2c), jnp.asarray(y_t))
    v2c_new, tot = minsum_step(code, storage_dtype=torch.float16)(
        torch.from_numpy(v2c), torch.from_numpy(y_t))
    assert v2c_new.dtype == torch.float16
    np.testing.assert_array_equal(_bits(tot.numpy()), _bits(np.asarray(jtot)))
    np.testing.assert_array_equal(_bits(v2c_new.numpy()),
                                  _bits(np.asarray(jv2c)))
    c2v = minsum_cn_update(code, torch.from_numpy(v2c))
    _, _, d = vn_update(code, torch.from_numpy(y_t), c2v)
    assert d.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.where(tot.numpy() > 0, 1, -1))


def test_plan_names_every_real_slot_once():
    code = load_named_code("wifi_648_324")  # VN degrees 2 to 12
    plan = minsum_plan(code, torch.device("cpu"))
    rows = plan.cn_rows.numpy()
    real = np.flatnonzero(code.vn_mask.reshape(-1).numpy())
    assert sorted(rows[rows >= 0].tolist()) == real.tolist()
    assert plan.vn_pad is not None and minsum_plan(
        load_named_code("peg_96_48"), "cpu").vn_pad is None


# ----------------------------------------------------------- whole decodes


def _decode_pair(name, y, T, variant, kw, storage, et):
    jres = jminsum.decode_minsum(
        jlib.load_named_code(name), jnp.asarray(y), T, variant=variant,
        early_termination=et, storage_dtype=storage[0], **kw)
    res = decode_minsum(
        load_named_code(name), torch.from_numpy(y), T, variant=variant,
        early_termination=et, storage_dtype=storage[1], **kw)
    assert res.hard.dtype == torch.int32 and res.hard.shape == y.shape
    _assert_equal(res, jres)
    return res


@pytest.mark.parametrize("variant,kw", [
    ("plain", {}), ("normalized", dict(alpha=1.25)),
    ("normalized", dict(alpha=0.8)), ("offset", dict(delta=0.15)),
])
@pytest.mark.parametrize("storage", [F16, F32], ids=["f16", "f32"])
@pytest.mark.parametrize("et", [False, True], ids=["fixed", "et"])
def test_decode_peg_1008_504_full_width_equals_jax(variant, kw, storage, et):
    """peg_1008_504 (the reference's PEGReg504x1008 class), B=48, T=10,
    2.0 dB; the fixed-point variants on quantize_no_zero samples."""
    y = _samples(np.random.default_rng(100), 48, 1008)
    if variant != "plain":
        from ldpcsimulation_tpu_torch.channel import quantize_no_zero

        y = quantize_no_zero(torch.from_numpy(y), 2.0, 8.0).numpy()
    res = _decode_pair("peg_1008_504", y, 10, variant, kw, storage, et)
    if variant == "plain":  # the operating point exercises both outcomes
        assert res.satisfied.any() and not res.satisfied.all()


@pytest.mark.parametrize("variant,kw,storage,et", [
    ("plain", {}, F32, False),
    ("plain", {}, F16, True),
    ("normalized", dict(alpha=1.25), F32, True),
    ("offset", dict(delta=0.15), F16, False),
])
def test_decode_peg_96_48_equals_jax(variant, kw, storage, et):
    y = _samples(np.random.default_rng(7), 96, 96, sigma=0.7)
    _decode_pair("peg_96_48", y, 8, variant, kw, storage, et)


def test_decode_tied_samples_and_guards():
    """Samples on a coarse grid (ties and zeros everywhere, −0.0 too) and
    T = 0; a wrong width raises."""
    rng = np.random.default_rng(11)
    y = _tied_messages(rng, (32, 96), np.float32)
    for T, et in ((0, False), (0, True), (6, False), (6, True)):
        _decode_pair("peg_96_48", y, T, "plain", {}, F16, et)
    with pytest.raises(ValueError, match="columns"):
        decode_minsum(load_named_code("peg_96_48"), torch.zeros(2, 95), 3)
    with pytest.raises(ValueError, match="variant"):
        decode_minsum(load_named_code("peg_96_48"), torch.zeros(2, 96), 3,
                      variant="bogus")
