"""The port's code layer against the JAX package's: same constructions,
same slot arrays, same QC structure, same alists."""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import code as jcode_mod
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu_torch.codes import (
    Code,
    QCCode,
    build_code,
    code_to_alist,
    load_named_code,
    load_named_qc,
    peg,
    qc_expand,
    qc_ira,
    qc_peg,
)
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

NAMES = ["qc_1008_504", "wifi_like_1944_972", "peg_96_48", "peg_24_12"]
QC_NAMES = ["qc_1008_504", "wifi_like_1944_972"]


def _jax_fields(jcode):
    return {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS} | {
        f: getattr(jcode, f) for f in _META_FIELDS
    }


def _alist_fields(a):
    """An alist's contents (the two packages' Alist classes differ)."""
    return (a.n, a.m, a.nlist, a.mlist, a.q, a.nvals, a.mvals)


def _assert_same_code(port: Code, jcode):
    for f in _META_FIELDS:
        assert getattr(port, f) == getattr(jcode, f), f
    for f in _ARRAY_FIELDS:
        want = np.asarray(getattr(jcode, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", NAMES)
def test_named_code_slot_arrays_equal_jax(name):
    _assert_same_code(load_named_code(name), jlib.load_named_code(name))


@pytest.mark.parametrize("name", NAMES)
def test_named_code_alist_equals_jax(name):
    jc = jlib.load_named_code(name)
    assert _alist_fields(code_to_alist(load_named_code(name))) == _alist_fields(
        jcode_mod.code_to_alist(jc)
    )


@pytest.mark.parametrize("name", QC_NAMES)
def test_named_qc_fields_equal_jax(name):
    port, jqc = load_named_qc(name), jlib.load_named_qc(name)
    for f in ("z", "mb", "nb", "base", "vn_blocks", "cn_blocks",
              "extra_edges", "minus_edges", "n", "m", "dv_max", "dc_max"):
        assert getattr(port, f) == getattr(jqc, f), f
    assert _alist_fields(port.to_alist()) == _alist_fields(jqc.to_alist())


@pytest.mark.parametrize("name", QC_NAMES)
def test_qc_from_reference_roundtrip(name):
    port = load_named_qc(name)
    assert QCCode.from_reference(jlib.load_named_qc(name)) == port
    assert QCCode.from_reference(port) == port
    assert hash(QCCode.from_reference(port)) == hash(port)


@pytest.mark.parametrize("name", NAMES)
def test_code_from_arrays_roundtrip(name):
    jc = jlib.load_named_code(name)
    port = Code.from_arrays(**_jax_fields(jc))
    _assert_same_code(port, jc)
    again = build_code(code_to_alist(port))
    _assert_same_code(again, jc)
    assert port.rate == jc.rate and port.k == jc.k


def test_small_constructions_equal_jax():
    from ldpcsimulation_tpu.codes import construct as jcon
    from ldpcsimulation_tpu.codes import qc as jqc_mod

    assert _alist_fields(peg(40, 20, 3, seed=5)) == _alist_fields(
        jcon.peg(40, 20, 3, seed=5, backend="python")
    )
    assert _alist_fields(peg(30, 15, [2, 3] * 15, seed=1)) == _alist_fields(
        jcon.peg(30, 15, [2, 3] * 15, seed=1)
    )
    base = np.array([[0, 3, -1], [2, -1, 1]])
    assert _alist_fields(qc_expand(base, 5)) == _alist_fields(
        jcon.qc_expand(base, 5)
    )
    assert QCCode.from_reference(jqc_mod.qc_peg(12, 6, 3, z=8)) == qc_peg(
        12, 6, 3, z=8
    )
    assert QCCode.from_reference(
        jqc_mod.qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3)
    ) == qc_ira(nb_info=4, mb=4, z=8, dv_info=3, seed=3)


def test_code_tensors_on_requested_device():
    c = load_named_code("peg_24_12", device="cpu")
    assert c.cn_from_vn.dtype == torch.int32 and c.cn_mask.dtype == torch.bool
    assert c.vn_from_cn.device.type == "cpu"


def test_unported_paths_raise_with_roadmap_pointer():
    """The paths that raised before the native PEG and the standard tables
    were ported now build the JAX package's codes; what is left to refuse
    names what there is."""
    from ldpcsimulation_tpu.codes import construct as jcon

    assert _alist_fields(peg(40, 20, 3, backend="native")) == _alist_fields(
        jcon.peg(40, 20, 3, backend="native"))
    assert _alist_fields(peg(4000, 2000, 3)) == _alist_fields(
        jcon.peg(4000, 2000, 3))
    assert load_named_code("dvbs2_1_2").n == 64800
    assert load_named_qc("wifi_1944_972").z == 81
    with pytest.raises(KeyError, match="have \\["):
        load_named_code("dvbs2_1_3")
    with pytest.raises(KeyError, match="no QC structure"):
        load_named_qc("peg_1008_504")
    with pytest.raises(ValueError, match="backend"):
        peg(40, 20, 3, backend="fortran")
