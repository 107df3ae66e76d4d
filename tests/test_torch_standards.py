"""The port's standard tables, registry, GF(2) encoder and QC detection
against the JAX package's: the same tables element for element, the same
slot arrays for every registered name, encoder words in the null space of
H, and the same detected structures.  Everything here is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import encode as jenc
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu.codes import qc_detect as jdet
from ldpcsimulation_tpu.codes import standards as jstd
from ldpcsimulation_tpu.codes.alist import Alist as JAlist
from ldpcsimulation_tpu.decoders.minsum import decode_minsum as jdecode
from ldpcsimulation_tpu.decoders.minsum_qc import decode_minsum_qc as jdecode_qc
from ldpcsimulation_tpu_torch.codes import (
    NAMED_CODES,
    QC_NAMES,
    Alist,
    QCCode,
    build_code,
    detect_qc,
    gf2_rref,
    load_named_code,
    load_named_qc,
    make_encoder,
    permuted_decoder,
    random_codewords,
)
from ldpcsimulation_tpu_torch.codes import standards as std
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import decode_minsum, decode_minsum_qc
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)


def _alist_fields(a):
    return (a.n, a.m, a.nlist, a.mlist, a.q, a.nvals, a.mvals)


def _dense(code):
    h = np.zeros((code.m, code.n), np.uint8)
    cn_vn, cn_mask = np.asarray(code.cn_vn), np.asarray(code.cn_mask)
    for r in range(code.m):
        h[r, cn_vn[r][cn_mask[r]]] = 1
    return h


def test_tables_equal_jax():
    assert std.WIFI_648_RATE12_Z27 == jstd.WIFI_648_RATE12_Z27
    assert std.WIFI_1944_RATE12_Z81 == jstd.WIFI_1944_RATE12_Z81
    assert std.DVBS2_RATE12_ADDRESSES == jstd.DVBS2_RATE12_ADDRESSES
    assert std.DVBS2_RATE12_Q == jstd.DVBS2_RATE12_Q
    assert len(std.DVBS2_RATE12_ADDRESSES) == 90


def test_registry_has_every_jax_name():
    assert sorted(NAMED_CODES) == sorted(jlib.NAMED_CODES)
    for name in QC_NAMES:
        jlib.load_named_qc(name)  # the JAX package has a QC view too
    for name in set(NAMED_CODES) - set(QC_NAMES):
        with pytest.raises(KeyError):
            load_named_qc(name)


@pytest.mark.parametrize("name", sorted(jlib.NAMED_CODES))
def test_named_code_equals_jax(name):
    port, jc = load_named_code(name), jlib.load_named_code(name)
    for f in _META_FIELDS:
        assert getattr(port, f) == getattr(jc, f), f
    for f in _ARRAY_FIELDS:
        want = np.asarray(getattr(jc, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", QC_NAMES)
def test_named_qc_equals_jax(name):
    port, jqc = load_named_qc(name), jlib.load_named_qc(name)
    assert QCCode.from_reference(jqc) == port
    assert port.extra_edges == tuple(jqc.extra_edges)
    assert port.minus_edges == tuple(jqc.minus_edges)


def test_dvbs2_views_equal_jax():
    det, jd = std.dvbs2_rate12_qc(), jstd.dvbs2_rate12_qc()
    np.testing.assert_array_equal(det.row_perm, jd.row_perm)
    np.testing.assert_array_equal(det.col_perm, jd.col_perm)
    assert len(det.qc.extra_edges) == 8 and len(det.qc.minus_edges) == 1
    assert _alist_fields(std.dvbs2_rate12_alist()) == _alist_fields(
        jstd.dvbs2_rate12_alist())


@pytest.mark.parametrize("z", [27, 81])
def test_wifi_encode_equals_jax_and_satisfies_h(z):
    base = std.WIFI_648_RATE12_Z27 if z == 27 else std.WIFI_1944_RATE12_Z81
    code = std.wifi_648_rate12() if z == 27 else std.wifi_1944_rate12()
    info = np.random.default_rng(5).integers(0, 2, (4, 12 * z), np.uint8)
    cw = std.wifi_encode(base, z, info)
    np.testing.assert_array_equal(cw, jstd.wifi_encode(base, z, info))
    np.testing.assert_array_equal(cw[:, :12 * z], info)
    assert not ((_dense(code) @ cw.T) % 2).any()


def test_dvbs2_encode_equals_jax_and_satisfies_h():
    info = np.random.default_rng(3).integers(0, 2, (2, 32400), np.uint8)
    cw = std.dvbs2_rate12_encode(info)
    np.testing.assert_array_equal(cw, jstd.dvbs2_rate12_encode(info))
    al = std.dvbs2_rate12_alist()
    rows = np.concatenate([np.full(len(c), r) for r, c in enumerate(al.mlist)])
    cols = np.concatenate([np.asarray(c) for c in al.mlist])
    syn = np.zeros((al.m, 2), np.uint8)
    np.bitwise_xor.at(syn, rows, cw.T[cols])
    assert not syn.any()
    # the QC view's words are the same words with the columns relabeled
    det = std.dvbs2_rate12_qc()
    qc_code = load_named_code("dvbs2_1_2_qc")
    d = torch.as_tensor(1 - 2 * cw[:, det.col_perm].T.astype(np.int32))
    from ldpcsimulation_tpu_torch.decoders import check_satisfied

    assert bool(check_satisfied(qc_code, d).all())


# ------------------------------------------------------------- the encoder


@pytest.mark.parametrize("name", ["peg_96_48", "qc_1008_504", "wifi_648_324"])
def test_encoder_equals_jax(name):
    code, jc = load_named_code(name), jlib.load_named_code(name)
    enc, jenc_ = make_encoder(code), jenc.make_encoder(jc)
    assert (enc.n, enc.k, enc.rank) == (jenc_.n, jenc_.k, jenc_.rank)
    np.testing.assert_array_equal(enc.pivot_cols.numpy(),
                                  np.asarray(jenc_.pivot_cols))
    np.testing.assert_array_equal(enc.free_cols.numpy(),
                                  np.asarray(jenc_.free_cols))
    np.testing.assert_array_equal(enc.gen_t.numpy(), np.asarray(jenc_.gen_t))
    info = np.random.default_rng(1).integers(0, 2, (6, enc.k), np.uint8)
    np.testing.assert_array_equal(enc.encode(torch.from_numpy(info)).numpy(),
                                  np.asarray(jenc_.encode(jnp.asarray(info))))
    cw = random_codewords(enc, torch.Generator().manual_seed(4), 16)
    assert cw.dtype == torch.uint8 and cw.shape == (16, code.n)
    assert not ((_dense(code) @ cw.numpy().T.astype(np.int64)) % 2).any()
    assert code.true_k() == jc.true_k() and code.true_rate() == jc.true_rate()
    assert code.rate == jc.rate == (code.n - code.m) / code.n


def test_true_k_counts_rank_and_rref_equals_jax():
    h = np.array([[1, 1, 0, 1], [0, 1, 1, 0], [1, 0, 1, 1]], np.uint8)
    for got, want in zip(gf2_rref(h), jenc.gf2_rref(h)):
        np.testing.assert_array_equal(got, want)
    # row 2 = row 0 + row 1: rank 2, so k = 2 where n - m says 1
    from ldpcsimulation_tpu_torch.codes import from_dense

    code = build_code(from_dense(h))
    assert code.k == 1 and code.true_k() == 2 and code.true_rate() == 0.5


# ----------------------------------------------------------- QC detection


def _as_port(a):
    return Alist(n=a.n, m=a.m, nlist=a.nlist, mlist=a.mlist)


def _assert_detected_equal(alist):
    det, jd = detect_qc(_as_port(alist)), jdet.detect_qc(alist)
    assert (det is None) == (jd is None)
    if det is None:
        return None
    assert QCCode.from_reference(jd.qc) == det.qc
    np.testing.assert_array_equal(det.row_perm, jd.row_perm)
    np.testing.assert_array_equal(det.col_perm, jd.col_perm)
    # expand(qc) == H[row_perm][:, col_perm], edge for edge
    exp = det.qc.to_alist()
    back = {(int(det.row_perm[r]), int(det.col_perm[c]))
            for r, lst in enumerate(exp.mlist) for c in lst}
    assert back == {(r, c) for r, lst in enumerate(alist.mlist) for c in lst}
    return det


def _interleaved_rows(qc, z):
    alist = qc.to_alist()
    m, n = alist.m, alist.n
    q = m // z
    imap = (np.arange(m) % q) * z + np.arange(m) // q
    mlist = [alist.mlist[int(imap[i])] for i in range(m)]
    nlist = [[] for _ in range(n)]
    for r, lst in enumerate(mlist):
        for c in lst:
            nlist[c].append(r)
    return JAlist(n=n, m=m, nlist=nlist, mlist=mlist)


@pytest.mark.parametrize("case", ["contiguous", "wifi_648", "interleaved",
                                  "unstructured"])
def test_detect_qc_equals_jax(case):
    if case == "contiguous":
        alist, z = jqc_mod.qc_peg(8, 4, 3, z=16, seed=5).to_alist(), 16
    elif case == "wifi_648":
        alist, z = jstd.wifi_648_rate12_qc().to_alist(), 27
    elif case == "interleaved":
        alist, z = _interleaved_rows(jqc_mod.qc_peg(8, 4, 3, z=12, seed=3),
                                     12), 12
    else:
        alist, z = jlib.load_named_code("peg_96_48"), None
        from ldpcsimulation_tpu.codes.code import code_to_alist

        alist = code_to_alist(alist)
    det = _assert_detected_equal(alist)
    assert (det is None) if z is None else det.qc.z == z
    if case == "interleaved":
        assert (det.row_perm != np.arange(alist.m)).any()


def test_permuted_decoder_equals_jax():
    """A relabeled QC code decodes through the wrapper as the JAX wrapper
    does, and equals the slot-array decode of the natural-order H."""
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8, seed=7)
    perm = np.random.default_rng(3).permutation(jqc.n)
    base = jqc.to_alist()
    inv = np.argsort(perm)
    nlist = [base.nlist[int(perm[v])] for v in range(jqc.n)]
    mlist = [sorted(int(inv[c]) for c in lst) for lst in base.mlist]
    shuffled = JAlist(n=jqc.n, m=jqc.m, nlist=nlist, mlist=mlist)
    # column relabeling is not a layout detect_qc tries: the natural one is
    det = detect_qc(_as_port(base))
    jd = jdet.detect_qc(base)
    y = np.random.default_rng(9).normal(0.9, 0.7, (24, jqc.n)).astype(
        np.float32)
    key = jax.random.key(0)
    res = permuted_decoder(det, lambda yq, k: decode_minsum_qc(
        det.qc, yq, 6, early_termination=True))(torch.from_numpy(y), None)
    jres = jdet.permuted_decoder(jd, lambda yq, k: jdecode_qc(
        jd.qc, yq, 6, early_termination=True))(jnp.asarray(y), key)
    np.testing.assert_array_equal(res.hard.numpy(), np.asarray(jres.hard))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    # a detected structure with a column permutation: decode in QC order,
    # answer in natural order, equal to the generic decode of the natural H
    pdet = dataclasses.replace(det, col_perm=inv[det.col_perm])
    gen = build_code(_as_port(shuffled))
    yn = y  # natural order of the relabeled H
    got = permuted_decoder(pdet, lambda yq, k: decode_minsum_qc(
        pdet.qc, yq, 6, early_termination=True))(torch.from_numpy(yn), None)
    want = decode_minsum(gen, torch.from_numpy(yn), 6,
                         early_termination=True)
    assert torch.equal(got.hard, want.hard)
    assert torch.equal(got.satisfied, want.satisfied)
    np.testing.assert_array_equal(
        want.hard.numpy(),
        np.asarray(jdecode(jlib.build_code(shuffled), jnp.asarray(yn), 6,
                           early_termination=True).hard))
