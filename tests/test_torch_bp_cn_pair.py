"""Kernel B8, the sum-product check update (``csrc/bp_cn_pair.cu``), on the
CPU: the CUDA kernel runs only on the card (``chip_smoke.py`` holds it to
its twin there, bit for bit), so here every BP decoder's route to it (QC,
slot array, stratified, layered) on its plain twin is pinned bit for bit
to the body it had before the kernel (``tests/frozen_bp.py``), the
kernel's per-check arithmetic (named slots only, the suffix fold run
backwards, the sign from a parity) written out in torch against the twin
bit for bit, the decoders' choice between the kernel and the twin, and the
wrapper's checks and its choice of instance."""

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch.codes import (
    code_to_alist,
    load_named_code,
    load_named_qc,
    qc_peg,
    stratify,
)
from ldpcsimulation_tpu_torch.codes.qc import build_qc_code_edges
from ldpcsimulation_tpu_torch.decoders import (
    bp_cn_update,
    qc_bp_layered_step,
    qc_cn_bp,
    qc_plan,
    stratified_bp_step,
    stratified_plan,
)
from ldpcsimulation_tpu_torch.decoders import bp as dbp
from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
    stratified_zero_pad,
)
from ldpcsimulation_tpu_torch.kernels import bp as kbp
from ldpcsimulation_tpu_torch.kernels import build
from tests import frozen_bp
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

F16, F32 = torch.float16, torch.float32
B = 64  # a multiple of the CPU's vector width: exp and log take no tail


def _messages(rng, rows, dtype, batch=B):
    """Stored v2c planes: clamped to ±20, 2 % +0.0 and 2 % -0.0 (a zero
    input makes its check's other outputs zero, signed by the others)."""
    v = np.clip(1.0 + 6.0 * rng.normal(size=(rows, batch)), -20.0, 20.0)
    u = rng.random(v.shape)
    v[u < 0.02] = 0.0
    v[u > 0.98] = -0.0
    return torch.from_numpy(v.astype(np.float32)).to(dtype)


def _same_bits(got, want):
    return got.dtype == want.dtype == F32 and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


CODES = {
    "qc_1008_504": lambda: load_named_qc("qc_1008_504"),
    # circulant pairs and an absent edge
    "dvbs2_1_2_qc": lambda: load_named_qc("dvbs2_1_2_qc"),
    # dc_max 10: past the first slot cap (the 16-slot instance)
    "qc_peg_dc10": lambda: qc_peg(20, 6, 3, z=16, seed=1),
    # dc 6–7: CN padding slots
    "peg_96_48": lambda: load_named_code("peg_96_48"),
    # irregular on both sides: VN padding slots too
    "wifi_648_324": lambda: load_named_code("wifi_648_324"),
    # its greedy strata: 6 × 10 rows, 10 groups, absent slots
    "peg_96_48_stratified": lambda: stratify(
        code_to_alist(load_named_code("peg_96_48"))),
    # a two-circulant pair in layer 0, an absent edge in layer 1
    "pair_absent_z5": lambda: build_qc_code_edges(
        [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2), (1, 0, 2), (1, 1, 2),
         (1, 2, 4)], 5, 2, 3, minus_edges=((1, 2, 4, 1),)),
}


@pytest.fixture(scope="module")
def codes():
    return {name: make() for name, make in CODES.items()}


def _route_and_body(form, code, dtype, rng):
    """(the route's outputs, its frozen body's) on the same inputs, f16 or
    f32 messages (the layered step's stored messages; its posterior is
    f32, the type it computes in)."""
    if form == "qc":
        plan = qc_plan(code, "cpu")
        b = 4 if plan.num_planes * code.z > 10**5 else B  # dvbs2_1_2_qc
        v2c = _messages(rng, plan.num_planes * code.z, dtype, b)
        return [qc_cn_bp(code, v2c)], [frozen_bp.qc_cn_bp(code, v2c)]
    if form == "slots":
        v2c = _messages(rng, code.n * code.dv_max, dtype)
        return [bp_cn_update(code, v2c)], [frozen_bp.bp_cn_update(code, v2c)]
    if form == "stratified":
        plan = stratified_plan(code, "cpu")
        v2c = stratified_zero_pad(code, _messages(
            rng, code.mb * code.kg * code.w, dtype).view(
                code.mb, code.kg, code.w, B))
        yg = 8.0 * _messages(rng, code.kg * code.w, F32).view(
            code.kg, code.w, B)
        if plan.col_pad is not None:
            yg = torch.where(plan.col_pad, 0.0, yg)
        got = stratified_bp_step(code, storage_dtype=dtype)(v2c, yg)
        return list(got), list(frozen_bp.stratified_bp_step(code, v2c, yg,
                                                            dtype))
    plan = qc_plan(code, "cpu")
    q = 1.5 * _messages(rng, code.n, F32)  # posteriors past the ±20 clip
    L = tuple(_messages(rng, lp.dc * code.z, dtype) for lp in plan.layers)
    (q2, L2), _ = qc_bp_layered_step(code)((q, L))
    want_q, want_L = frozen_bp.qc_bp_layered_step(code, q, L)
    return [q2, *L2], [want_q, *want_L]


@pytest.mark.parametrize("form,name", [
    *[pytest.param("qc", n, id=n) for n in
      ("qc_1008_504", "dvbs2_1_2_qc", "qc_peg_dc10")],
    pytest.param("slots", "peg_96_48", id="slots-peg_96_48"),
    pytest.param("slots", "wifi_648_324", id="slots-wifi_648_324"),
    pytest.param("stratified", "peg_96_48_stratified",
                 id="stratified-peg_96_48"),
    pytest.param("layered", "pair_absent_z5", id="layered-pair_absent_z5"),
])
@pytest.mark.parametrize("dtype", [F16, F32])
def test_qc_cn_bp_equals_the_pre_change_body(codes, form, name, dtype):
    """On CPU tensors each BP decoder's route to B8 (its twin here) gives
    the body it had before the kernel bit for bit (int32 views: signed
    zeros too), f32 from either storage type, zeros in the rows no check
    names: ``qc_cn_bp``, the slot array's ``bp_cn_update`` (now in VN-slot
    layout, the old body's c2v gathered back), the stratified step and the
    layered step."""
    code = codes[name]
    build.LAUNCHES.clear()
    got, want = _route_and_body(form, code, dtype,
                                np.random.default_rng(21))
    assert not build.LAUNCHES  # the twin counts no launch
    assert len(got) == len(want)
    for g, w in zip(got, want):  # f16: the stratified step's stored messages
        bits = torch.int16 if g.dtype == F16 else torch.int32
        assert g.dtype == w.dtype and torch.equal(g.view(bits), w.view(bits))
    if form not in ("qc", "slots"):
        return
    c2v = got[0]
    assert _same_bits(c2v, want[0])
    if form == "qc" and qc_plan(code, "cpu").absent_rows is not None:
        assert name == "dvbs2_1_2_qc"
        rows = qc_plan(code, "cpu").absent_rows
        assert (c2v[rows].view(torch.int32) == 0).all()
    if form == "slots" and not bool(code.vn_mask.all()):
        assert name == "wifi_648_324"
        assert (c2v[~code.vn_mask.reshape(-1)].view(torch.int32) == 0).all()
    zeros = c2v == 0
    assert zeros.any() and (zeros & torch.signbit(c2v)).any()


@pytest.mark.parametrize("width", [64, 65])
def test_the_decoders_take_b8_up_to_its_widest_table(monkeypatch, width):
    """Every BP decoder's check update (``decoders/bp.py::_bp_check``)
    hands its table whole to ``bp_cn_pair``, whatever its width: B8 on the
    card takes up to 64 slots and refuses a wider table by name
    (``bp_instance``), never the twin silently; the CPU runs the twin."""
    calls = []

    def pair(v2c, cn_rows):
        calls.append(cn_rows.shape[1])
        return kbp.bp_cn_pair_plain(v2c, cn_rows)

    monkeypatch.setattr(dbp, "bp_cn_pair", pair)
    rng = np.random.default_rng(65)
    table = torch.from_numpy(
        rng.permutation(3 * width).astype(np.int32)).view(3, width)
    gone = int(table[1, 5])
    table[1, 5] = -1  # its row is named by no check
    v2c = _messages(rng, 3 * width, F16)
    got = dbp._bp_check(v2c, table, torch.tensor([gone]))
    want = kbp.bp_cn_pair_plain(v2c, table)
    want[gone] = 0.0
    assert _same_bits(got, want)
    assert calls == [width]


# ---------------------------------------------------- the kernel's arithmetic


def _kernel_model(v2c, cn_rows):
    """csrc/bp_cn_pair.cu per check, all lanes at once: the named slots
    compacted in slot order, u and the sign bits, the prefix pairs kept,
    the suffix fold run backwards emitting each output, the sign of an
    output the parity of the others' sign bits."""
    c2v = torch.full(v2c.shape, float("nan"))
    for c in range(cn_rows.shape[0]):
        named = cn_rows[c][cn_rows[c] >= 0].long()
        m = v2c[named].float()
        u = torch.exp(-m.abs())
        neg = ~(m >= 0)
        parity = neg.sum(dim=0) % 2
        s, d = torch.ones(m.shape[1]), torch.zeros(m.shape[1])
        pre = []
        for k in range(len(named)):
            pre.append((s, d))
            s, d = s + d * u[k], d + s * u[k]
        s, d = torch.ones(m.shape[1]), torch.zeros(m.shape[1])
        for k in reversed(range(len(named))):
            ps, pd = pre[k]
            num = ps * s + pd * d
            den = ps * d + pd * s
            mag = torch.log(num / den)
            odd = (parity ^ neg[k].long()) == 1
            c2v[named[k]] = torch.where(odd, -1.0, 1.0) * mag
            s, d = s + d * u[k], d + s * u[k]
    return c2v


def _sentinel_table(rng):
    """12 checks of 40 slots with 1-12 named at random slots, among them
    degree-1 checks (den = 0: an infinite output) and an empty one."""
    degs = [1, 12, 5, 1, 0, 7, 12, 2, 3, 9, 1, 6]
    rows = rng.permutation(sum(degs)).astype(np.int32)
    table = np.full((len(degs), 40), -1, np.int32)
    k = 0
    for c, deg in enumerate(degs):
        at = np.sort(rng.choice(40, deg, replace=False))
        table[c, at] = rows[k:k + deg]
        k += deg
    return torch.from_numpy(table), k


@pytest.mark.parametrize("table", ["sentinel40", "qc_1008_504",
                                   "qc_peg_dc10"])
@pytest.mark.parametrize("dtype", [F16, F32])
def test_kernel_arithmetic_equals_plain(codes, table, dtype):
    """Folding only the named slots (an absent slot's u = 0 is neutral bit
    for bit), emitting on the backward fold and signing by parity give the
    twin's outputs bit for bit on every named row."""
    rng = np.random.default_rng(8)
    if table == "sentinel40":
        cn_rows, rows = _sentinel_table(rng)
    else:
        qc = codes[table]
        plan = qc_plan(qc, "cpu")
        cn_rows, rows = plan.cn_rows, plan.num_planes * qc.z
    v2c = _messages(rng, rows, dtype)
    named = cn_rows[cn_rows >= 0].long()
    want = kbp.bp_cn_pair_plain(v2c, cn_rows)[named]
    got = _kernel_model(v2c, cn_rows)[named]
    assert _same_bits(got, want)
    if table == "sentinel40":  # the degree-1 checks' outputs
        assert torch.isinf(want).any()


# --------------------------------------------------- the wrapper's contract


def test_wrapper_checks_its_inputs():
    """Wrong storage types, a non-int32 or misshapen table, a table on
    another device, a strided view and a device that is neither the CPU
    nor CUDA raise; the CPU runs the twin."""
    cn_rows = torch.tensor([[0, 1, -1], [2, 3, 4]], dtype=torch.int32)
    v2c = torch.ones(5, 8)
    assert kbp.bp_cn_pair(v2c, cn_rows).dtype == F32
    for bad in (v2c.double(), v2c.bfloat16(), v2c.int(), torch.ones(5, 8, 1),
                torch.ones(5, 16)[:, ::2]):
        with pytest.raises(ValueError):
            kbp.bp_cn_pair(bad, cn_rows)
    for bad in (cn_rows.long(), cn_rows.reshape(-1), cn_rows.t()):
        with pytest.raises(ValueError):
            kbp.bp_cn_pair(v2c, bad)
    with pytest.raises(ValueError, match="on meta"):
        kbp.bp_cn_pair_plain(v2c, cn_rows.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kbp.bp_cn_pair(v2c.to("meta"), cn_rows.to("meta"))


@pytest.mark.parametrize("dc_max,batch,dtype,v2c_off,c2v_off,want", [
    (7, 32768, F16, 0, 0, (8, 4)),     # the main path: 8-byte loads
    (8, 32768, F32, 0, 0, (8, 4)),     # 16-byte loads, float4 stores
    (0, 32768, F16, 0, 0, (8, 4)),
    (9, 32768, F16, 0, 0, (16, 2)),    # past the first cap
    (16, 32768, F32, 0, 0, (16, 2)),
    (17, 32768, F16, 0, 0, (32, 1)),
    (32, 32768, F16, 0, 0, (32, 1)),
    (33, 32768, F32, 0, 0, (64, 1)),
    (64, 32768, F16, 0, 0, (64, 1)),
    (7, 32770, F16, 0, 0, (8, 2)),     # even, not a multiple of 4
    (7, 32771, F16, 0, 0, (8, 1)),     # odd: the 1-lane instance
    (7, 32771, F32, 0, 0, (8, 1)),
    (10, 32771, F16, 0, 0, (16, 1)),
    (7, 32768, F16, 2, 0, (8, 1)),     # a view one f16 element in
    (7, 32768, F16, 4, 0, (8, 2)),     # two elements in: 4-byte loads
    (7, 32768, F32, 8, 0, (8, 2)),     # two f32 elements in
    (7, 32768, F16, 0, 8, (8, 2)),     # c2v 8-byte aligned: float2 stores
    (7, 32768, F16, 0, 4, (8, 1)),
    (10, 32768, F16, 4, 0, (16, 2)),
    (7, 1, F32, 0, 0, (8, 1)),
])
def test_instance_choice(dc_max, batch, dtype, v2c_off, c2v_off, want):
    """The smallest cap that holds dc_max, then the widest lane count under
    the cap's register budget whose accesses stay aligned: a pure function
    of dc_max, the batch, the storage type and the two addresses."""
    got = kbp.bp_instance(dc_max, batch, dtype, 1 << 20 | v2c_off,
                          1 << 20 | c2v_off)
    assert got == want
    cap, lanes = got
    assert dc_max <= cap and lanes <= kbp.CAP_LANES[cap]
    size = 2 if dtype == F16 else 4
    assert batch % lanes == 0 and v2c_off % (lanes * size) == 0
    assert c2v_off % (lanes * 4) == 0


def test_instance_choice_refuses_wide_checks():
    """Past the largest cap (B1's 64 slots) the CUDA path raises: it never
    falls back to the twin."""
    with pytest.raises(ValueError, match="dc_max <= 64"):
        kbp.bp_instance(65, 32768, F16, 0, 0)


def test_the_library_builds_the_kernel():
    """The build compiles B8's source, whose C entry the wrapper binds."""
    assert "bp_cn_pair.cu" in build.SOURCES
    src = (build.CSRC / "bp_cn_pair.cu").read_text()
    assert 'extern "C" int ldpc_bp_cn_pair(' in src
    # the accurate expf and logf: the fast intrinsics are not called
    assert "__expf(" not in src and "__logf(" not in src
    assert "use_fast_math" not in " ".join(build.NVCC_FLAGS)
