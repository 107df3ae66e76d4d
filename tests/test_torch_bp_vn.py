"""Kernel B9, the sum-product variable-node update (``csrc/bp_vn_update.cu``),
on the CPU: the CUDA kernel runs only on the card (``chip_smoke.py`` holds
it to its twin there, bit for bit), so here its twin
``kernels/bp.py::bp_vn_update_plain``, and ``qc_bp_step`` built on it, are
pinned bit for bit (int views: signed zeros and NaN count) to the QC step's
VN expression as it was before the kernel (``tests/frozen_bp.py``); the QC
BP decodes and the QC BP stream equal their runs on the frozen step; and
the wrapper's checks."""

import dataclasses

import numpy as np
import pytest
import torch

from ldpcsimulation_tpu_torch.channel.awgn import llr_from_channel, snr_to_n0
from ldpcsimulation_tpu_torch.codes import load_named_qc, qc_peg
from ldpcsimulation_tpu_torch.codes.qc import build_qc_code_edges
from ldpcsimulation_tpu_torch.decoders import bp_qc, qc_plan
from ldpcsimulation_tpu_torch.decoders.bp import MAXLLR
from ldpcsimulation_tpu_torch.harness import StopRule
from ldpcsimulation_tpu_torch.harness.stream import (
    bp_qc_stream,
    simulate_stream,
)
from ldpcsimulation_tpu_torch.kernels import bp as kbp
from ldpcsimulation_tpu_torch.kernels import build
from tests import frozen_bp
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

F16, F32 = torch.float16, torch.float32

CODES = {
    "qc_1008_504": lambda: load_named_qc("qc_1008_504"),
    # circulant pairs, absent edges and column degrees 2, 3 and 8
    "dvbs2_1_2_qc": lambda: load_named_qc("dvbs2_1_2_qc"),
    # a pair, an absent edge and columns of degree 2 beside 3: NO_TERM
    # entries in the table and a zero term
    "pair_absent_z5": lambda: build_qc_code_edges(
        [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2), (1, 0, 2), (1, 1, 2),
         (1, 2, 4)], 5, 2, 3, minus_edges=((1, 2, 4, 1),)),
}


@pytest.fixture(scope="module")
def codes():
    return {name: make() for name, make in CODES.items()}


def _bits(x):
    return x.view(torch.int16 if x.dtype == F16 else torch.int32)


def _same_bits(got, want):
    return got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


def _inputs(rng, plan, batch, ydt):
    """(c2v [R, B] f32, y [N, B] in ``ydt``) as the check update leaves
    them: c2v spread so that total − c straddles the ±20 clip, 3 % +0.0,
    3 % -0.0 and 0.5 % NaN, +0.0 in the rows of absent edges; y clamped
    LLRs with 3 % -0.0; in lane 0 every term and sample -0.0 (a -0.0
    posterior)."""
    rows, n = plan.num_planes * plan.z, plan.vn_rows.shape[0]
    c = 12.0 * rng.normal(size=(rows, batch))
    u = rng.random(c.shape)
    c[u < 0.03] = 0.0
    c[u > 0.97] = -0.0
    c[u < 0.005] = np.nan
    c[:, 0] = -0.0
    c2v = torch.from_numpy(c.astype(np.float32))
    if plan.absent_rows is not None:
        c2v.index_fill_(0, plan.absent_rows, 0.0)
    y = np.clip(1.0 + 8.0 * rng.normal(size=(n, batch)), -20.0, 20.0)
    y[rng.random(y.shape) < 0.03] = -0.0
    y[:, 0] = -0.0
    return c2v, torch.from_numpy(y.astype(np.float32)).to(ydt)


FORMS = [
    pytest.param("qc_1008_504", 64, id="qc_1008_504"),
    pytest.param("qc_1008_504", 33, id="qc_1008_504-odd"),
    pytest.param("pair_absent_z5", 37, id="pair_absent_z5"),
    pytest.param("dvbs2_1_2_qc", 3, id="dvbs2_1_2_qc"),
]


@pytest.mark.parametrize("name,batch", FORMS)
@pytest.mark.parametrize("sdt", [F16, F32])
@pytest.mark.parametrize("ydt", [F32, F16])
def test_twin_equals_the_pre_change_expression(codes, name, batch, sdt, ydt):
    """The twin on ``QCPlan.vn_rows`` gives the plain QC step's VN side
    (the fold over ``QCPlan.fold``, the channel added last, the extrinsic
    through ``total[row_col]``, the clip, the saturating cast) bit for bit:
    total in f32 whatever y's type, v2c' in the storage type, a new plane;
    NaN, signed zeros and the clip included; no launch counted."""
    qc = codes[name]
    plan = qc_plan(qc, "cpu")
    c2v, y = _inputs(np.random.default_rng(23), plan, batch, ydt)
    keep = c2v.clone()
    want_v, want_t = frozen_bp.qc_bp_vn(qc, c2v, y, MAXLLR, sdt)
    build.LAUNCHES.clear()
    got_v, got_t = kbp.bp_vn_update(c2v, y, plan.vn_rows, MAXLLR, sdt)
    assert not build.LAUNCHES
    assert got_t.dtype == F32 and got_v.dtype == sdt
    assert _same_bits(got_t, want_t) and _same_bits(got_v, want_v)
    assert _same_bits(c2v, keep)  # c2v is not written
    zero = got_t == 0
    assert (zero & torch.signbit(got_t)).any()  # the -0.0 posteriors
    assert torch.isnan(got_v).any()
    fin = got_v[~torch.isnan(got_v)].float()
    assert fin.abs().max() == MAXLLR  # the clip binds
    if name != "qc_1008_504":  # absent edges: the zero term's row written
        rows = plan.absent_rows
        assert _same_bits(got_v[rows], want_v[rows])
        assert (plan.vn_rows == -1).any() and (plan.vn_rows < -1).any()


@pytest.mark.parametrize("max_llr", [0.5, 7.25, 1e5])
def test_twin_equals_the_pre_change_expression_at_any_clip(codes, max_llr):
    """Other clip bounds, one past f16's range (the saturating cast's
    ±65504 then binds, not the clip)."""
    qc = codes["pair_absent_z5"]
    plan = qc_plan(qc, "cpu")
    c2v, y = _inputs(np.random.default_rng(5), plan, 24, F32)
    c2v = c2v * 1e4
    for sdt, most in ((F16, 65504.0), (F32, float("inf"))):
        got = kbp.bp_vn_update_plain(c2v, y, plan.vn_rows, max_llr, sdt)
        want = frozen_bp.qc_bp_vn(qc, c2v, y, max_llr, sdt)
        assert all(_same_bits(g, w) for g, w in zip(got, want))
        top = got[0][~torch.isnan(got[0])].abs().max()
        assert float(top) == min(max_llr, most)  # the bound that binds


@pytest.mark.parametrize("name,batch", FORMS[:3])
@pytest.mark.parametrize("storage,ydt", [(F16, F32), (None, F32), (None, F16),
                                         (F16, F16)])
def test_qc_bp_step_equals_the_pre_change_step(codes, name, batch, storage,
                                               ydt):
    """``qc_bp_step`` (B8's route, then B9's) equals the frozen step (the
    same check update, then the plain VN expression) bit for bit from the
    same planes and LLRs."""
    qc = codes[name]
    plan = qc_plan(qc, "cpu")
    rng = np.random.default_rng(7)
    sdt = storage or ydt
    v2c = torch.from_numpy(np.clip(
        1.0 + 6.0 * rng.normal(size=(plan.num_planes * qc.z, batch)),
        -20, 20).astype(np.float32)).to(sdt)
    _, y = _inputs(rng, plan, batch, ydt)
    got = bp_qc.qc_bp_step(qc, storage_dtype=storage)(v2c, y)
    want = frozen_bp.qc_bp_step(qc, storage_dtype=storage)(v2c, y)
    assert got[0].dtype == sdt and got[1].dtype == F32
    assert all(_same_bits(g, w) for g, w in zip(got, want))


def _decodes(monkeypatch, run):
    """``run()`` with the port's ``qc_bp_step``, then with the frozen one
    in its place."""
    got = run()
    monkeypatch.setattr(bp_qc, "qc_bp_step", frozen_bp.qc_bp_step)
    want = run()
    monkeypatch.undo()
    return got, want


@pytest.mark.parametrize("et", [False, True])
def test_decode_bp_qc_is_unchanged(monkeypatch, et):
    """T=20 decodes of qc_1008_504 at 2.0 dB, f16 messages, fixed-T and
    early-terminating: decisions, iterations and flags equal to the decode
    on the frozen step."""
    qc = load_named_qc("qc_1008_504")
    rng = np.random.default_rng(20)
    sigma = 0.7943
    y = 1.0 + sigma * rng.normal(size=(64, qc.n))
    llr = torch.from_numpy((2.0 * y / sigma ** 2).astype(np.float32))
    got, want = _decodes(monkeypatch, lambda: bp_qc.decode_bp_qc(
        qc, llr, 20, early_termination=et, storage_dtype=F16))
    for f in ("hard", "iterations", "satisfied"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not bool(got.satisfied.all()) and bool(got.satisfied.any())
    if et:
        assert len(got.iterations.unique()) > 2


def test_bp_qc_stream_is_unchanged(monkeypatch):
    """A QC BP stream (f16 messages and pool, refill every round) counts
    the same errors, words and iterations as on the frozen step."""
    qc = qc_peg(12, 6, 3, z=8, seed=1)
    n0 = snr_to_n0(3.0, 0.5)

    def run():
        return simulate_stream(
            qc.n, bp_qc_stream(qc, storage_dtype=F16), 3.0, 0.5, 8,
            stop=StopRule.fixed_frames(96), lanes=16, seed=11,
            preprocess=lambda y: llr_from_channel(y, n0), pool_dtype=F16,
            device="cpu")

    got, want = _decodes(monkeypatch, run)
    for f in dataclasses.fields(got):
        if f.name == "wall_seconds":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b, f.name
    assert 0 < got.word_errors < got.total_words


# --------------------------------------------------- the wrapper's contract


def test_wrapper_checks_its_inputs():
    """Wrong types (c2v not f32, y or the storage not f16/f32, a table not
    int32), shapes that disagree, strided views, tensors on two devices and
    a device that is neither the CPU nor CUDA raise; the CPU runs the
    twin."""
    vn_rows = torch.tensor([[0, 2], [1, -1], [-5, 4]], dtype=torch.int32)
    c2v, y = torch.ones(5, 8), torch.ones(3, 8)
    v2c, total = kbp.bp_vn_update(c2v, y, vn_rows, MAXLLR, F16)
    assert v2c.dtype == F16 and total.dtype == F32
    # columns 0 and 2 total 3 and 2 (a +0.0 term in row 3), column 1 2
    want = torch.tensor([2.0, 1.0, 2.0, 2.0, 1.0], dtype=F16)
    assert torch.equal(v2c, want[:, None].expand(5, 8))
    assert torch.equal(total, torch.tensor([3.0, 2.0, 2.0])[:, None]
                       .expand(3, 8))
    for bad in (c2v.half(), c2v.double(), torch.ones(5, 16)[:, ::2],
                torch.ones(5, 8, 1), torch.ones(5, 9)):
        with pytest.raises(ValueError):
            kbp.bp_vn_update(bad, y, vn_rows, MAXLLR, F16)
    for bad in (y.double(), y.bfloat16(), torch.ones(4, 8),
                torch.ones(3, 16)[:, ::2]):
        with pytest.raises(ValueError):
            kbp.bp_vn_update(c2v, bad, vn_rows, MAXLLR, F16)
    for bad in (vn_rows.long(), vn_rows.reshape(-1), vn_rows.t(),
                vn_rows[:2]):
        with pytest.raises(ValueError):
            kbp.bp_vn_update(c2v, y, bad, MAXLLR, F16)
    for sdt in (torch.bfloat16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="f16 or f32"):
            kbp.bp_vn_update(c2v, y, vn_rows, MAXLLR, sdt)
    with pytest.raises(ValueError, match="on meta"):
        kbp.bp_vn_update_plain(c2v, y, vn_rows.to("meta"), MAXLLR, F16)
    with pytest.raises(ValueError, match="unsupported device"):
        kbp.bp_vn_update(c2v.to("meta"), y.to("meta"), vn_rows.to("meta"),
                         MAXLLR, F16)


def test_the_library_builds_the_kernel():
    """The build compiles B9's source, whose C entry the wrapper binds,
    without fast math: the adds, the clamp and the cast are exact."""
    assert "bp_vn_update.cu" in build.SOURCES
    src = (build.CSRC / "bp_vn_update.cu").read_text()
    assert 'extern "C" int ldpc_bp_vn_update(' in src
    assert "__fadd_rn(" in src and "__fsub_rn(" in src
    assert "use_fast_math" not in " ".join(build.NVCC_FLAGS)
    # B5, which min-sum runs, is another source
    assert "minsum_vn_update.cu" in build.SOURCES
    assert "bp_vn" not in (build.CSRC / "minsum_vn_update.cu").read_text()
