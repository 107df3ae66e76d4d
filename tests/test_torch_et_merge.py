"""Kernel B10's wrapper and plain twin (``kernels/merge.py``): the
early-termination decision merge, on the CPU.

The twin, in place, equals the flooding loop's old three lines bit for bit
over f32, f16 and bf16 posteriors holding +0.0, −0.0, NaN, ±inf and
subnormals, at batches 1, 15, 16, 17 and 32768, 2-D and 3-D, with every,
no and some frames done, and leaves a done frame's decisions and round
count as they were; the instance is the 16-lane one exactly where the
batch and the planes' alignment allow it; the wrapper refuses by name a
wrong type, shape, device or layout; ``run_flooding_soft`` calls the merge
once per executed round, alone inside the span ``ldpc.decode.et_merge``;
and each of the six early-terminating decoders on that loop goes through
it and still gives the JAX package's decisions, round counts and flags
(the existing comparisons, run again under a counter).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_bp as tbp
import tests.test_torch_minsum as tms
import tests.test_torch_minsum_qc as tmsqc
import tests.test_torch_stratified as tstrat
from ldpcsimulation_tpu.codes import qc as jqc_mod
from ldpcsimulation_tpu_torch import spans
from ldpcsimulation_tpu_torch.decoders import base
from ldpcsimulation_tpu_torch.kernels import merge
from ldpcsimulation_tpu_torch.kernels.merge import (
    WIDE,
    et_merge,
    et_merge_plain,
    merge_lane_width,
)
from tests.test_torch_stratified import codes  # noqa: F401  (fixture)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
BATCHES = [1, 15, 16, 17, 32768]
SHAPES = {"2d": (5,), "3d": (2, 3)}  # the rows ahead of the batch
DONE = ["all", "none", "mixed"]


def _old_latch(total, done, d, iters, rounds):
    """The flooding loop's merge before kernel B10 (new tensors)."""
    act = ~done
    d = torch.where(act, base._decide(total, torch.int8), d)
    iters = torch.where(act, rounds, iters)
    return d, iters


def _posterior(rows, batch, dtype, seed):
    """Random posteriors with the compare's hazards at random places:
    ±0.0, NaN, ±inf and ± the type's smallest subnormal."""
    gen = torch.Generator().manual_seed(seed)
    total = (4.0 * torch.randn((*rows, batch), generator=gen)).to(dtype)
    tiny = torch.finfo(dtype).tiny / 4  # a subnormal of the type
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf"), tiny, -tiny]).to(dtype)
    pick = torch.randint(0, 2 * len(special), total.shape, generator=gen)
    hit = pick < len(special)
    total[hit] = special[pick[hit]]
    return total


def _inputs(rows, batch, dtype, done_kind, seed=7):
    gen = torch.Generator().manual_seed(seed + 1)
    total = _posterior(rows, batch, dtype, seed)
    d = torch.where(torch.rand(total.shape, generator=gen) < 0.5, 1, -1
                    ).to(torch.int8)
    iters = torch.randint(0, 9, (batch,), generator=gen, dtype=torch.int32)
    done = {"all": torch.ones(batch, dtype=torch.bool),
            "none": torch.zeros(batch, dtype=torch.bool),
            "mixed": torch.rand(batch, generator=gen) < 0.5}[done_kind]
    return total, done, d, iters


@pytest.mark.parametrize("done_kind", DONE)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_twin_equals_the_old_latch(dtype, batch, shape, done_kind):
    total, done, d, iters = _inputs(SHAPES[shape], batch, DTYPES[dtype],
                                    done_kind)
    d0, it0 = d.clone(), iters.clone()
    want_d, want_it = _old_latch(total, done, d0, it0, 9)
    for fn in (et_merge_plain, et_merge):  # the wrapper takes the twin here
        got_d, got_it = d0.clone(), it0.clone()
        assert fn(total, done, got_d, got_it, 9) is None  # in place
        assert torch.equal(got_d, want_d) and torch.equal(got_it, want_it)
        # a done frame keeps its decisions and count
        assert torch.equal(got_d[..., done], d0[..., done])
        assert torch.equal(got_it[done], it0[done])
        # a frame not done takes the rule: +1 above zero, else -1
        act = ~done
        rule = torch.where(total[..., act] > 0, 1, -1).to(torch.int8)
        assert torch.equal(got_d[..., act], rule)
        assert bool((got_it[act] == 9).all())
    if done_kind == "none":  # the hazards all present, all taken
        flat = total.float().reshape(-1, batch)
        assert bool((want_d.reshape(-1, batch)[flat == 0] == -1).all())
        assert bool((want_d.reshape(-1, batch)[flat.isnan()] == -1).all())


def test_signed_zero_nan_and_subnormals_decide_as_before():
    """One lane each: +0.0, −0.0, NaN → −1; ±inf and ± a subnormal by
    their sign, in all three types."""
    values = [0.0, -0.0, float("nan"), float("inf"), -float("inf")]
    for dtype in DTYPES.values():
        tiny = torch.finfo(dtype).tiny / 4
        total = torch.tensor([values + [tiny, -tiny]]).to(dtype)
        assert total[0, -2] != 0  # a subnormal, not flushed to zero
        b = total.shape[1]
        d = torch.zeros((1, b), dtype=torch.int8)
        iters = torch.zeros(b, dtype=torch.int32)
        et_merge(total, torch.zeros(b, dtype=torch.bool), d, iters, 3)
        assert d.tolist() == [[-1, -1, -1, 1, -1, 1, -1]]
        assert iters.tolist() == [3] * b


@pytest.mark.parametrize("batch,offset,lanes", [
    (16, 0, WIDE), (32768, 0, WIDE), (1, 0, 1), (15, 0, 1), (17, 0, 1),
    (32771, 0, 1), (32, 1, 1), (32, 16, WIDE),
])
def test_the_instance_follows_the_batch_and_the_alignment(batch, offset,
                                                          lanes):
    """The wide instance where the batch is a multiple of 16 and every
    plane 16-byte aligned; d a view ``offset`` bytes into its buffer."""
    total = torch.zeros((3, batch))
    buf = torch.zeros(3 * batch + offset, dtype=torch.int8)
    d = buf[offset:].view(3, batch)
    done = torch.zeros(batch, dtype=torch.bool)
    iters = torch.zeros(batch, dtype=torch.int32)
    assert merge_lane_width(total, done, d, iters) == lanes


def _refusals():
    """(name, arguments, words the message names) of every refusal."""
    t = torch.zeros((4, 16))
    dn = torch.zeros(16, dtype=torch.bool)
    d = torch.zeros((4, 16), dtype=torch.int8)
    it = torch.zeros(16, dtype=torch.int32)
    meta = dict(device="meta")
    return [
        ("total_int32", (t.int(), dn, d, it, 1), "total"),
        ("total_f64", (t.double(), dn, d, it, 1), "total"),
        ("total_scalar", (t[0, 0], dn, d[0, 0], it, 1), "total"),
        ("d_int32", (t, dn, d.int(), it, 1), "d must"),
        ("d_shape", (t, dn, d[:3], it, 1), "d must"),
        ("done_uint8", (t, dn.to(torch.uint8), d, it, 1), "done"),
        ("done_shape", (t, dn[:15], d, it, 1), "done"),
        ("iters_int64", (t, dn, d, it.long(), 1), "iters"),
        ("iters_shape", (t, dn, d, it[None], 1), "iters"),
        ("mixed_devices", (t, torch.zeros(16, dtype=torch.bool, **meta), d,
                           it, 1), "meta"),
        ("total_not_contiguous", (t.t().contiguous().t(), dn, d, it, 1),
         "total must be contiguous"),
        ("d_not_contiguous", (t, dn, d.t().contiguous().t(), it, 1),
         "d must be contiguous"),
        ("rounds_past_int32", (t, dn, d, it, 2**31), "rounds"),
        ("device_meta", (t.to("meta"), dn.to("meta"), d.to("meta"),
                         it.to("meta"), 1), "unsupported device"),
    ]


@pytest.mark.parametrize("case", _refusals(), ids=lambda c: c[0])
def test_the_wrapper_refuses_by_name(case):
    _, args, words = case
    with pytest.raises(ValueError, match=words):
        et_merge(*args)
    if words != "unsupported device":  # the twin checks the same
        with pytest.raises(ValueError, match=words):
            et_merge_plain(*args)


@contextlib.contextmanager
def _recorded(monkeypatch):
    """Every ``et_merge`` call of the flooding loop, with the spans open
    around it and its posterior's type; every span the loop opens."""
    stack, calls, opened = [], [], []

    @contextlib.contextmanager
    def span(name):
        opened.append(name)
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()

    def counted(total, done, d, iters, rounds):
        calls.append(dict(spans=list(stack), dtype=total.dtype,
                          rounds=rounds))
        return et_merge(total, done, d, iters, rounds)

    monkeypatch.setattr(base.spans, "span", span)
    monkeypatch.setattr(base, "et_merge", counted)
    yield calls, opened


def test_run_flooding_soft_merges_once_a_round_inside_the_span(monkeypatch):
    """A QC min-sum decode with early termination: one call a round, for
    rounds 1, 2, …, each alone in its own ``ldpc.decode.et_merge``."""
    jqc = jqc_mod.qc_peg(12, 6, 3, z=8)
    y = tmsqc._samples(np.random.default_rng(3), 64, jqc.n)
    with _recorded(monkeypatch) as (calls, opened):
        res = tmsqc._assert_decode_equal(jqc, y, 10, "plain", {}, tmsqc.F16,
                                         True)
    rounds = int(res.iterations.max())
    assert 1 < rounds and len(calls) == rounds
    assert [c["rounds"] for c in calls] == list(range(1, rounds + 1))
    assert all(c["spans"] == [spans.ET_MERGE] for c in calls)
    assert opened.count(spans.ET_MERGE) == rounds


def _decoders():
    """(name, run, returns the result) of the six early-terminating
    decoders, each through an existing comparison with the JAX package."""
    rng = np.random.default_rng
    f16 = (jnp.float16, torch.float16)
    return {
        "minsum_qc": lambda codes: tmsqc._assert_decode_equal(
            jqc_mod.qc_peg(12, 6, 3, z=8),
            tmsqc._samples(rng(5), 64, 96), 10, "offset", dict(delta=0.15),
            tmsqc.F16, True),
        "minsum": lambda codes: tms._decode_pair(
            "peg_96_48", tms._samples(rng(6), 64, 96), 10, "plain", {},
            tms.F16, True),
        "minsum_stratified": lambda codes:
            tstrat.test_minsum_equals_jax_and_the_slot_array(codes,
                                                             "f16_et"),
        "bp_qc": lambda codes:
            tbp.test_decode_bp_qc_agrees_with_jax_and_generic(
                "qc_1008_504", 128, 0.7943, True, f16, {}),
        "bp": lambda codes: tbp.test_decode_bp_agrees_with_jax(
            "peg_96_48", 256, 0.75, True, f16),
        "bp_stratified": lambda codes:
            tstrat.test_bp_decode_agrees_with_jax_and_the_slot_array(
                codes, "irregular_512"),
        "minsum_f16_channel": lambda codes:
            tstrat.test_f16_channel_equals_jax_on_the_other_routes("qc"),
    }


@pytest.mark.parametrize("name", list(_decoders()))
def test_each_decoder_merges_through_b10_and_equals_jax(
        name, codes, monkeypatch):  # noqa: F811  (the imported fixture)
    with _recorded(monkeypatch) as (calls, _):
        res = _decoders()[name](codes)
    assert calls and all(c["spans"] == [spans.ET_MERGE] for c in calls)
    if res is not None:
        assert len(calls) == int(res.iterations.max())
    want = torch.float16 if name == "minsum_f16_channel" else torch.float32
    assert {c["dtype"] for c in calls} == {want}


def test_the_merge_is_in_the_kernel_list():
    from ldpcsimulation_tpu_torch.kernels import build

    assert "et_merge.cu" in build.SOURCES
    assert merge.et_merge is et_merge
