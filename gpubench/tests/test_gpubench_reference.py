"""The plain reference against the program's CPU twins at small sizes,
and the frozen code table against the program's registry."""

import numpy as np
import pytest
import torch

from gpubench.reference import Precision, codes, minsum, ngdbf, philox, \
    sigma_of
from ldpcsimulation_tpu_torch.channel.awgn import snr_to_sigma
from ldpcsimulation_tpu_torch.codes.library import load_named_qc
from ldpcsimulation_tpu_torch.kernels.channel import (
    awgn_philox_plain,
    gauss_philox_plain,
)

SEED = 2 ** 31 + 12345
F16 = Precision()


@pytest.fixture(scope="module")
def graph():
    return codes.graph(codes.load_table("qc_1008_504"))


@pytest.fixture(scope="module")
def qc():
    return load_named_qc("qc_1008_504")


def test_frozen_table_is_the_registry_code(qc):
    table = codes.load_table("qc_1008_504")
    assert table["z"] == qc.z
    assert tuple(tuple(r) for r in table["base"]) == qc.base


def test_graph_equals_the_program_slot_arrays(graph, qc):
    code = qc.to_code("cpu")
    assert (graph.n, graph.m, graph.k) == (code.n, code.m, code.k)
    cols = torch.where(code.cn_mask, code.cn_vn.long(), graph.n)
    assert torch.equal(graph.check_cols, cols)
    assert torch.equal(graph.col_checks, code.vn_cn.long())


def test_philox_known_answer():
    zero = torch.zeros(1, dtype=torch.int64)
    words = philox.philox(zero, zero, zero, zero, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]


@pytest.mark.parametrize("frame0", [0, 2 ** 32 - 3, 10 ** 12])
def test_channel_equals_b2_twin(frame0):
    sigma = snr_to_sigma(2.0, 0.5)
    assert sigma == sigma_of(2.0, 0.5)
    frames = frame0 + torch.arange(7)
    ref = philox.channel(SEED, frames, 1008, sigma)
    port = awgn_philox_plain(SEED, frame0, 7, 1008, sigma)
    assert torch.equal(ref, port)


@pytest.mark.parametrize("step", [0, 299])
def test_decoder_noise_equals_b4_twin(step):
    scale = ngdbf.f32(sigma_of(3.25, 0.5) * 0.975)
    frames = 40 + torch.arange(9)
    ref = philox.decoder_noise(SEED, frames, 1008, step, scale)
    port = gauss_philox_plain(SEED, 40, 9, 1008, 1 + 2 * step, 0.0, scale)
    assert torch.equal(ref, port)


@pytest.mark.parametrize("slots", [False, True])
def test_minsum_equals_program(graph, qc, slots):
    from ldpcsimulation_tpu_torch.decoders.minsum import decode_minsum
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import decode_minsum_qc

    frames = torch.arange(96)
    y = philox.channel(SEED, frames, graph.n, sigma_of(2.0, 0.5))
    hard, its, sat = minsum.decode(graph, y, 10, F16)
    kw = dict(storage_dtype=torch.float16)
    res = (decode_minsum(qc.to_code("cpu"), y, 10, **kw) if slots
           else decode_minsum_qc(qc, y, 10, **kw))
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert 0 < int(sat.sum()) < 96  # both kinds of frame are compared


def test_smngdbf_equals_program(graph, qc):
    from ldpcsimulation_tpu_torch.channel.quantize import saturate
    from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
    from ldpcsimulation_tpu_torch.decoders.gdbf import decode_gdbf, preset

    p = dict(iterations=300, theta=-0.9, noise_scale=0.975, lam=0.988,
             alpha=0.75, window=64, ymax=2.5, preset="SMNGDBF")
    sigma = sigma_of(2.75, 0.5)
    frames = 500 + torch.arange(48)
    y = torch.clamp(philox.channel(SEED, frames, graph.n, sigma), -2.5, 2.5)
    hard, its, sat = ngdbf.decode(graph, y, p, sigma, SEED, frames,
                                  Precision(storage=torch.float32))
    cfg = preset("SMNGDBF", num_iterations=300, theta=-0.9,
                 noise_scale=0.975, lam=0.988, alpha=0.75, window_size=64)
    res = decode_gdbf(qc.to_code("cpu"), saturate(y, 2.5), sigma, cfg,
                      key=NoiseKey(SEED, 500), qc=qc)
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert not bool(sat.all())  # a frame ends unsatisfied: smoothing runs
    assert len(np.unique(its.numpy())) > 3
