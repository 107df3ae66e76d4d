"""The port's channel layer: scalars against the JAX package, and the plain
twin of kernel B2 (keyed Philox AWGN) for moments, determinism, seed and
frame decorrelation, replay and the Philox known answers.

Kernel B2 cannot be compared bit for bit with the JAX
``awgn_all_zero_pallas``: the TPU kernel draws from the chip's hardware
PRNG, and under ``pltpu.force_tpu_interpret_mode()`` on this CPU that PRNG
returns a degenerate stream (mean ≈ 3.94, std ≈ 0).  The two are held to
the same distribution instead — the moment and decorrelation tests below
are the ports of ``tests/test_kernels.py``'s — and the kernel itself is
held against this twin on the card (``chip_smoke.py``).
"""

import sys

import numpy as np
import pytest
import torch

import ldpcsimulation_tpu.channel.awgn  # noqa: F401  (registers the module)
from ldpcsimulation_tpu_torch.channel import (
    MAXLLR,
    awgn,
    awgn_all_zero,
    bpsk,
    llr_from_channel,
    n0_to_sigma,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.kernels.channel import (
    awgn_philox,
    philox4x32_10,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

jawgn = sys.modules["ldpcsimulation_tpu.channel.awgn"]
SNRS = [0.0, 1.5, 2.0, 2.4, 3.3, 4.0]
RATES = [0.5, 0.75, 0.8, 1 / 3]


def _plain(seed, frame0, batch, n, sigma):
    return awgn_all_zero(seed, frame0, batch, n, sigma, "cpu").numpy()


@pytest.mark.parametrize("rate", RATES)
def test_noise_scalars_equal_jax(rate):
    for snr in SNRS:
        assert snr_to_n0(snr, rate) == float(jawgn.snr_to_n0(snr, rate))
        assert snr_to_sigma(snr, rate) == float(jawgn.snr_to_sigma(snr, rate))
    n0 = torch.tensor([0.5, 1.25], dtype=torch.float64)
    np.testing.assert_array_equal(
        n0_to_sigma(n0).numpy(), np.asarray(jawgn.n0_to_sigma(n0.numpy()))
    )
    assert MAXLLR == jawgn.MAXLLR


def test_bpsk_widens_before_mapping():
    bits = np.array([[0, 1, 1], [1, 0, 0]], np.uint8)
    x = bpsk(bits)
    assert x.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), np.asarray(jawgn.bpsk(bits)))
    np.testing.assert_array_equal(x.numpy(), [[1, -1, -1], [-1, 1, 1]])


def test_llr_from_channel_equals_jax():
    y = np.random.default_rng(3).normal(0, 3, (8, 40)).astype(np.float32)
    got = llr_from_channel(torch.from_numpy(y), 0.63).numpy()
    want = np.asarray(jawgn.llr_from_channel(y, np.float32(0.63)),
                      np.float32)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() == MAXLLR


@pytest.mark.parametrize("form", ["multiplicative", "additive"])
def test_generator_awgn_forms(form):
    x = bpsk(np.random.default_rng(1).integers(0, 2, (512, 64)))
    g = torch.Generator().manual_seed(5)
    y = awgn(x, 0.5, form=form, generator=g)
    g.manual_seed(5)
    n = torch.randn(x.shape, generator=g)
    want = x * (1.0 + 0.5 * n) if form == "multiplicative" else x + 0.5 * n
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        awgn(x, 0.5, form="bogus")


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32_10."""
    m = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((m, m, m, m), (m, m),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in philox4x32_10(ctr, key)) == want


def test_awgn_plain_statistics():
    """Port of test_kernels.py::test_awgn_kernel_statistics."""
    y = _plain(0, 0, 2048, 256, 0.5)
    assert y.shape == (2048, 256) and y.dtype == np.float32
    assert abs(y.mean() - 1.0) < 0.01
    assert abs(y.std() - 0.5) < 0.01
    np.testing.assert_array_equal(y, _plain(0, 0, 2048, 256, 0.5))
    assert (y != _plain(1, 0, 2048, 256, 0.5)).any()


def test_awgn_plain_frame_independence():
    """Port of test_kernels.py::test_awgn_kernel_tile_independence."""
    y = _plain(7, 0, 1024, 128, 1.0)
    assert not np.allclose(y[:256], y[256:512])
    assert (y.std(axis=1) > 0.5).all()


def test_awgn_plain_seed_frame_decorrelation():
    """Port of test_kernels.py::test_awgn_kernel_seed_tile_decorrelation:
    stream (s, f) must not repeat stream (s+1, f-1) — the hazard of adding
    the seed to a per-tile index."""
    y0 = _plain(0, 0, 2048, 256, 0.5)
    y1 = _plain(1, 0, 2048, 256, 0.5)
    for f in range(0, 2047, 97):
        assert not np.array_equal(y0[f + 1], y1[f])
        assert not np.array_equal(y0[f], y1[f])


def test_awgn_plain_replays_frames_in_any_batch():
    """Frames 100–163 drawn alone equal the same frames inside a larger
    batch: a frame's noise is a function of (seed, frame index) only."""
    alone = _plain(11, 100, 64, 1008, 0.79)
    inside = _plain(11, 40, 200, 1008, 0.79)
    np.testing.assert_array_equal(alone, inside[60:124])
    # odd width: the last column takes the first half of its pair
    np.testing.assert_array_equal(
        _plain(11, 100, 8, 7, 0.79), _plain(11, 100, 8, 8, 0.79)[:, :7]
    )


def test_awgn_plain_bits_and_high_frame_words():
    y, bits = awgn_philox(3, 2**32 - 2, 4, 6, 0.5, "cpu", with_bits=True)
    assert bits.shape == (4, 6, 2) and bits.dtype == torch.int32
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**24
    u1 = (bits[..., 0].float() + 0.5) * 2.0**-24
    u2 = (bits[..., 1].float() + 0.5) * 2.0**-24
    want = 1.0 + 0.5 * (torch.sqrt(-2.0 * torch.log(u1))
                        * torch.cos(2.0 * np.pi * u2))
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    # frames 2^32-2 .. 2^32+1 straddle the counter's word boundary
    np.testing.assert_array_equal(
        y[2:].numpy(), _plain(3, 2**32, 2, 6, 0.5)
    )


def test_awgn_rejects_bad_arguments():
    with pytest.raises(ValueError):
        awgn_philox(-1, 0, 2, 2, 0.5, "cpu")
    with pytest.raises(ValueError):
        awgn_philox(0, 2**64 - 1, 2, 2, 0.5, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        awgn_philox(0, 0, 2, 2, 0.5, "meta")
