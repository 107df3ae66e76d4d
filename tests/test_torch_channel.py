"""The port's channel layer: scalars and quantizers against the JAX
package, the plain twin of kernel B2 (keyed Philox AWGN) for moments,
determinism, seed and frame decorrelation, replay and the Philox known
answers, and the plain twins of kernels B3 and B4 (the decoders' keyed
uniforms and erfinv Gaussians) for their grid, streams, moments and the
JAX formula.

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

import jax
import jax.numpy as jnp

import ldpcsimulation_tpu.channel.awgn  # noqa: F401  (registers the module)
from ldpcsimulation_tpu.channel import quantize as jq
from ldpcsimulation_tpu_torch.channel import (
    MAXLLR,
    awgn,
    awgn_all_zero,
    bpsk,
    llr_from_channel,
    n0_to_sigma,
    quantize_no_zero,
    quantize_round,
    quantize_threshold_table,
    saturate,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.kernels.channel import (
    awgn_philox,
    gauss_philox,
    gauss_philox_lanes,
    gauss_philox_lanes_plain,
    gauss_philox_plain,
    NGDBFHW_RING_STREAM,
    SYSTEMC_STREAM,
    noise_stream,
    philox4x32_10,
    uniform_philox,
    uniform_philox_lanes,
    uniform_philox_lanes_plain,
    uniform_philox_plain,
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


# ------------------------------------------------------------ quantizers


def _quantizer_inputs(ymax):
    """Signed zeros, values on and around every rounding boundary and
    threshold, and values beyond ±Ymax."""
    rng = np.random.default_rng(12)
    edges = np.linspace(-2 * ymax, 2 * ymax, 257)
    x = np.concatenate([
        [0.0, -0.0, ymax, -ymax, 1e-30, -1e-30],
        edges, np.nextafter(edges, np.inf), np.nextafter(edges, -np.inf),
        rng.normal(0, ymax, 2000),
    ]).astype(np.float32)
    return x


def _same_bits(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("ymax,nq", [(2.5, 3), (2.25, 4), (1.5, 8),
                                     (2.0, 5), (1.625, 6), (3.0, 16)])
def test_quantizers_equal_jax(ymax, nq):
    x = _quantizer_inputs(ymax)
    t = torch.from_numpy(x)
    _same_bits(saturate(t, ymax), jq.saturate(x, ymax))
    _same_bits(quantize_round(t, ymax, nq), jq.quantize_round(x, ymax, nq))
    _same_bits(quantize_no_zero(t, ymax, float(nq)),
               jq.quantize_no_zero(x, ymax, float(nq)))
    _same_bits(quantize_threshold_table(t, ymax, nq),
               jq.quantize_threshold_table(x, ymax, nq))
    # the round quantizer keeps the sign of a negative sample as −0.0
    q = quantize_round(torch.tensor([-1e-3, 1e-3, -0.0]), ymax, nq)
    assert torch.signbit(q).tolist() == [True, False, False]


# --------------------------------------------- kernels B3/B4: plain twins


def _u(seed, frame0, batch, n, stream, layout="bn"):
    return uniform_philox_plain(seed, frame0, batch, n, stream, layout)


def test_uniform_twin_grid_and_determinism():
    u, k = uniform_philox_plain(5, 0, 512, 203, 3, "bn", with_bits=True)
    assert u.dtype == torch.float32 and k.dtype == torch.int32
    assert int(k.min()) >= 0 and int(k.max()) < 2**24
    np.testing.assert_array_equal(
        u.numpy(),
        ((k.numpy().astype(np.float32) + np.float32(0.5))
         * np.float32(2.0**-24)),
    )
    assert 0.0 < float(u.min()) and float(u.max()) <= 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    assert abs(float(u.var()) - 1 / 12) < 0.002
    assert torch.equal(u, _u(5, 0, 512, 203, 3))
    # the two layouts hold the same samples
    assert torch.equal(uniform_philox_plain(5, 0, 512, 203, 3, "nb"), u.t())
    # a frame's draws do not depend on the batch around it
    assert torch.equal(_u(5, 100, 40, 203, 3), u[100:140])
    # odd widths: column c always takes word c % 4 of quad c // 4
    assert torch.equal(_u(5, 0, 8, 6, 3), _u(5, 0, 8, 8, 3)[:, :6])


def test_uniform_twin_top_of_grid_is_one():
    """Above k = 2^23, k + 0.5 rounds to even in f32: k = 2^24 − 1 gives
    u = 1.0 exactly, and the Gaussian formula +inf (as the TPU functions
    do)."""
    k = torch.tensor([0, 2**23 - 1, 2**23, 2**23 + 1, 2**24 - 1])
    u = (k.to(torch.float32) + 0.5) * 2.0**-24
    assert u[-1] == 1.0 and u[0] == 2.0**-25
    assert torch.isinf(torch.erfinv(2.0 * u[-1:] - 1.0)).all()


def test_uniform_twin_frame_seed_step_decorrelation():
    base = _u(0, 0, 256, 64, noise_stream(3, 0))
    others = [
        _u(1, 0, 256, 64, noise_stream(3, 0)),  # seed
        _u(0, 1, 256, 64, noise_stream(3, 0)),  # frame shift
        _u(0, 0, 256, 64, noise_stream(4, 0)),  # step
        _u(0, 0, 256, 64, noise_stream(3, 1)),  # domain
    ]
    for o in others:
        assert not (base == o).all(dim=1).any()
        c = np.corrcoef(base.numpy().ravel(), o.numpy().ravel())[0, 1]
        assert abs(c) < 0.02
    # seed s, frame f never repeats seed s+1, frame f−1
    assert not (_u(1, 0, 256, 64, 9)[:-1] == _u(0, 1, 255, 64, 9)).all(
        dim=1).any()


def test_decoder_streams_are_disjoint_from_the_channel():
    """Stream 0 is kernel B2's counter: quad j of stream 0 holds B2's pair
    j words.  Every decoder draw takes a stream >= 1, one per (step,
    domain)."""
    _, bits = awgn_philox(4, 9, 16, 24, 0.5, "cpu", with_bits=True)
    _, k = uniform_philox_plain(4, 9, 16, 24, 0, "bn", with_bits=True)
    # B2 column 2j takes words (x0, x1), column 2j+1 (x2, x3) of pair j:
    # its [frame, pair, 4] bits are pair j's words in order
    assert torch.equal(k.reshape(16, 6, 4), bits.reshape(16, 12, 4)[:, :6])
    streams = {noise_stream(t, dom) for t in range(500) for dom in (0, 1)}
    assert len(streams) == 1000 and min(streams) == 1
    with pytest.raises(ValueError):
        noise_stream(-1, 0)
    with pytest.raises(ValueError):
        noise_stream(0, 2)


def test_noise_stream_never_returns_the_reserved_streams():
    """The NGDBFhw ring and the SystemC source own the two top streams;
    the last step noise_stream accepts stops below them, and every earlier
    stream keeps its number."""
    assert (NGDBFHW_RING_STREAM, SYSTEMC_STREAM) == (2**32 - 1, 2**32 - 2)
    last = (1 << 31) - 3
    top = {noise_stream(last, dom) for dom in (0, 1)}
    assert top == {2**32 - 5, 2**32 - 4}
    assert noise_stream(5, 0) == 11 and noise_stream(5, 1) == 12
    with pytest.raises(ValueError):
        noise_stream(last + 1, 0)
    # the reserved streams draw other numbers than the decoders' and B2's
    ring = _u(0, 0, 64, 64, NGDBFHW_RING_STREAM)
    for other in (SYSTEMC_STREAM, noise_stream(last, 1), 0):
        assert not (ring == _u(0, 0, 64, 64, other)).all(dim=1).any()


@pytest.mark.parametrize("offset,scale", [(1.0, 0.5), (0.0, 0.7)])
def test_gauss_twin_moments(offset, scale):
    """Port of test_kernels.py::test_awgn_hybrid_statistics, in the channel
    form (offset 1, scale σ) and the decoder form (offset 0)."""
    y, k = gauss_philox_plain(3, 0, 2048, 256, 5, offset, scale, "bn",
                              with_bits=True)
    assert torch.equal(k, uniform_philox_plain(3, 0, 2048, 256, 5, "bn",
                                               with_bits=True)[1])
    y = y[torch.isfinite(y)].numpy()
    assert y.size >= 2048 * 256 - 2
    assert abs(y.mean() - offset) < 0.01
    assert abs(y.std() - scale) < 0.01
    assert torch.equal(
        gauss_philox_plain(3, 0, 2048, 256, 5, offset, scale, "nb"),
        gauss_philox_plain(3, 0, 2048, 256, 5, offset, scale, "bn").t(),
    )


@pytest.mark.parametrize("offset,scale", [(1.0, 0.5), (0.0, 0.6817)])
def test_gauss_twin_equals_jax_formula(offset, scale):
    """The twin against ``awgn_all_zero_hybrid``'s XLA formula on the same
    uniforms, ``offset + f32(σ)·(f32(√2)·erfinv(2u − 1))``.  XLA's f32
    erf_inv (Giles' polynomial) is up to 65 ulps from the correctly
    rounded value where PyTorch's is within 0.6, so the two agree to a
    relative 1e-5 of √2·erfinv, and exactly in about a third of samples."""
    u = _u(8, 0, 1024, 512, 11)
    got = gauss_philox_plain(8, 0, 1024, 512, 11, offset, scale, "bn")
    nrm = jnp.float32(np.sqrt(2.0)) * jax.scipy.special.erfinv(
        2.0 * jnp.asarray(u.numpy()) - 1.0)
    want = np.asarray(offset + jnp.float32(scale) * nrm)
    got = got.numpy()
    tol = 1e-5 * scale * np.abs(np.asarray(nrm)) + 2.0**-22
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    assert (np.abs(got[finite] - want[finite]) <= tol[finite]).all()
    assert (got == want).mean() > 0.2


# ------------------------------- B2-B4: a sample's place in any launch

F0 = 2**32 - 150  # the wide draw's frames cross the counter's high word
PLACEMENTS = [
    (kind, n)
    for kind in ("awgn", "uniform-nb", "uniform-bn", "gauss-nb", "gauss-bn")
    for n in (1008, 1007, 1006, 5, 3, 1)
    # B2 at n = 1008 is test_awgn_plain_replays_frames_in_any_batch's
    if (kind, n) != ("awgn", 1008)
]


def _twin(kind, frame0, batch, n):
    """[batch, n] samples of one twin, whatever layout it writes."""
    if kind == "awgn":
        return awgn_philox(9, frame0, batch, n, 0.79, "cpu")
    name, layout = kind.split("-")
    if name == "uniform":
        out = uniform_philox_plain(9, frame0, batch, n, 7, layout)
    else:
        out = gauss_philox_plain(9, frame0, batch, n, 7, 0.0, 0.6817,
                                 layout)
    return out.t() if layout == "nb" else out


@pytest.fixture(scope="module")
def wide_draws():
    return {}


@pytest.mark.parametrize("kind,n", PLACEMENTS)
def test_twin_sample_depends_only_on_frame_and_column(kind, n, wide_draws):
    """The contract of the kernels' wide-store and tail instances: the
    sample at (frame, column) is the same whatever n, batch and frame0
    place it in — odd widths, odd and single-frame batches, a first frame
    on either side of 2^32."""
    if kind not in wide_draws:
        wide_draws[kind] = _twin(kind, F0, 300, 1008)
    wide = wide_draws[kind]
    for off, batch in ((40, 257), (299, 1), (100, 33)):
        got = _twin(kind, F0 + off, batch, n)
        assert got.shape == (batch, n)
        assert torch.equal(got, wide[off:off + batch, :n])


def test_noise_wrappers_route_and_reject():
    assert torch.equal(uniform_philox(1, 2, 8, 9, 3, "cpu"),
                       uniform_philox_plain(1, 2, 8, 9, 3))
    assert torch.equal(gauss_philox(1, 2, 8, 9, 3, 0.0, 0.5, "cpu", "bn"),
                       gauss_philox_plain(1, 2, 8, 9, 3, 0.0, 0.5, "bn"))
    for bad in (dict(stream=-1), dict(stream=2**32), dict(layout="xy")):
        kw = dict(stream=3, layout="nb") | bad
        with pytest.raises(ValueError):
            uniform_philox_plain(1, 2, 8, 9, kw["stream"], kw["layout"])
    with pytest.raises(ValueError, match="unsupported device"):
        uniform_philox(1, 2, 8, 9, 3, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gauss_philox(1, 2, 8, 9, 3, 0.0, 1.0, "meta")


# ------------------------------------------------------- per-lane keyed draws


def _lanes(kind, seed, gid, step, n, domain, layout, bits=False):
    if kind == "uniform":
        return uniform_philox_lanes_plain(seed, gid, step, n, domain, layout,
                                          bits)
    return gauss_philox_lanes_plain(seed, gid, step, n, domain, 0.0, 0.6817,
                                    layout, bits)


def _contiguous(kind, seed, frame0, batch, n, stream, layout, bits=False):
    if kind == "uniform":
        return uniform_philox_plain(seed, frame0, batch, n, stream, layout,
                                    with_bits=bits)
    return gauss_philox_plain(seed, frame0, batch, n, stream, 0.0, 0.6817,
                              layout, with_bits=bits)


@pytest.mark.parametrize("kind", ["uniform", "gauss"])
@pytest.mark.parametrize("layout", ["nb", "bn"])
@pytest.mark.parametrize("frame0,batch,n,step,domain", [
    (0, 64, 1008, 0, 0), (2**32 - 7, 33, 1007, 41, 1),
    (2**40 + 3, 5, 6, 2**31 - 3, 0),
])
def test_lane_twins_equal_the_contiguous_twins(kind, layout, frame0, batch,
                                               n, step, domain):
    """On contiguous gids and one step the per-lane twins give the bits of
    the contiguous twins on stream ``noise_stream(step, domain)`` (gids
    across 2^32, the last step)."""
    gid = frame0 + torch.arange(batch, dtype=torch.int64)
    steps = torch.full((batch,), step, dtype=torch.int32)
    got = _lanes(kind, 5, gid, steps, n, domain, layout, True)
    want = _contiguous(kind, 5, frame0, batch, n, noise_stream(step, domain),
                       layout, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", ["uniform", "gauss"])
@pytest.mark.parametrize("layout", ["nb", "bn"])
def test_lane_twins_equal_a_column_loop(kind, layout):
    """Scattered gids and steps: each lane's column equals the contiguous
    twin's draw of its own frame at its own step (an idle lane's gid −1
    draws frame 2^64 − 1)."""
    gen = torch.Generator().manual_seed(3)
    gid = torch.randint(0, 2**62, (19,), generator=gen)
    gid[[2, 7]] = torch.tensor([-1, 2**32])
    step = torch.randint(0, 2**31 - 2, (19,), generator=gen,
                         dtype=torch.int32)
    step[4] = 0
    for domain in (0, 1):
        got = _lanes(kind, 11, gid, step, 13, domain, layout)
        if layout == "nb":
            got = got.t()
        for b in range(19):
            want = _contiguous(kind, 11, int(gid[b]) % 2**64, 1, 13,
                               noise_stream(int(step[b]), domain), "bn")
            assert torch.equal(got[b], want[0]), (domain, b)


def test_lane_wrappers_route_and_reject():
    gid = torch.arange(4, 12, dtype=torch.int64)
    step = torch.full((8,), 3, dtype=torch.int32)
    assert torch.equal(uniform_philox_lanes(1, gid, step, 9, 1),
                       uniform_philox_lanes_plain(1, gid, step, 9, 1))
    assert torch.equal(gauss_philox_lanes(1, gid, step, 9, 0, 0.0, 0.5,
                                          "bn"),
                       gauss_philox_lanes_plain(1, gid, step, 9, 0, 0.0, 0.5,
                                                "bn"))
    for bad in (dict(gid=gid.int()), dict(step=step.long()),
                dict(step=step[:3]), dict(domain=2), dict(layout="xy")):
        kw = dict(gid=gid, step=step, domain=0, layout="nb") | bad
        with pytest.raises(ValueError):
            uniform_philox_lanes(1, kw["gid"], kw["step"], 9, kw["domain"],
                                 kw["layout"])
    with pytest.raises(ValueError, match="unsupported device"):
        uniform_philox_lanes(1, gid.to("meta"), step.to("meta"), 9, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        gauss_philox_lanes(1, gid.to("meta"), step.to("meta"), 9, 0, 0.0,
                           1.0)
