"""The port's SystemC-model NGDBF against the JAX package, bit for bit on
the same additive-channel samples and the same injected source stream,
smoothed and unsmoothed, on a small PEG code and on peg_1008_504.  The JAX
decoder is run op by op (``jax.disable_jit``): compiled, it closes over its
config, and XLA may rewrite its f32 arithmetic (see
``test_compiled_jax_decoder``).  The keyed source stream (kernel B4 through
its plain twin) replays a frame in any batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import build_code as jbuild_code
from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes import peg as jpeg
from ldpcsimulation_tpu.decoders import ngdbf_systemc as jsc
from ldpcsimulation_tpu_torch.channel import snr_to_sigma
from ldpcsimulation_tpu_torch.codes import Code
from ldpcsimulation_tpu_torch.codes.code import _ARRAY_FIELDS, _META_FIELDS
from ldpcsimulation_tpu_torch.decoders import ngdbf_systemc as psc
from ldpcsimulation_tpu_torch.decoders.base import NoiseKey
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

FIELDS = ("hard", "iterations", "satisfied")


def _port_code(jcode) -> Code:
    fields = {f: np.asarray(getattr(jcode, f)) for f in _ARRAY_FIELDS}
    return Code.from_arrays(**fields, **{
        f: getattr(jcode, f) for f in _META_FIELDS
    })


@pytest.fixture(scope="module")
def small():
    jc = jbuild_code(jpeg(48, 24, 3, seed=13))
    return jc, _port_code(jc)


def _inputs(rng, b, n, T, sigma):
    y = (1.0 + sigma * rng.standard_normal((b, n))).astype(np.float32)
    src = (sigma * rng.standard_normal((n + T, b))).astype(np.float32)
    return y, src


def _decode_both(codes, y, src, sigma, jcfg, compiled=False):
    jc, pc = codes
    args = (jc, jnp.asarray(y), sigma, jcfg, jax.random.key(0))
    if compiled:
        jres = jsc.decode_ngdbf_systemc(*args, noise_stream=jnp.asarray(src))
    else:
        with jax.disable_jit():
            jres = jsc.decode_ngdbf_systemc(
                *args, noise_stream=jnp.asarray(src))
    pres = psc.decode_ngdbf_systemc(
        pc, torch.from_numpy(y), sigma,
        psc.SystemCNGDBFConfig(**vars(jcfg)),
        noise_stream=torch.from_numpy(src))
    return jres, pres


def _assert_equal(jres, pres):
    for f in FIELDS:
        want = np.asarray(getattr(jres, f))
        got = getattr(pres, f).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f)
        assert got.dtype == want.dtype, f


@pytest.mark.parametrize("smoothed", [True, False])
def test_systemc_equals_jax_op_by_op(small, smoothed):
    sigma = snr_to_sigma(3.0, 0.5)
    jcfg = jsc.SystemCNGDBFConfig(num_iterations=40, theta=-0.5,
                                  smoothed=smoothed)
    y, src = _inputs(np.random.default_rng(int(smoothed)), 16, 48, 40, sigma)
    jres, pres = _decode_both(small, y, src, sigma, jcfg)
    _assert_equal(jres, pres)
    its = pres.iterations
    assert (its == 40).any() and (its < 40).any()


@pytest.mark.parametrize("smoothed", [True, False])
def test_peg_1008_504_equals_jax_op_by_op(smoothed):
    """The operating point of the chip run (θ −0.5, λ 0.975, α 0.95, Ymax
    3, 16 levels) on peg_1008_504 at 2.5 dB, 8 frames, T=60."""
    jc = jlib.load_named_code("peg_1008_504")
    sigma = snr_to_sigma(2.5, 0.5)
    jcfg = jsc.SystemCNGDBFConfig(num_iterations=60, theta=-0.5,
                                  smoothed=smoothed)
    y, src = _inputs(np.random.default_rng(7), 8, jc.n, 60, sigma)
    jres, pres = _decode_both((jc, _port_code(jc)), y, src, sigma, jcfg)
    _assert_equal(jres, pres)


def test_keyed_source_replays_across_batches(small):
    """A frame decodes the same in any batch, a keyed decode equals the
    decode of its own source stream injected, and another seed decodes
    otherwise."""
    _, pc = small
    sigma = snr_to_sigma(2.5, 0.5)
    cfg = psc.SystemCNGDBFConfig(num_iterations=30, theta=-0.5)
    y = torch.from_numpy(_inputs(np.random.default_rng(3), 12, 48, 30,
                                 sigma)[0])
    one = psc.decode_ngdbf_systemc(pc, y, sigma, cfg, key=NoiseKey(5, 40))
    a = psc.decode_ngdbf_systemc(pc, y[:7], sigma, cfg, key=NoiseKey(5, 40))
    b = psc.decode_ngdbf_systemc(pc, y[7:], sigma, cfg, key=NoiseKey(5, 47))
    for f in FIELDS:
        assert torch.equal(getattr(one, f),
                           torch.cat([getattr(a, f), getattr(b, f)])), f
    src = psc.keyed_source(cfg, sigma, NoiseKey(5, 40), 48, 12, "cpu")
    assert src.shape == (48 + 30, 12)
    inj = psc.decode_ngdbf_systemc(pc, y, sigma, cfg, noise_stream=src)
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(inj, f)), f
    other = psc.decode_ngdbf_systemc(pc, y, sigma, cfg, key=NoiseKey(6, 40))
    assert not torch.equal(one.iterations, other.iterations)
    with pytest.raises(ValueError, match="noise key"):
        psc.decode_ngdbf_systemc(pc, y, sigma, cfg)


def test_compiled_jax_decoder(small):
    """Compiled, the JAX decoder's arithmetic is rewritten by XLA on the
    CPU: ``θ / λ`` by its closed-over λ becomes a multiply by ``1/λ``, and
    ``x·r + rnd + w·Σs`` is contracted into fused multiply-adds, so θ and E
    may differ from the op-by-op values (and the port's) in the last bit.
    Both rewrites are pinned here on the decoder's own expressions; the
    decisions still agree on these inputs, where no E or θ lies within an
    ulp of a quantizer level."""
    rng = np.random.default_rng(0)
    lam = 0.975
    theta = jnp.asarray(
        (-0.5 / lam ** rng.integers(-40, 40, 4096)).astype(np.float32))
    adapt = jax.jit(lambda t: t / lam)
    assert (np.asarray(adapt(theta)) != np.asarray(theta / lam)).any()
    np.testing.assert_array_equal(
        np.asarray(theta / lam),
        (torch.from_numpy(np.array(theta)) / torch.tensor(
            np.float32(lam))).numpy())
    x, r, rnd = (jnp.asarray(rng.choice([-1.0, 1.0, 0.4, -2.2], 4096)
                             .astype(np.float32)) for _ in range(3))
    w = jnp.asarray((0.95 * 3.0 / rng.integers(1, 7, 4096)).astype(
        np.float32))
    s = jnp.asarray(rng.integers(-3, 4, 4096).astype(np.float32))
    metric = jax.jit(lambda x, r, rnd, w, s: x * r + rnd + w * s)
    assert (np.asarray(metric(x, r, rnd, w, s))
            != np.asarray(x * r + rnd + w * s)).any()

    sigma = snr_to_sigma(2.5, 0.5)
    jcfg = jsc.SystemCNGDBFConfig(num_iterations=40, theta=-0.5)
    y, src = _inputs(np.random.default_rng(11), 32, 48, 40, sigma)
    jres, pres = _decode_both(small, y, src, sigma, jcfg, compiled=True)
    _assert_equal(jres, pres)
