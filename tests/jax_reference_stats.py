"""The JAX package's Monte-Carlo statistics at the operating points that
``chip_smoke.py`` gates the port against: BER and FER, each with its
standard error from the run's per-frame error histogram.

    JAX_PLATFORMS=cpu python -m tests.jax_reference_stats minsum_peg

Runs on the CPU (seed 0) and prints one JSON object; ``chip_smoke.py`` holds
the constants it printed.  ``minsum_peg`` runs 131072 frames in batches of
4096; the other points (``bp_peg``, ``bp_qc``, ``minsum_layered_wifi``,
``ddbmp_reg4``, ``ngdbfhw_highrate``, ``systemc_peg``, ``nbqspa_gf8``) run
the frame counts in ``POINT_FRAMES``, chosen so that each takes a few
minutes at most on the CPU.  The non-binary point runs the batches of the
JAX ``simulate_nb`` (the same keys) through :func:`nb_frames`, which keeps
the per-frame counts that the standard errors need.  ``redecode_qc`` is the
JAX ``redecode_statistics`` at its CLI's documented point, summarized by
:func:`pe_moments` with frames as the sampling unit.  ``grid_smngdbf`` is
one point of the JAX ``simulate_grid`` (its distributed operating-point
engine) on a mesh of the CPU's devices: run it with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` for the 8 slots it
asks for.
"""

from __future__ import annotations

import json
import math
import sys

import jax.numpy as jnp
import numpy as np

from ldpcsimulation_tpu.channel import (
    llr_from_channel,
    quantize_no_zero,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu.codes.library import load_named_code, load_named_qc
from ldpcsimulation_tpu.decoders.bp import decode_bp
from ldpcsimulation_tpu.decoders.bp_qc import decode_bp_qc
from ldpcsimulation_tpu.decoders.ddbmp import decode_ddbmp
from ldpcsimulation_tpu.decoders.minsum import decode_minsum
from ldpcsimulation_tpu.decoders.minsum_layered import (
    decode_minsum_layered_qc,
)
from ldpcsimulation_tpu.decoders.ngdbf_hw import NGDBFHwConfig, decode_ngdbf_hw
from ldpcsimulation_tpu.decoders.ngdbf_systemc import (
    SystemCNGDBFConfig,
    decode_ngdbf_systemc,
)
from ldpcsimulation_tpu.harness.montecarlo import StopRule, simulate

FRAMES = 131072
BATCH = 4096
NGDBFHW_FRAMES = 65536
#: (frames, batch) of the points added after ``minsum_peg``
POINT_FRAMES = {
    "bp_peg": (131072, 4096),
    "bp_qc": (131072, 4096),
    "minsum_layered_wifi": (65536, 2048),
    "ddbmp_reg4": (16384, 1024),
    "ngdbfhw_highrate": (NGDBFHW_FRAMES, 2048),
    "systemc_peg": (65536, 4096),
    "nbqspa_gf8": (4096, 256),
    # (frames, batch per slot) over a mesh of GRID_SLOTS operating slots
    "grid_smngdbf": (16384, 512),
}
GRID_SLOTS = 8


def moments(stats) -> dict:
    """(value, standard error) of BER, FER and average iterations, as
    ``chip_smoke.mc_moments`` computes them."""
    f, n = stats.total_words, stats.n
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = math.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    fer_se = math.sqrt(stats.fer * (1 - stats.fer) / f)
    ith = stats.iteration_hist
    it = np.arange(len(ith))
    mean_i = (it * ith).sum() / f
    it_se = math.sqrt(((it**2 * ith).sum() / f - mean_i**2) / (f - 1))
    return dict(ber=(stats.ber, ber_se), fer=(stats.fer, fer_se),
                avg_iterations=(stats.avg_iterations, it_se),
                errors=stats.errors, word_errors=stats.word_errors,
                frames=f)


def minsum_peg() -> dict:
    """Plain min-sum on peg_1008_504, 2.0 dB, T=10, f16 message storage."""
    code = load_named_code("peg_1008_504")
    stats = simulate(
        code,
        lambda y, key: decode_minsum(code, y, 10,
                                     storage_dtype=jnp.float16),
        2.0, stop=StopRule.fixed_frames(FRAMES), batch_size=BATCH, seed=0,
    )
    return moments(stats)


def _point(name, code, decode_fn, snr_db, preprocess=None, **kw):
    frames, batch = POINT_FRAMES[name]
    stats = simulate(
        code, decode_fn, snr_db, stop=StopRule.fixed_frames(frames),
        batch_size=batch, seed=0, preprocess=preprocess, **kw,
    )
    return moments(stats)


def bp_peg() -> dict:
    """Sum-product BP on peg_1008_504, 1.6 dB, T=20, f32."""
    code = load_named_code("peg_1008_504")
    n0 = float(snr_to_n0(1.6, code.rate))
    return _point(
        "bp_peg", code, lambda llr, key: decode_bp(code, llr, 20), 1.6,
        preprocess=lambda y: llr_from_channel(y, n0),
    )


def bp_qc() -> dict:
    """QC sum-product BP on qc_1008_504, 2.0 dB, T=20, early termination,
    f16 message storage."""
    qc = load_named_qc("qc_1008_504")
    code = qc.to_code()
    n0 = float(snr_to_n0(2.0, code.rate))
    return _point(
        "bp_qc", code,
        lambda llr, key: decode_bp_qc(qc, llr, 20, early_termination=True,
                                      storage_dtype=jnp.float16),
        2.0, preprocess=lambda y: llr_from_channel(y, n0),
    )


def minsum_layered_wifi() -> dict:
    """Row-layered plain min-sum on wifi_1944_972, 2.0 dB, T=10, f32, early
    termination."""
    qc = load_named_qc("wifi_1944_972")
    return _point(
        "minsum_layered_wifi", qc.to_code(),
        lambda y, key: decode_minsum_layered_qc(
            qc, y, 10, early_termination=True), 2.0,
    )


def ddbmp_reg4() -> dict:
    """DD-BMP on reg4_4000_2000, 3.9 dB, Ymax 1.6, 8 levels, T=100."""
    code = load_named_code("reg4_4000_2000")
    return _point(
        "ddbmp_reg4", code, lambda yq, key: decode_ddbmp(code, yq, 100), 3.9,
        preprocess=lambda y: quantize_no_zero(y, 1.6, 8.0),
    )


#: NGDBFhw's operating point: the 802.3an defaults (w 0.185, Ymax 1.625,
#: noise scale 0.95, theta0 -0.525, NQ 5), one phase, T=600
NGDBFHW_SNR_DB = 4.25


def ngdbfhw_highrate() -> dict:
    """NGDBFhw on highrate_2048_384 (the registry's 802.3an-class code),
    ``NGDBFHW_SNR_DB``, T=600, the 802.3an defaults, one phase, generic
    graph operations."""
    code = load_named_code("highrate_2048_384")
    sigma = float(snr_to_sigma(NGDBFHW_SNR_DB, code.rate))
    cfg = NGDBFHwConfig(num_iterations=600, ring_len=max(2648, code.n + 600))
    return _point(
        "ngdbfhw_highrate", code,
        lambda y, key: decode_ngdbf_hw(code, y, sigma, cfg, key=key),
        NGDBFHW_SNR_DB,
    )


def systemc_peg() -> dict:
    """The SystemC-model NGDBF on peg_1008_504, 3.0 dB, T=300, theta -0.5,
    lambda 0.975, alpha 0.95, Ymax 3, 16 levels, smoothed, additive
    channel (docs/VALIDATION.md's SystemC operating point)."""
    code = load_named_code("peg_1008_504")
    sigma = float(snr_to_sigma(3.0, code.rate))
    cfg = SystemCNGDBFConfig(num_iterations=300, theta=-0.5)
    return _point(
        "systemc_peg", code,
        lambda y, key: decode_ngdbf_systemc(code, y, sigma, cfg, key),
        3.0, awgn_form="additive",
    )


def nb_frames(code, snr_db, num_iterations, frames, batch, seed=0,
              early_termination=True, storage_dtype=None):
    """Per-frame (symbol errors, bit errors, iterations) of the JAX
    ``simulate_nb`` run with a fixed frame count: the same batch keys
    (``fold_in(key(seed), batch)``), channel, priors and decoder."""
    import jax

    from ldpcsimulation_tpu.channel.nb import symbol_priors, symbols_to_bits
    from ldpcsimulation_tpu.decoders.nb_qspa import decode_nb_qspa

    q = code.q
    m = q.bit_length() - 1
    n0 = float(snr_to_n0(snr_db, code.rate))
    sigma = float(np.sqrt(n0 / 2.0))
    root = jax.random.key(seed)

    @jax.jit
    def batch_step(key):
        y = 1.0 + sigma * jax.random.normal(key, (batch, code.n, m),
                                            jnp.float32)
        res = decode_nb_qspa(code, symbol_priors(y, n0, q), num_iterations,
                             early_termination=early_termination,
                             storage_dtype=storage_dtype)
        bits = symbols_to_bits(res.symbols, q)
        return (jnp.sum(res.symbols != 0, axis=1),
                jnp.sum(bits != 0, axis=(1, 2)), res.iterations)

    out = [[], [], []]
    for i in range(-(-frames // batch)):
        b = min(batch, frames - i * batch)
        for acc, v in zip(out, jax.device_get(
                batch_step(jax.random.fold_in(root, i)))):
            acc.append(np.asarray(v)[:b])
    return tuple(np.concatenate(v).astype(np.int64) for v in out)


def nb_moments(sym, bits, iters, n, q) -> dict:
    """(value, standard error) of SER, BER, FER and average iterations from
    per-frame counts, as ``chip_smoke.nb_moments`` computes them."""
    f = len(sym)
    m = q.bit_length() - 1

    def mean_se(x, scale=1.0):
        x = np.asarray(x, np.float64)
        return (x.mean() / scale, x.std(ddof=1) / math.sqrt(f) / scale)

    fer = float((sym > 0).mean())
    return dict(ser=mean_se(sym, n), ber=mean_se(bits, n * m),
                fer=(fer, math.sqrt(fer * (1 - fer) / f)),
                avg_iterations=mean_se(iters),
                word_errors=int((sym > 0).sum()), frames=f)


#: the non-binary point: GF(8), the geometry of the reference's
#: q8.sp.6000.4000.3000.1 as a regular dv=3 PEG code, near its knee
NB_SNR_DB = 1.3


def nbqspa_gf8() -> dict:
    """FFT-QSPA on ``nb_regular(6000, 4000, 3, q=8, seed=0)``,
    ``NB_SNR_DB``, T=20, early termination, f16 message storage."""
    from ldpcsimulation_tpu.codes import build_code
    from ldpcsimulation_tpu.codes.construct import nb_regular

    code = build_code(nb_regular(6000, 4000, 3, q=8, seed=0))
    frames, batch = POINT_FRAMES["nbqspa_gf8"]
    sym, bits, iters = nb_frames(code, NB_SNR_DB, 20, frames, batch,
                                 storage_dtype=jnp.float16)
    return nb_moments(sym, bits, iters, code.n, code.q)


def pe_moments(outcomes) -> dict:
    """(value, standard error) of the mean frame error probability Pe(f)
    and of the share of frames with Pe(f) > 0, from redecode outcomes
    [frames, attempts], taking frames as the sampling unit."""
    pe = (np.asarray(outcomes) > 0).mean(axis=1)
    f = len(pe)
    share = float((pe > 0).mean())
    se = float(pe.std(ddof=1)) / math.sqrt(f)
    return dict(mean_pe=(float(pe.mean()), se),
                share_pe_pos=(share, math.sqrt(share * (1 - share) / f)),
                frames=f, attempts=int(np.asarray(outcomes).shape[1]))


def redecode_qc() -> dict:
    """``redecode_statistics`` on qc_1008_504 at 3.5 dB: SMNGDBF, T=300,
    theta -0.9, noise scale 0.975, lambda 0.988, alpha 0.75, window 64
    (the JAX CLI's defaults), 200 frames x 100 attempts, seed 0."""
    from ldpcsimulation_tpu.decoders.gdbf import preset
    from ldpcsimulation_tpu.tools.redecode_stats import redecode_statistics

    cfg = preset("SMNGDBF", num_iterations=300, theta=-0.9,
                 noise_scale=0.975, lam=0.988, alpha=0.75, window_size=64)
    out = redecode_statistics(load_named_code("qc_1008_504"), cfg, 3.5,
                              num_frames=200, num_redecodes=100, seed=0)
    return pe_moments(out)


def grid_smngdbf() -> dict:
    """One point of the JAX ``simulate_grid``: SMNGDBF on qc_1008_504 at
    3.0 dB, T=100, lambda 0.99 (the SNR, T and lambda axes of
    ``mngdbf_example_PEGReg504x1008.sh:31-59``), theta -0.9, noise scale
    0.975, alpha 0.75, window 64, Ymax 2.5 (the working point of the
    SMNGDBF cell; the script's alpha of 2.x diverges), the grid's traced
    f32 scalars, every slot of the mesh on that one point."""
    import dataclasses

    import jax

    from ldpcsimulation_tpu.channel.quantize import saturate
    from ldpcsimulation_tpu.decoders.gdbf import decode_gdbf, preset
    from ldpcsimulation_tpu.parallel.mesh import make_mesh
    from ldpcsimulation_tpu.parallel.montecarlo import simulate_grid

    qc = load_named_qc("qc_1008_504")
    code = qc.to_code()
    base = preset("SMNGDBF", num_iterations=100, theta=-0.9,
                  noise_scale=0.975, lam=0.988, alpha=0.75, window_size=64)
    frames, batch = POINT_FRAMES["grid_smngdbf"]
    mesh = make_mesh(n_snr=GRID_SLOTS, devices=jax.devices()[:GRID_SLOTS])

    def dec(y, sigma, key, point):
        return decode_gdbf(code, y, sigma,
                           dataclasses.replace(base, lam=point["lam"]),
                           key=key, qc=qc)

    (stats,) = simulate_grid(
        code, dec, [{"snr": 3.0, "lam": 0.99}], mesh, max_iterations=100,
        stop=StopRule.fixed_frames(frames), batch_per_device=batch, seed=0,
        preprocess=lambda y, point: saturate(y, 2.5), param_names=("lam",),
    )
    return moments(stats)


if __name__ == "__main__":
    print(json.dumps({"point": sys.argv[1], **globals()[sys.argv[1]]()}))
