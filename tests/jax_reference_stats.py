"""The JAX package's Monte-Carlo statistics at the operating points that
``chip_smoke.py`` gates the port against: BER and FER, each with its
standard error from the run's per-frame error histogram.

    JAX_PLATFORMS=cpu python -m tests.jax_reference_stats minsum_peg

Runs on the CPU (seed 0, batches of 4096, 131072 frames) and prints one
JSON object; ``chip_smoke.py`` holds the constants it printed.
"""

from __future__ import annotations

import json
import math
import sys

import jax.numpy as jnp
import numpy as np

from ldpcsimulation_tpu.codes.library import load_named_code
from ldpcsimulation_tpu.decoders.minsum import decode_minsum
from ldpcsimulation_tpu.harness.montecarlo import StopRule, simulate

FRAMES = 131072
BATCH = 4096


def moments(stats) -> dict:
    """(value, standard error) of BER and FER, as ``chip_smoke.mc_moments``
    computes them."""
    f, n = stats.total_words, stats.n
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = math.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    fer_se = math.sqrt(stats.fer * (1 - stats.fer) / f)
    return dict(ber=(stats.ber, ber_se), fer=(stats.fer, fer_se),
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


if __name__ == "__main__":
    print(json.dumps({"point": sys.argv[1], **globals()[sys.argv[1]]()}))
