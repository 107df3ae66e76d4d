"""The real DVB-S2 rate-1/2 code through the port's generalized QC decoder
(eight two-circulant pairs and the accumulator corner's absent edge), bit
for bit: one step from the same tied message state against the JAX
``qc_minsum_step`` (message bits and totals), and whole decodes against the
JAX slot-array decoder on the same H, which the JAX package's own tests
hold equal to its QC decoder.  Small shapes: the JAX QC step alone takes
tens of seconds to compile on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu_torch.codes import load_named_code, load_named_qc
from ldpcsimulation_tpu_torch.decoders import (
    decode_minsum,
    decode_minsum_qc,
    qc_minsum_step,
    qc_plan,
)
from tests.test_torch_minsum import (
    F16,
    F32,
    _assert_equal,
    _bits,
    _samples,
    _tied_messages,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

NAME = "dvbs2_1_2_qc"


def test_one_step_equals_jax_qc_step():
    """f16 planes with ties, zeros and −0.0, B=4: the totals and the new
    planes equal the JAX step's bit for bit, but for the absent edge's
    row, which no check reads (the JAX step subtracts the scan's output for
    the +inf it read there, the port a zero)."""
    jqc, qc = jlib.load_named_qc(NAME), load_named_qc(NAME)
    plan = qc_plan(qc, torch.device("cpu"))
    rng = np.random.default_rng(12)
    b = 4
    planes = _tied_messages(rng, (plan.num_planes * qc.z, b), np.float16)
    yb = _samples(rng, b, qc.n).T.copy()
    carry, p = [], 0
    for blocks in jqc.vn_blocks:
        deg = len(blocks)
        carry.append(jnp.asarray(
            planes[p * qc.z:(p + deg) * qc.z].reshape(deg, qc.z, b)))
        p += deg
    jstep = jax.jit(jmsqc.qc_minsum_step(jqc, storage_dtype=jnp.float16))
    jv2c, jtot = jstep(tuple(carry), jnp.asarray(yb).reshape(qc.nb, qc.z, b))
    v2c, tot = qc_minsum_step(qc, storage_dtype=torch.float16)(
        torch.from_numpy(planes), torch.from_numpy(yb))
    np.testing.assert_array_equal(
        _bits(tot.numpy()), _bits(np.asarray(jtot).reshape(qc.n, b)))
    want = np.concatenate([np.asarray(x).reshape(-1, b) for x in jv2c])
    read = np.ones(len(want), bool)
    read[plan.absent_rows.numpy()] = False
    assert (~read).sum() == 1
    np.testing.assert_array_equal(_bits(v2c.numpy()[read]),
                                  _bits(want[read]))


@pytest.mark.parametrize("variant,kw,storage,et", [
    ("plain", {}, F32, False),
    ("plain", {}, F16, True),
    ("offset", dict(delta=0.15), F16, False),
])
def test_decode_equals_jax(variant, kw, storage, et):
    """B=8, T=3, near the threshold: the QC decoder and the slot-array
    decoder on the expanded H equal the JAX slot-array decoder."""
    y = _samples(np.random.default_rng(3), 8, 64800, sigma=0.8)
    if variant == "offset":
        from ldpcsimulation_tpu_torch.channel import quantize_no_zero

        y = quantize_no_zero(torch.from_numpy(y), 2.0, 8.0).numpy()
    args = dict(variant=variant, early_termination=et, **kw)
    jres = jminsum.decode_minsum(jlib.load_named_code(NAME), jnp.asarray(y),
                                 3, storage_dtype=storage[0], **args)
    res = decode_minsum_qc(load_named_qc(NAME), torch.from_numpy(y), 3,
                           storage_dtype=storage[1], **args)
    _assert_equal(res, jres)
    gen = decode_minsum(load_named_code(NAME), torch.from_numpy(y), 3,
                        storage_dtype=storage[1], **args)
    _assert_equal(gen, jres)
