"""The port's generalized QC min-sum decoder against the JAX package, bit
for bit: the real 802.11n z=81 code (irregular) against the JAX QC decoder
and the slot-array decoders, random structures with two-circulant pairs and
absent edges against the JAX QC and slot-array decoders on Gaussian and on
tied samples, and the row tables that carry pairs and absent edges.  Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.codes.code import build_code as jbuild_code
from ldpcsimulation_tpu.codes.qc import build_qc_code_edges as jedges
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.decoders import minsum_qc as jmsqc
from ldpcsimulation_tpu_torch.codes import QCCode, load_named_code
from ldpcsimulation_tpu_torch.decoders import (
    decode_minsum,
    decode_minsum_qc,
    qc_plan,
)
from tests.test_torch_minsum import (
    F16,
    F32,
    FIELDS,
    _assert_equal,
    _samples,
    _tied_messages,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)


# ----------------------------------------------------- generalized QC path


def test_wifi_1944_qc_equals_jax_qc_and_generic():
    """The real 802.11n z=81 code (irregular, no pairs): the QC decoder
    equals the JAX QC decoder, and the port's slot-array decoder on the
    same H equals both."""
    jqc = jlib.load_named_qc("wifi_1944_972")
    qc = QCCode.from_reference(jqc)
    y = _samples(np.random.default_rng(2), 8, jqc.n, sigma=0.75)
    for et in (False, True):
        jres = jmsqc.decode_minsum_qc(jqc, jnp.asarray(y), 6,
                                      early_termination=et,
                                      storage_dtype=jnp.float16)
        res = decode_minsum_qc(qc, torch.from_numpy(y), 6,
                               early_termination=et,
                               storage_dtype=torch.float16)
        _assert_equal(res, jres)
        gen = decode_minsum(load_named_code("wifi_1944_972"),
                            torch.from_numpy(y), 6, early_termination=et,
                            storage_dtype=torch.float16)
        for f in FIELDS:
            assert torch.equal(getattr(gen, f), getattr(res, f)), f


def _random_structure(rng):
    """A random generalized QC structure as the JAX package's property
    test builds them: single circulants, one or two pairs, and an absent
    edge on a single circulant at an extreme or random row."""
    z = int(rng.integers(3, 9))
    mb, nb = 3, 5
    edges, used = [], set()
    for bi in range(mb):
        for bj in rng.choice(nb, size=3, replace=False):
            s = int(rng.integers(0, z))
            if (bi, int(bj), s) not in used:
                used.add((bi, int(bj), s))
                edges.append((bi, int(bj), s))
    touched = {bj for _, bj, _ in edges}
    for bj in range(nb):
        if bj not in touched:
            s = int(rng.integers(0, z))
            edges.append((0, bj, s))
            used.add((0, bj, s))
    for _ in range(int(rng.integers(1, 3))):
        bi, bj, s = edges[int(rng.integers(0, len(edges)))]
        if sum(1 for (a, b, _) in edges if (a, b) == (bi, bj)) != 1:
            continue
        s2 = int((s + rng.integers(1, z)) % z)
        if (bi, bj, s2) not in used:
            used.add((bi, bj, s2))
            edges.append((bi, bj, s2))
    singles = [(bi, bj, s) for (bi, bj, s) in edges
               if sum(1 for (a, b, _) in edges if (a, b) == (bi, bj)) == 1]
    bi, bj, s = singles[int(rng.integers(0, len(singles)))]
    r = int(rng.choice([0, z - 1, int(rng.integers(0, z))]))
    return jedges(edges, z, mb, nb, minus_edges=((bi, bj, s, r),))


@pytest.mark.parametrize("trial", range(6))
def test_random_pair_and_absent_structures_equal_jax(trial):
    """Pairs and absent edges: the QC decoder equals the JAX QC decoder
    and the JAX slot-array decoder on the expanded H, on Gaussian samples
    and on tied samples (the pair order decides the tie-break)."""
    rng = np.random.default_rng(2024 + trial)
    jqc = _random_structure(rng)
    assert jqc.extra_edges and jqc.minus_edges
    qc = QCCode.from_reference(jqc)
    jcode = jbuild_code(jqc.to_alist())
    ys = (rng.normal(0.3, 1.0, size=(32, jqc.n)).astype(np.float32),
          _tied_messages(rng, (32, jqc.n), np.float32) + np.float32(0.5))
    for y in ys:
        for variant, kw, storage in (("plain", {}, F32),
                                     ("offset", dict(delta=0.15), F16)):
            res = decode_minsum_qc(qc, torch.from_numpy(y), 5,
                                   variant=variant, early_termination=True,
                                   storage_dtype=storage[1], **kw)
            for jres in (
                jmsqc.decode_minsum_qc(jqc, jnp.asarray(y), 5,
                                       variant=variant,
                                       early_termination=True,
                                       storage_dtype=storage[0], **kw),
                jminsum.decode_minsum(jcode, jnp.asarray(y), 5,
                                      variant=variant,
                                      early_termination=True,
                                      storage_dtype=storage[0], **kw),
            ):
                _assert_equal(res, jres)


def test_generalized_plan_tables():
    """Pairs swap their cn_rows entries row by row; an absent edge is a −1
    slot, the sentinel column, and a message row no check names (zeroed
    by the step before the fold)."""
    z = 5
    edges = [(0, 0, 1), (0, 0, 3), (0, 1, 0), (0, 2, 2),
             (1, 0, 2), (1, 1, 2), (1, 2, 4)]
    qc = QCCode.from_reference(jedges(edges, z, 2, 3,
                                      minus_edges=((1, 2, 4, 1),)))
    plan = qc_plan(qc, torch.device("cpu"))
    rows = plan.cn_rows.numpy()
    named = sorted(rows[rows >= 0].tolist())
    assert plan.absent_rows.tolist() == sorted(
        set(range(plan.num_planes * z)) - set(named))
    assert len(named) == plan.num_planes * z - 1
    assert (plan.check_cols.numpy()[rows < 0] == qc.n).all()
    # check row r of block 0 reads columns (r+1)%5 and (r+3)%5 of block 0
    # in ascending order: swapped where (r+3)%5 < (r+1)%5
    cols = plan.check_cols.numpy()[:z, :2]
    assert (cols[:, 0] < cols[:, 1]).all()
    with pytest.raises(NotImplementedError, match=">2 circulants"):
        qc_plan(QCCode.from_reference(jedges(
            [(0, 0, 1), (0, 0, 2), (0, 0, 3), (1, 1, 0)], z, 2, 2)), "cpu")
