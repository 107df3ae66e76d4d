"""Kernel B1's design on the CPU (the CUDA kernel itself runs only on the
card): the launcher's choice of lane width, the kernel's integer
arithmetic written out in numpy (compacted slots, magnitude keys, a sign
mask per lane, the post-op on the two minima only) against the plain twin
bit for bit, and the twin against the Pallas scan in interpret mode with
the JAX decoder's post-ops — on a sentinel-heavy table (60 slots, 32
named), degree-1 checks and a real slot table, with -0.0, ±65504, ±inf and
all-tied lanes, in f16 and f32, all three variants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpcsimulation_tpu.codes import library as jlib
from ldpcsimulation_tpu.decoders import minsum as jminsum
from ldpcsimulation_tpu.kernels.minsum_pallas import minsum_cn_scan_pallas
from ldpcsimulation_tpu_torch.kernels.minsum import (
    LANES,
    in_storage,
    lane_width,
    minsum_cn_scan,
    minsum_cn_scan_plain,
)
from tests.torch_threads import single_torch_thread  # noqa: F401  (autouse)

F16, F32 = torch.float16, torch.float32
B = 64

VARIANTS = [
    ("plain", {}),
    ("normalized", dict(alpha=0.8)),
    ("normalized", dict(alpha=1.25)),
    ("offset", dict(delta=0.15)),
    ("offset", dict(delta=1.0)),  # clamps the many small magnitudes to +0
]


# ------------------------------------------------------------ lane width


@pytest.mark.parametrize("batch,dtype,v2c_off,c2v_off,want", [
    (32768, F16, 0, 0, 4),   # 8-byte loads, float4 stores
    (32768, F32, 0, 0, 4),   # 16-byte loads
    (8192, F16, 256, 512, 4),
    (32770, F16, 0, 0, 2),   # even, not a multiple of 4
    (32770, F32, 0, 0, 2),
    (32771, F16, 0, 0, 1),   # odd: the 1-lane instance
    (32771, F32, 0, 0, 1),
    (1, F32, 0, 0, 1),       # msg_trace's B=1
    (32768, F16, 2, 0, 1),   # a view one f16 element in
    (32768, F16, 4, 0, 2),   # two elements in: 4-byte loads
    (32768, F32, 8, 0, 2),   # two f32 elements in: 8-byte loads
    (32768, F32, 0, 8, 2),   # c2v 8-byte aligned: float2 stores
    (32768, F16, 0, 4, 1),
    (1 << 30, F32, 0, 0, 4),  # rows 2^32 bytes apart: 64-bit addresses
    ((1 << 31) + 2, F16, 0, 0, 2),
])
def test_lane_width(batch, dtype, v2c_off, c2v_off, want):
    """The widest instance whose loads and stores stay aligned, as a pure
    function of the batch, the storage type and the two addresses."""
    got = lane_width(batch, dtype, 1 << 20 | v2c_off, 1 << 20 | c2v_off)
    assert got == want
    assert got in LANES
    size = 2 if dtype == F16 else 4
    assert batch % got == 0 and v2c_off % (got * size) == 0
    assert c2v_off % min(got * 4, 16) == 0


# ---------------------------------------------------------------- tables


def _sentinel_table(rng):
    """12 checks of 60 slots with 32 named at random slots (the stratified
    table's fill), rows a permutation of 384."""
    m, slots, named = 12, 60, 32
    rows = rng.permutation(m * named).astype(np.int32)
    table = np.full((m, slots), -1, np.int32)
    for c in range(m):
        at = np.sort(rng.choice(slots, named, replace=False))
        table[c, at] = rows[c * named:(c + 1) * named]
    return table, m * named


def _degree1_table(rng):
    """Checks of degree 1, 2 and 5 (and none) in 5 slots."""
    degs = [1, 1, 2, 5, 0, 1, 3, 5, 1, 2]
    rows = rng.permutation(sum(degs)).astype(np.int32)
    table = np.full((len(degs), 5), -1, np.int32)
    k = 0
    for c, d in enumerate(degs):
        at = np.sort(rng.choice(5, d, replace=False))
        table[c, at] = rows[k:k + d]
        k += d
    return table, k


def _slot_table(rng):
    """peg_96_48's ``cn_from_vn`` with its padding (dc 6-7)."""
    jcode = jlib.load_named_code("peg_96_48")
    table = np.where(np.asarray(jcode.cn_mask), np.asarray(jcode.cn_from_vn),
                     -1).astype(np.int32)
    return table, jcode.n * jcode.dv_max


TABLES = {"sentinel60": _sentinel_table, "degree1": _degree1_table,
          "peg_96_48": _slot_table}


def _messages(rng, table, rows, dtype):
    """Tied halves with zeros and -0.0, then hazard lanes: all of a
    check's messages equal in magnitude (signs random), -0.0 everywhere,
    ±65504, ±inf, and one negative zero among positives."""
    v = np.round(rng.normal(size=(rows, B)) * 4.0) / 2.0
    v[rng.random(v.shape) < 0.05] = -0.0
    signs = np.where(rng.random(v.shape) < 0.5, -1.0, 1.0)
    for c in range(table.shape[0]):
        r = table[c][table[c] >= 0]
        v[r, 0] = 1.5 * signs[r, 0]             # all tied
        v[r, 1] = -0.0                          # all -0.0
        v[r, 2] = 65504.0 * signs[r, 2]         # f16's largest
        v[r, 3] = np.inf * signs[r, 3]
        v[r, 4] = 2.0
        v[r[:1], 4] = -0.0                      # one -0.0: the others' sign
        v[r, 5] = 65504.0 * signs[r, 5]
        v[r[-1:], 5] = 0.5 * signs[r[-1:], 5]   # a unique minimum
    return v.astype(dtype)


# ---------------------------------------------------- the kernel's arithmetic


def _post(v, variant, alpha, delta, sdt):
    """The kernel's ``post``: f32 op, rounded to the storage type; returns
    (magnitude bits, keeps-the-sign)."""
    def store(x):
        if sdt != F16:
            return x
        with np.errstate(over="ignore"):  # past 65504: inf, as on the card
            return x.astype(np.float16).astype(np.float32)

    v = v.astype(np.float32)
    if variant == "normalized":
        return store(v / np.float32(alpha)).view(np.uint32), np.ones_like(
            v, bool)
    if variant == "offset":
        q = store(v - np.float32(delta))
        keep = q > 0
        bits = np.where(keep, q, np.float32(0)).view(np.uint32)
        return bits, keep & (v != 0)
    return v.view(np.uint32), np.ones_like(v, bool)


def _kernel_model(v2c, table, variant, kw, sdt):
    """csrc/minsum_cn_scan.cu's arithmetic per check, all lanes at once:
    the check's named rows compacted in slot order; integer magnitudes
    (f16: key = mag << 16 | slot, the two smallest keys; f32: the two
    smallest magnitudes, the last minimum's slot); a sign bit per slot on
    x < 0; each slot's output p1 or p2 with the parity of the other slots'
    signs XORed in (offset: cleared where the post-op drops the sign)."""
    f16 = sdt == F16
    alpha = in_storage(kw.get("alpha", 1.0), sdt)
    delta = in_storage(kw.get("delta", 0.0), sdt)
    bits = (v2c.view(np.uint16).astype(np.uint32) if f16
            else v2c.view(np.uint32))
    out = np.zeros(v2c.shape, np.uint32)
    for c in range(table.shape[0]):
        rows = table[c][table[c] >= 0]
        deg = rows.size
        if deg == 0:
            continue
        k = np.arange(deg, dtype=np.uint32)[:, None]
        if f16:
            keys = np.sort(((bits[rows] & 0x7fff) << 16) | k, axis=0)
            key2 = keys[1] if deg > 1 else np.full(B, 0x7c00ffff, np.uint32)
            m1 = (keys[0] >> 16).astype(np.uint16).view(np.float16)
            m2 = (key2 >> 16).astype(np.uint16).view(np.float16)
            idx = keys[0] & 0xffff
        else:
            mag = bits[rows] & 0x7fffffff
            srt = np.sort(mag, axis=0)
            m1 = srt[0].view(np.float32)
            m2 = (srt[1] if deg > 1 else np.full(B, 0x7f800000, np.uint32)
                  ).view(np.float32)
            idx = deg - 1 - np.argmin(mag[::-1], axis=0)  # <=: the last
        neg = v2c[rows] < 0  # -0.0 is not
        sm = neg ^ (neg.sum(axis=0) % 2 == 1)
        p1, s1 = _post(m1, variant, alpha, delta, sdt)
        p2, s2 = _post(m2, variant, alpha, delta, sdt)
        at = k == idx[None, :]
        sm &= np.where(at, s2, s1)
        out[rows] = np.where(at, p2, p1) ^ (sm.astype(np.uint32) << 31)
    return out.view(np.float32)


def _case(table_name, dtype, seed):
    rng = np.random.default_rng(seed)
    table, rows = TABLES[table_name](rng)
    v2c = _messages(rng, table, rows, np.float16 if dtype == F16
                    else np.float32)
    return table, v2c


@pytest.mark.parametrize("variant,kw", VARIANTS)
@pytest.mark.parametrize("dtype", [F16, F32], ids=["f16", "f32"])
@pytest.mark.parametrize("table_name", list(TABLES))
def test_kernel_arithmetic_equals_plain(table_name, dtype, variant, kw):
    """The kernel's integer scan and post-op on the minima give the twin's
    outputs bit for bit, signed zeros included, on every named row."""
    table, v2c = _case(table_name, dtype, 31)
    want = minsum_cn_scan_plain(torch.from_numpy(v2c),
                                torch.from_numpy(table), variant, **kw)
    got = _kernel_model(v2c, table, variant, kw, dtype)
    named = table[table >= 0]
    np.testing.assert_array_equal(got[named].view(np.uint32),
                                  want.numpy()[named].view(np.uint32))


# ------------------------------------------------------- twin against Pallas


@pytest.mark.parametrize("variant,kw", [VARIANTS[0], VARIANTS[1],
                                        VARIANTS[3]])
@pytest.mark.parametrize("dtype", [F16, F32], ids=["f16", "f32"])
@pytest.mark.parametrize("table_name", list(TABLES))
def test_plain_equals_pallas(table_name, dtype, variant, kw):
    """The twin (what the wrapper runs on CPU tensors) against
    ``minsum_cn_scan_pallas`` in interpret mode on the gathered messages,
    with the JAX decoder's post-op in the storage type after it."""
    table, v2c = _case(table_name, dtype, 32)
    mask = table >= 0
    got = minsum_cn_scan(torch.from_numpy(v2c), torch.from_numpy(table),
                         variant, **kw).numpy()[np.maximum(table, 0)]
    gathered = jnp.asarray(v2c[np.maximum(table, 0)].astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        pal = minsum_cn_scan_pallas(gathered, jnp.asarray(mask))
    out = jnp.asarray(pal).astype(v2c.dtype)
    if variant == "normalized":
        out = jminsum.apply_normalization(out, kw["alpha"])
    elif variant == "offset":
        out = jminsum.apply_offset(out, kw["delta"])
    want = np.asarray(out).astype(np.float32)
    np.testing.assert_array_equal(got[mask].view(np.uint32),
                                  want[mask].view(np.uint32))
