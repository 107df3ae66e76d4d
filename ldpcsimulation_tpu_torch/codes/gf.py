"""GF(2^m) arithmetic tables for the non-binary decoders.

Numpy port of ``ldpcsimulation_tpu.codes.gf`` (which cites the reference's
IT++ tables): the field is generated from standard primitive polynomials
and exposed as dense numpy tables.  The additive group of GF(2^m) is
(Z_2)^m — addition is the XOR of the polynomial representations — which is
what lets the Walsh–Hadamard transform diagonalize the check-node
convolution (Davey–MacKay 1998).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "PRIMITIVE_POLYS",
    "gf_tables",
    "gf_mul",
    "gf_mul_perm",
    "gf_bits",
]

#: primitive polynomials over GF(2) of degree m (bit i = coefficient of x^i)
PRIMITIVE_POLYS = {
    1: 0b11,          # x + 1
    2: 0b111,         # x^2 + x + 1
    3: 0b1011,        # x^3 + x + 1
    4: 0b10011,       # x^4 + x + 1
    5: 0b100101,      # x^5 + x^2 + 1
    6: 0b1000011,     # x^6 + x + 1
    7: 0b10001001,    # x^7 + x^3 + 1
    8: 0b100011101,   # x^8 + x^4 + x^3 + x^2 + 1
}


@functools.lru_cache(maxsize=None)
def gf_tables(q: int):
    """(mul [q, q], inv [q]) int32 tables of GF(q), q = 2^m."""
    m = q.bit_length() - 1
    if 2 ** m != q or m not in PRIMITIVE_POLYS:
        raise ValueError(f"q={q} is not a supported power of two")
    poly = PRIMITIVE_POLYS[m]

    def mul1(a: int, b: int) -> int:
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a & q:
                a ^= poly
        return r

    mul = np.zeros((q, q), np.int32)
    for a in range(q):
        for b in range(q):
            mul[a, b] = mul1(a, b)
    inv = np.zeros(q, np.int32)
    for a in range(1, q):
        inv[a] = int(np.where(mul[a] == 1)[0][0])
    return mul, inv


def gf_mul(q: int, a, b):
    """Elementwise a·b in GF(q)."""
    mul, _ = gf_tables(q)
    return mul[np.asarray(a), np.asarray(b)]


def gf_mul_perm(q: int, h: int) -> np.ndarray:
    """Permutation p with p[a] = h·a (h nonzero): the index map that rescales
    a probability vector by a coefficient (P_hx[h·a] = P_x[a])."""
    mul, _ = gf_tables(q)
    if h == 0:
        raise ValueError("zero coefficient has no permutation")
    return mul[h].copy()


def gf_bits(q: int) -> np.ndarray:
    """[q, m] int32 bit expansion of each field element (bit 0 = LSB)."""
    m = q.bit_length() - 1
    return ((np.arange(q)[:, None] >> np.arange(m)[None, :]) & 1).astype(
        np.int32
    )
