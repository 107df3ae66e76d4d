"""Each kernel's byte count at the cells' shapes against PERF.md's kernel
table (its memory bounds, over 3.35 TB/s, at B=32768 on qc_1008_504)."""

import pytest

from gpubench.metrics import (
    b1_roofline_pct,
    b2_roofline_pct,
    b4_roofline_pct,
    b5_roofline_pct,
    b6_roofline_pct,
    b7_roofline_pct,
)
from gpubench.reference import codes

B = 32768


@pytest.fixture(scope="module")
def g():
    return codes.graph(codes.load_table("qc_1008_504"))


def mb(x):
    return round(x / 1e6, 1)


def test_b2(g):
    assert mb(b2_roofline_pct.call_bytes(g.n, B, False)) == 132.1


def test_b1_f16_store(g):
    # memory bound 0.1183 ms
    assert mb(b1_roofline_pct.call_bytes(g.e, B, 2, 2)) == 396.4
    assert round(b1_roofline_pct.call_bytes(g.e, B, 2, 2) / 3.35e9, 4) \
        == 0.1183


def test_b5_qc(g):
    assert mb(b5_roofline_pct.call_bytes(g.e, g.n, B, 2, 4)) == 660.6


def test_b6(g):
    assert mb(b6_roofline_pct.call_bytes(g.n, g.m, B, 4, False)) == 132.2
    # the bit-flip syndrome and check on int8: bound 0.0148 ms
    syn = b6_roofline_pct.call_bytes(g.n, g.m, B, 1, True)
    assert round(syn / 3.35e9, 4) == 0.0148


def test_b7_in_and_out_of_the_window(g):
    inside = b7_roofline_pct.call_bytes(g.n, g.m, B, 1, True, True, True)
    outside = b7_roofline_pct.call_bytes(g.n, g.m, B, 1, True, True, False)
    # the table's figures also count the [n, 3] int64 check table (24 kB)
    assert mb(inside + g.n * 3 * 8) == 875.4
    assert mb(outside + g.n * 3 * 8) == 611.1


def test_b4(g):
    assert mb(b4_roofline_pct.call_bytes(g.n, B, False)) == 132.1
