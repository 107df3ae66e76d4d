"""The frozen code tables, pairs of circulants and absent edges included,
against the program's codes: the reference's graph edge for edge, each
column's edges in the order of the program's variable-node fold, and the
``QCCode`` every family builds."""

import functools

import numpy as np
import pytest
import torch

from gpubench.families._qc import qc_code
from gpubench.reference import codes
from ldpcsimulation_tpu_torch.codes.library import load_named_qc
from ldpcsimulation_tpu_torch.codes.qc import build_qc_code
from ldpcsimulation_tpu_torch.decoders.minsum_qc import qc_plan

#: a small table with one block pair of two circulants, (0, 1) at shifts 3
#: and 6, and one absent edge, row offset 4 of (2, 5) at shift 3
HAND = {
    "name": "hand_48_24", "z": 8,
    "base": [[0, 3, -1, 5, 1, -1],
             [2, -1, 4, 0, -1, 6],
             [-1, 7, 1, -1, 2, 3]],
    "extra": [[0, 1, 6]],
    "minus": [[2, 5, 3, 4]],
}


def table(name):
    return HAND if name == HAND["name"] else codes.load_table(name)


def graph_by_loop(t):
    """The graph of a table edge by edge in Python: every circulant's
    edges less the absent ones, sorted by column, then check."""
    z, base = t["z"], t["base"]
    mb, nb = len(base), len(base[0])
    blocks = [(bi, bj, s) for bi in range(mb) for bj in range(nb)
              for s in [base[bi][bj]] if s >= 0]
    blocks += [tuple(b) for b in t.get("extra", [])]
    gone = {tuple(b) for b in t.get("minus", [])}
    edges = sorted((bj * z + (r + s) % z, bi * z + r)
                   for bi, bj, s in blocks for r in range(z)
                   if (bi, bj, s, r) not in gone)
    n, m, e = nb * z, mb * z, len(edges)
    col = torch.tensor([c for c, _ in edges] + [n])
    chk = torch.tensor([h for _, h in edges] + [m])
    col_edges = codes._rows(col[:-1], n, e)
    check_edges = codes._rows(chk[:-1], m, e)
    return codes.Graph(n=n, m=m, e=e, check_edges=check_edges,
                       col_edges=col_edges, check_cols=col[check_edges],
                       col_checks=chk[col_edges])


@functools.lru_cache(maxsize=None)
def built(name):
    """(table, the reference's graph, the program's QCCode) of a table."""
    t = table(name)
    return t, codes.graph(t), qc_code(t)


@pytest.fixture(params=["qc_1008_504", "hand_48_24", "dvbs2_1_2_qc"])
def case(request):
    return built(request.param)


def test_graph_equals_the_edge_by_edge_expansion(case):
    t, g, _ = case
    want = graph_by_loop(t)
    assert (g.n, g.m, g.e) == (want.n, want.m, want.e)
    for f in ("check_edges", "col_edges", "check_cols", "col_checks"):
        assert torch.equal(getattr(g, f), getattr(want, f)), f


def test_graph_equals_the_program_code(case):
    _, g, qc = case
    code = qc.to_code("cpu")
    assert (g.n, g.m, g.k) == (code.n, code.m, code.k)
    assert torch.equal(g.check_cols,
                       torch.where(code.cn_mask, code.cn_vn.long(), g.n))
    assert torch.equal(g.col_checks,
                       torch.where(code.vn_mask, code.vn_cn.long(), g.m))


def test_column_order_is_the_vn_fold_order(case):
    """Each column's checks in the reference's order are those of
    ``QCPlan.vn_rows``, term by term: the order in which kernel B5 folds a
    column's messages (an absent edge's +0.0 term left out)."""
    _, g, qc = case
    plan = qc_plan(qc, torch.device("cpu"))
    rows = plan.vn_rows.long()
    real = rows >= 0  # NO_TERM past the degree, a +0.0 term below it
    chk = torch.where(real, plan.row_check[rows.clamp(min=0)], g.m)
    first = torch.argsort((~real).to(torch.int8), dim=1, stable=True)
    chk = torch.gather(chk, 1, first)
    assert not chk[:, g.col_checks.shape[1]:].ne(g.m).any()
    assert torch.equal(chk[:, :g.col_checks.shape[1]], g.col_checks)


def test_dvbs2_table_is_the_registry_code():
    t, g, qc = built("dvbs2_1_2_qc")
    assert qc == load_named_qc("dvbs2_1_2_qc")
    assert (g.n, g.m, g.k, g.e) == (64800, 32400, 32400, 226799)
    assert len(t["extra"]) == 8 and len(t["minus"]) == 1
    deg = torch.bincount((g.col_checks < g.m).sum(dim=1), minlength=9)
    assert {d: int(c) for d, c in enumerate(deg) if c} == {
        1: 1, 2: 32399, 3: 19440, 8: 12960}


def test_hand_table_has_its_pair_and_absent_edge():
    _, g, qc = built("hand_48_24")
    assert qc.extra_edges == ((0, 1, 6),)
    assert qc.minus_edges == ((2, 5, 3, 4),)
    assert g.e == 13 * 8 - 1
    # the absent edge: check 2·8 + 4 and column 5·8 + (4 + 3) % 8
    assert not bool((g.check_cols[20] == 47).any())
    # the pair's columns exchange their two terms where the second
    # circulant's row comes first: both orders occur
    plan = qc_plan(qc, torch.device("cpu"))
    first = plan.row_check[plan.vn_rows[8:16, 0].long()]
    at_3 = first == (torch.arange(8) - 3) % 8  # the shift-3 circulant's
    assert bool(at_3.any()) and not bool(at_3.all())


def test_table_without_new_keys_gives_the_old_code():
    t = codes.load_table("qc_1008_504")
    assert "extra" not in t and "minus" not in t
    qc = qc_code(t)
    assert qc == build_qc_code(np.array(t["base"]), t["z"])
    assert qc == load_named_qc("qc_1008_504")
    assert qc.extra_edges == () and qc.minus_edges == ()
