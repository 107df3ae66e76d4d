"""The program's QC code of a frozen table, as every family builds it."""

from __future__ import annotations

from ..reference.codes import circulants


def qc_code(table: dict):
    """The program's ``QCCode`` of a table (``codes/<name>.json``): its
    circulants, pairs and absent edges through ``build_qc_code_edges``; for
    a table of ``base`` and ``z`` alone, the ``QCCode`` of
    ``build_qc_code(base, z)``."""
    from ldpcsimulation_tpu_torch.codes.qc import build_qc_code_edges

    edges, minus = circulants(table)
    return build_qc_code_edges(edges, table["z"], len(table["base"]),
                               len(table["base"][0]),
                               minus_edges=tuple(minus))
