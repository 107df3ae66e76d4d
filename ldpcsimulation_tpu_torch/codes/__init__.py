"""Code representation: alist I/O, constructions, padded-slot `Code`, QC
structure, named codes."""

from .alist import Alist, dumps_alist, from_dense, load_alist, parse_alist, save_alist
from .code import Code, build_code, code_to_alist
from .construct import make_regular_code, peg, qc_expand, random_regular
from .library import NAMED_CODES, load_named_code, load_named_qc
from .qc import QCCode, build_qc_code, build_qc_code_edges, qc_ira, qc_peg

__all__ = [
    "Alist",
    "parse_alist",
    "load_alist",
    "dumps_alist",
    "save_alist",
    "from_dense",
    "Code",
    "build_code",
    "code_to_alist",
    "peg",
    "random_regular",
    "qc_expand",
    "make_regular_code",
    "NAMED_CODES",
    "load_named_code",
    "load_named_qc",
    "QCCode",
    "build_qc_code",
    "build_qc_code_edges",
    "qc_ira",
    "qc_peg",
]
