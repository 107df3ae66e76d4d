"""Code representation: alist I/O, constructions, padded-slot `Code`, QC
structure and its detection, the stratified slot grids of codes without QC
structure, the standard tables, the GF(2) encoder, named codes, and the
GF(2^m) tables of the non-binary codes."""

from .alist import Alist, dumps_alist, from_dense, load_alist, parse_alist, save_alist
from .code import Code, build_code, code_from_dense, code_to_alist
from .construct import (
    make_regular_code,
    nb_regular,
    peg,
    qc_expand,
    random_regular,
)
from .gf import gf_bits, gf_mul, gf_mul_perm, gf_tables
from .encode import Encoder, gf2_rref, make_encoder, random_codewords
from .library import NAMED_CODES, QC_NAMES, load_named_code, load_named_qc
from .qc import QCCode, build_qc_code, build_qc_code_edges, qc_ira, qc_peg
from .qc_detect import DetectedQC, detect_qc, permuted_decoder
from .stratified import StratifiedCode, detect_stratified, stratify

__all__ = [
    "Alist",
    "parse_alist",
    "load_alist",
    "dumps_alist",
    "save_alist",
    "from_dense",
    "Code",
    "build_code",
    "code_from_dense",
    "code_to_alist",
    "peg",
    "random_regular",
    "qc_expand",
    "nb_regular",
    "make_regular_code",
    "gf_tables",
    "gf_mul",
    "gf_mul_perm",
    "gf_bits",
    "Encoder",
    "gf2_rref",
    "make_encoder",
    "random_codewords",
    "NAMED_CODES",
    "QC_NAMES",
    "load_named_code",
    "load_named_qc",
    "QCCode",
    "build_qc_code",
    "build_qc_code_edges",
    "qc_ira",
    "qc_peg",
    "DetectedQC",
    "detect_qc",
    "permuted_decoder",
    "StratifiedCode",
    "detect_stratified",
    "stratify",
]
