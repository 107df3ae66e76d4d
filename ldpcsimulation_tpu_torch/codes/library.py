"""Named code registry (the entries that need no standard tables and no
native build).

``qc_1008_504`` is the flagship (1008, 504) dv=3 QC code of the throughput
benchmark; ``wifi_like_1944_972`` the 802.11n rate-1/2 structure class;
``peg_96_48`` and ``peg_24_12`` small test codes.  The other names of the
JAX registry need ``codes/standards.py`` (ROADMAP item A3), the native PEG
(A1) or packaged alists, and raise ``KeyError`` here.
"""

from __future__ import annotations

import functools

from .code import Code, build_code
from .construct import peg
from .qc import QCCode, qc_ira, qc_peg

__all__ = ["load_named_code", "load_named_qc", "NAMED_CODES"]

_NOT_PORTED = (
    "is not in the port yet: see ROADMAP.md queue A (standard tables A3, "
    "native PEG A1)"
)


@functools.lru_cache(maxsize=None)
def load_named_qc(name: str) -> QCCode:
    """QC structure of a QC-registered code (cached: the constructions are
    deterministic)."""
    if name == "qc_1008_504":
        return qc_peg(12, 6, 3, z=84, seed=1)
    if name == "wifi_like_1944_972":
        # 802.11n rate-1/2 class: 12x24 base, z=81
        return qc_ira(nb_info=12, mb=12, z=81, dv_info=4, seed=2)
    raise KeyError(f"QC code {name!r} {_NOT_PORTED}")


NAMED_CODES = {
    "qc_1008_504": lambda device: load_named_qc("qc_1008_504").to_code(device),
    "wifi_like_1944_972": lambda device: load_named_qc(
        "wifi_like_1944_972"
    ).to_code(device),
    "peg_96_48": lambda device: build_code(peg(96, 48, 3, seed=0), device),
    "peg_24_12": lambda device: build_code(peg(24, 12, 3, seed=0), device),
}


def load_named_code(name: str, device="cpu") -> Code:
    """Build a registered code by name, with its tables on ``device``."""
    if name not in NAMED_CODES:
        raise KeyError(
            f"code {name!r} {_NOT_PORTED}; have {sorted(NAMED_CODES)}"
        )
    return NAMED_CODES[name](device)
