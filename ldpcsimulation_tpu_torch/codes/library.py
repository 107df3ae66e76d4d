"""Named code registry: the JAX package's names, built the same way.

``qc_1008_504`` is the flagship (1008, 504) dv=3 QC code of the throughput
path; ``peg_1008_504`` the packaged alist of the same size and degrees (the
reference's PEGReg504x1008 class); ``wifi_648_324``, ``wifi_1944_972``,
``dvbs2_1_2`` and ``dvbs2_1_2_qc`` the real standard codes
(:mod:`.standards`); the ``*_like`` and ``highrate_*`` names ensembles of
their size and degree classes (the regular PEG codes with n > 2000 come
from the C++ PEG, :mod:`..native`); ``peg_96_48`` and ``peg_24_12`` small
test codes.  Each name builds the same H as in the JAX package.
"""

from __future__ import annotations

import functools
import os

from .alist import Alist, load_alist
from .code import Code, build_code
from .construct import peg, random_regular
from .qc import QCCode, qc_ira, qc_peg

__all__ = ["data_path", "load_named_code", "load_named_qc", "NAMED_CODES",
           "QC_NAMES"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")

#: the names with a QC structure (:func:`load_named_qc`)
QC_NAMES = ("qc_1008_504", "wifi_like_1944_972", "dvbs2_like_64800_32400",
            "wifi_648_324", "wifi_1944_972", "dvbs2_1_2_qc")


def data_path(name: str) -> str:
    return os.path.join(_DATA_DIR, name)


@functools.lru_cache(maxsize=None)
def load_named_qc(name: str) -> QCCode:
    """QC structure of a QC-registered code (cached: the constructions are
    deterministic)."""
    if name == "qc_1008_504":
        return qc_peg(12, 6, 3, z=84, seed=1)
    if name == "wifi_like_1944_972":
        # 802.11n rate-1/2 class: 12x24 base, z=81
        return qc_ira(nb_info=12, mb=12, z=81, dv_info=4, seed=2)
    if name == "dvbs2_like_64800_32400":
        # DVB-S2 rate-1/2 size class as a dv=3 QC ensemble (60x120, z=540)
        return qc_peg(120, 60, 3, z=540, seed=4)
    if name == "wifi_648_324":
        from .standards import wifi_648_rate12_qc

        return wifi_648_rate12_qc()
    if name == "wifi_1944_972":
        from .standards import wifi_1944_rate12_qc

        return wifi_1944_rate12_qc()
    if name == "dvbs2_1_2_qc":
        # the real DVB-S2 rate-1/2 code in its QC-interleaved column order:
        # a column relabeling of dvbs2_1_2 (pairs of circulants and one
        # absent edge)
        from .standards import dvbs2_rate12_qc

        return dvbs2_rate12_qc().qc
    raise KeyError(f"{name!r} has no QC structure; the QC codes are "
                   f"{sorted(QC_NAMES)}")


def _dvbs2_alist() -> Alist:
    from .standards import dvbs2_rate12_alist

    return dvbs2_rate12_alist()


_ALISTS = {
    "peg_1008_504": lambda: load_alist(data_path("peg_1008_504.alist")),
    "peg_96_48": lambda: peg(96, 48, 3, seed=0),
    "peg_24_12": lambda: peg(24, 12, 3, seed=0),
    # MacKay 4000.2000 analog: (4,8)-regular ensemble
    "reg4_4000_2000": lambda: random_regular(4000, 2000, 4, seed=7),
    # 802.3an 10GBASE-T class: (2048, 384) dv=6 (native PEG)
    "highrate_2048_384": lambda: peg(2048, 384, 6, seed=8),
    # the 4376.282 SM-NGDBF class: (4376, 282) dv=4, dc_max 63 (native PEG)
    "highrate_4376_282": lambda: peg(4376, 282, 4, seed=11),
    "dvbs2_1_2": _dvbs2_alist,
    **{name: functools.partial(lambda nm: load_named_qc(nm).to_alist(), name)
       for name in QC_NAMES},
}


@functools.lru_cache(maxsize=None)
def _named_alist(name: str) -> Alist:
    return _ALISTS[name]()


#: name -> builder of the code on a device
NAMED_CODES = {
    name: functools.partial(
        lambda nm, device="cpu": build_code(_named_alist(nm), device), name)
    for name in sorted(_ALISTS)
}


def load_named_code(name: str, device="cpu") -> Code:
    """Build a registered code by name, with its tables on ``device``."""
    if name not in NAMED_CODES:
        raise KeyError(f"unknown code {name!r}; have {sorted(NAMED_CODES)}")
    return NAMED_CODES[name](device)
