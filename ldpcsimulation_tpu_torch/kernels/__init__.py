"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

  * B1 :func:`.minsum.minsum_cn_scan` — min-sum check-node update, routing
    inside (replaces ``minsum_pallas.minsum_cn_scan_pallas``);
  * B2 :func:`.channel.awgn_philox` — keyed Philox + Box–Muller AWGN of the
    all-(+1) word (replaces ``channel_pallas.awgn_all_zero_pallas``).

``build.LAUNCHES`` counts the launches of each.
"""

from .build import LAUNCHES
from .channel import awgn_philox, awgn_philox_plain, philox4x32_10
from .minsum import VARIANTS, minsum_cn_scan, minsum_cn_scan_plain

__all__ = [
    "LAUNCHES",
    "awgn_philox",
    "awgn_philox_plain",
    "philox4x32_10",
    "VARIANTS",
    "minsum_cn_scan",
    "minsum_cn_scan_plain",
]
