"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

  * B1 :func:`.minsum.minsum_cn_scan` — min-sum check-node update, routing
    inside (replaces ``minsum_pallas.minsum_cn_scan_pallas``);
  * B5 :func:`.minsum.minsum_vn_update` — flooding min-sum variable-node
    update: fold, total, extrinsic and saturating store in one pass, in
    place over c2v (no Pallas original: the JAX steps' XLA fusion);
  * B8 :func:`.bp.bp_cn_pair` — sum-product check-node update, routing
    inside, the (s, d) pair folds in registers (no Pallas original: the
    JAX QC decoder's XLA fusion);
  * B9 :func:`.bp.bp_vn_update` — sum-product variable-node update: fold,
    posterior, extrinsic, ±max_llr clip and storage store in one pass, to
    a new plane (no Pallas original: the JAX QC BP step's XLA fusion);
  * B10 :func:`.merge.et_merge` — the early-termination decision merge:
    sign, latch and round count in one pass over a round's posterior, in
    place (no Pallas original: the JAX loop body's XLA fusion);
  * B11 :func:`.layered.minsum_layer_step` — one layer of row-layered
    min-sum: extrinsic, two-min scan, post-op, posterior update in place
    and storage store in one pass (no Pallas original: the JAX layered
    step's XLA fusion);
  * B6 :func:`.check.parity_check` — the parity check of every decoder's
    early exit and the bit-flip decoders' bipolar syndrome, one integer
    pass (no Pallas original: the JAX checks' XLA fusions);
  * B7 :func:`.gdbf.gdbf_parallel_step` — the parallel GDBF step after the
    CN update: neighbour sum, flip metric, flip, threshold adaptation and
    smoothing sum in one pass, in place (no Pallas original: the JAX
    step's XLA fusion);
  * :func:`.gdbf.gdbf_chunk` — the parallel GDBF steps between two exit
    checks in one C call (``csrc/gdbf_chunk.cu``): per step B6, the
    ``[B]`` bookkeeping as one kernel (``gdbf_lanes_kernel``, twin
    :func:`.gdbf.gdbf_lanes_plain`), B4 and B7, on a plan validated once
    per decode (:func:`.gdbf.gdbf_chunk_plan`);
  * B2 :func:`.channel.awgn_philox` — keyed Philox + Box–Muller AWGN of the
    all-(+1) word (replaces ``channel_pallas.awgn_all_zero_pallas``);
  * B3 :func:`.channel.uniform_philox` — keyed Philox uniforms (replaces
    ``channel_pallas.uniform_pallas``);
  * B4 :func:`.channel.gauss_philox` — keyed erfinv Gaussians on B3's
    uniforms (replaces ``channel_pallas.awgn_all_zero_hybrid``).

``build.LAUNCHES`` counts the launches of each (the bookkeeping kernel as
``gdbf_lanes``).
"""

from .bp import (
    bp_cn_pair,
    bp_cn_pair_plain,
    bp_vn_update,
    bp_vn_update_plain,
)
from .build import LAUNCHES
from .channel import (
    awgn_philox,
    awgn_philox_plain,
    gauss_philox,
    gauss_philox_plain,
    noise_stream,
    philox4x32_10,
    uniform_philox,
    uniform_philox_plain,
)
from .check import parity_check, parity_check_plain
from .gdbf import (
    gdbf_chunk,
    gdbf_chunk_plan,
    gdbf_lanes_plain,
    gdbf_parallel_step,
    gdbf_parallel_step_plain,
)
from .layered import minsum_layer_step, minsum_layer_step_plain
from .merge import et_merge, et_merge_plain
from .minsum import (
    VARIANTS,
    minsum_cn_scan,
    minsum_cn_scan_plain,
    minsum_vn_update,
    minsum_vn_update_plain,
)

__all__ = [
    "LAUNCHES",
    "bp_cn_pair",
    "bp_cn_pair_plain",
    "bp_vn_update",
    "bp_vn_update_plain",
    "awgn_philox",
    "awgn_philox_plain",
    "philox4x32_10",
    "noise_stream",
    "uniform_philox",
    "uniform_philox_plain",
    "gauss_philox",
    "gauss_philox_plain",
    "VARIANTS",
    "minsum_cn_scan",
    "minsum_cn_scan_plain",
    "minsum_vn_update",
    "minsum_vn_update_plain",
    "parity_check",
    "parity_check_plain",
    "et_merge",
    "et_merge_plain",
    "minsum_layer_step",
    "minsum_layer_step_plain",
    "gdbf_parallel_step",
    "gdbf_parallel_step_plain",
    "gdbf_lanes_plain",
    "gdbf_chunk_plan",
    "gdbf_chunk",
]
