"""Channel-sample quantizers, bit-matching the reference's three families.

Port of ``ldpcsimulation_tpu.channel.quantize`` (which cites the reference
lines of each):

1. :func:`quantize_no_zero` — min-sum/DDBMP style: Nq *levels*, uniform
   floor quantizer with NO zero level; inputs beyond ±Ymax clamp to ±Ymax,
   and a value that would quantize to 0 maps to ±1 LSB instead.
2. :func:`quantize_round` — GDBF-family style: NQ *bits*,
   round-to-nearest ``sgn(x) * floor(|x| / step + 0.5) * step`` with
   ``step = Ymax / 2^(NQ-1)``.
3. :func:`quantize_threshold_table` — SystemC style: Nq levels with the
   endpoints included and thresholds at the midpoints; a value exactly on
   a threshold takes the lower level.

Saturation is a plain clip and composes with any of them.

The JAX functions take ``ymax`` and the derived steps as weakly typed
Python floats, so they meet the samples as f32 values.  Here every scalar
is made an f32 tensor on the samples' device first: PyTorch's CUDA division
by a Python scalar runs as a multiply by its reciprocal, which is not the
correctly rounded quotient.  Signed zeros follow the JAX functions: ``sgn``
is +1 for x >= 0 (−0.0 included), so a negative sample that rounds to zero
keeps its sign as −0.0.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "quantize_no_zero",
    "quantize_round",
    "quantize_threshold_table",
    "saturate",
]


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-dim f32 tensor on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _sgn_pos(x: torch.Tensor) -> torch.Tensor:
    """sgn with sgn(0) = +1 (−0.0 counts as +1)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def saturate(x: torch.Tensor, ymax: float) -> torch.Tensor:
    """Clip to ±Ymax (the reference's saturateSamples flag)."""
    m = _f32(ymax, x)
    return torch.clamp(x, -m, m)


def quantize_no_zero(x: torch.Tensor, ymax: float, nq) -> torch.Tensor:
    """Min-sum/DDBMP quantizer: Nq levels, no zero level."""
    s = _sgn_pos(x)
    lsb = _f32(2.0 * ymax / (nq - 1.0), x)
    q = s * torch.floor(x.abs() / lsb) * lsb
    q = torch.where(q == 0.0, s * lsb, q)
    ym = _f32(ymax, x)
    return torch.where(x.abs() > ym, s * ym, q)


def quantize_round(x: torch.Tensor, ymax: float, nq_bits: int) -> torch.Tensor:
    """GDBF quantizer: round to nearest on NQ bits (no saturation)."""
    step = _f32(ymax / 2.0 ** (nq_bits - 1), x)
    return _sgn_pos(x) * torch.floor(x.abs() / step + 0.5) * step


def quantize_threshold_table(x: torch.Tensor, ymax: float,
                             nq_levels: int) -> torch.Tensor:
    """SystemC quantizer: an explicit threshold table and a strict-compare
    count, so ties take the lower level without derived arithmetic.  The
    count of thresholds below x is a binary search (``bucketize``), the
    same integer as the JAX function's comparison sum."""
    delta = 2.0 * ymax / (nq_levels - 1.0)
    thresholds = (
        -ymax * (nq_levels - 2.0) / (nq_levels - 1.0)
        + np.arange(nq_levels - 1) * delta
    )
    values = np.concatenate([-ymax + np.arange(nq_levels - 1) * delta, [ymax]])
    thr = torch.tensor(thresholds, dtype=x.dtype, device=x.device)
    k = torch.bucketize(x.contiguous(), thr)  # #{thresholds < x}
    return torch.tensor(values, dtype=x.dtype, device=x.device)[k]
