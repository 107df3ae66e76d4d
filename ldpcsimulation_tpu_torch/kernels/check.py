"""Kernel B6: the parity check (``csrc/parity_check.cu``).

No Pallas original: it replaces the XLA fusions of the JAX package's
parity checks — ``decoders.minsum_qc.qc_check_satisfied``,
``decoders.qc_ops.qc_syndrome_bipolar``, ``decoders.base.
syndrome_from_hard`` and ``check_satisfied`` — in one integer pass.  The
table ``cols [M, dc]`` (int64) names the column of each check slot, the
sentinel ``N`` in an absent slot (a column that is never negative); the
decisions ``d [N, B]`` are int8 or int32, batch last.  Every output is
exact: a check is odd when an odd number of its named decisions are
negative.

:func:`parity_check` launches the kernel for CUDA tensors and runs
:func:`parity_check_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import build

__all__ = ["parity_check", "parity_check_plain", "check_lane_width"]

_DTYPES = (torch.int8, torch.int32)


def _check(cols, d):
    if cols.dim() != 2 or cols.dtype != torch.int64:
        raise ValueError(f"cols must be [M, dc] int64, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    if d.dim() != 2 or d.dtype not in _DTYPES:
        raise ValueError(f"d must be [N, B] int8/int32, got "
                         f"{tuple(d.shape)} {d.dtype}")
    if cols.device != d.device:
        raise ValueError(f"cols on {cols.device}, d on {d.device}")
    if not (cols.is_contiguous() and d.is_contiguous()):
        raise ValueError("cols and d must be contiguous")


def check_lane_width(d: torch.Tensor) -> int:
    """Lanes per thread of the instance that takes ``d``: one 16-byte load
    a row (16 int8 or 4 int32 lanes) where the batch is a multiple of that
    and d's address is 16-byte aligned, else 1."""
    lanes = 16 // d.element_size()
    if d.shape[1] % lanes == 0 and d.data_ptr() % 16 == 0:
        return lanes
    return 1


def parity_check_plain(cols, d, syndrome=False):
    """Plain PyTorch twin of kernel B6: the XOR of each check's negative
    decisions, over a copy of d's sign with a sentinel row appended."""
    _check(cols, d)
    neg = torch.cat([d < 0, d.new_zeros((1, d.shape[1]), dtype=torch.bool)])
    odd = neg[cols[:, 0]]
    for t in range(1, cols.shape[1]):
        odd = odd ^ neg[cols[:, t]]
    sat = ~odd.any(dim=0)
    if not syndrome:
        return sat
    one = torch.ones((), dtype=d.dtype, device=d.device)
    return sat, torch.where(odd, -one, one)


def parity_check(cols, d, syndrome=False):
    """``satisfied [B]`` bool (every check's parity is even) from the
    ±1 decisions ``d [N, B]`` through ``cols [M, dc]``; with ``syndrome``,
    ``(satisfied, syn)``, ``syn [M, B]`` the bipolar syndrome (+1
    satisfied) in d's dtype.

    CPU tensors: the plain twin.  CUDA tensors: the kernel, or an
    exception.
    """
    if d.device.type == "cpu":
        return parity_check_plain(cols, d, syndrome)
    if d.device.type != "cuda":
        raise ValueError(f"parity_check: unsupported device {d.device}")
    _check(cols, d)
    m, dc = cols.shape
    n, batch = d.shape
    sat = torch.ones((batch,), dtype=torch.bool, device=d.device)
    syn = (torch.empty((m, batch), dtype=d.dtype, device=d.device)
           if syndrome else None)
    rc = build.library().ldpc_parity_check(
        cols.data_ptr(), m, dc, n, d.data_ptr(), int(d.dtype == torch.int8),
        batch, check_lane_width(d), sat.data_ptr(),
        None if syn is None else syn.data_ptr(), d.device.index,
        build.stream_of(d.device),
    )
    build.check(rc, "parity_check")
    build.LAUNCHES["parity_check"] += 1
    return (sat, syn) if syndrome else sat
