"""Kernel B2: keyed AWGN samples of the all-(+1) word (``csrc/awgn_philox.cu``).

Port of ``ldpcsimulation_tpu.kernels.channel_pallas.awgn_all_zero_pallas``.
Frame ``f`` of seed ``s`` draws its noise from Philox4x32-10 with key ``s``
and counter ``(pair j, f lo, f hi, 0)``: each call gives two Box–Muller
pairs, for columns 2j and 2j+1.  The frame's samples are a pure function of
(seed, frame index), whatever the batch.

:func:`awgn_philox` launches the CUDA kernel for a CUDA device and runs the
plain twin :func:`awgn_philox_plain` for the CPU.  The twin computes the
same Philox integers (int64 tensor arithmetic, 16-bit limbs for the 32×32
products) and the same f32 operations in the same order; only ``log`` and
``cos`` come from another math library, so y agrees to a few ulps.
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = ["philox4x32_10", "awgn_philox", "awgn_philox_plain"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi  # rounded to f32 where it meets an f32 tensor
_U64 = 1 << 64


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product m·a (m, a < 2^32).

    int64 cannot hold the product, so ``a`` is split into 16-bit limbs:
    each partial product stays below 2^48."""
    lo_part = (a & 0xFFFF) * m
    hi_part = (a >> 16) * m
    t = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding u32 words.

    ctr: four broadcastable int64 tensors (or ints); key: two ints.
    Returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_args(seed, frame0, batch, n):
    if not 0 <= seed < _U64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    if batch < 0 or n < 0:
        raise ValueError(f"bad shape [{batch}, {n}]")
    if frame0 < 0 or frame0 + batch > _U64:
        raise ValueError(f"frames {frame0}..{frame0 + batch} outside [0, 2^64)")


def awgn_philox_plain(seed: int, frame0: int, batch: int, n: int,
                      sigma: float, device="cpu", with_bits: bool = False):
    """Plain PyTorch twin of the kernel (same integers, same f32 steps)."""
    _check_args(seed, frame0, batch, n)
    npairs = (n + 1) // 2
    j = torch.arange(npairs, dtype=torch.int64, device=device)[None, :]
    f = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    # frame0 + row may pass 2^63: form the two counter words exactly
    f_lo = (f + (frame0 & _MASK32)) & _MASK32
    carry = (f + (frame0 & _MASK32)) >> 32
    f_hi = (carry + (frame0 >> 32)) & _MASK32
    x0, x1, x2, x3 = philox4x32_10(
        (j, f_lo, f_hi, 0), (seed & _MASK32, seed >> 32)
    )
    ka = torch.stack([x0, x2], dim=-1).reshape(batch, 2 * npairs)[:, :n] >> 8
    kb = torch.stack([x1, x3], dim=-1).reshape(batch, 2 * npairs)[:, :n] >> 8
    u1 = (ka.to(torch.float32) + 0.5) * 2.0 ** -24
    u2 = (kb.to(torch.float32) + 0.5) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    y = 1.0 + sigma * (r * torch.cos(_TWO_PI * u2))
    if with_bits:
        return y, torch.stack([ka, kb], dim=-1).to(torch.int32)
    return y


def awgn_philox(seed: int, frame0: int, batch: int, n: int, sigma: float,
                device, with_bits: bool = False):
    """[batch, n] f32 samples y = 1 + σ·n for frames frame0 … frame0+batch−1.

    ``with_bits`` also returns the [batch, n, 2] int32 24-bit integers
    (k₁, k₂) behind each sample, for checking the kernel against its twin.
    CPU: the plain twin.  CUDA: the kernel, or an exception.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return awgn_philox_plain(seed, frame0, batch, n, sigma, device,
                                 with_bits)
    if device.type != "cuda":
        raise ValueError(f"awgn_philox: unsupported device {device}")
    _check_args(seed, frame0, batch, n)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    y = torch.empty((batch, n), dtype=torch.float32, device=device)
    bits = (
        torch.empty((batch, n, 2), dtype=torch.int32, device=device)
        if with_bits else None
    )
    rc = build.library().ldpc_awgn_philox(
        seed, frame0, batch, n, sigma, y.data_ptr(),
        bits.data_ptr() if with_bits else None, device.index,
        build.stream_of(device),
    )
    build.check(rc, "awgn_philox")
    build.LAUNCHES["awgn_philox"] += 1
    return (y, bits) if with_bits else y
