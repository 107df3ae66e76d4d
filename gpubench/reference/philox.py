"""Keyed Philox4x32-10 draws, written out in plain PyTorch.

Philox4x32-10 is the counter-based generator of Salmon, Moraes, Dror and
Shaw, "Parallel random numbers: as easy as 1, 2, 3" (SC'11), with the
Random123 constants.  The run seed is the key (low word, high word); the
counter names what is drawn:

* the channel of frame ``f``: counter ``(j, f lo, f hi, 0)``, whose four
  words give two Box-Muller pairs, columns ``2j`` and ``2j + 1``:
  ``u = (k + 0.5)·2⁻²⁴`` with ``k = word >> 8``, ``y = 1 + σ·(√(−2 ln u₁)·
  cos(2π u₂))``;
* the decoders' noise of frame ``f`` at step ``t``: counter ``(j, f lo, f hi,
  1 + 2t)``, whose four words give columns ``4j … 4j + 3``, each
  ``0 + scale·(√2·erfinv(2u − 1))``.

Every operation is one f32 operation, rounded, in the order written here.
Products of two 32-bit words do not fit an int64, so ``_mul`` splits the
word into 16-bit halves.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mul(m: int, a: torch.Tensor):
    """(high, low) words of the 64-bit product of ``m`` and ``a``."""
    lo = (a & 0xFFFF) * m
    hi = (a >> 16) * m
    low = lo + ((hi & 0xFFFF) << 16)
    return (hi >> 16) + (low >> 32), low & _MASK


def philox(c0, c1, c2, c3, seed: int):
    """The four output words of Philox4x32-10 (int64 tensors in [0, 2³²))
    for the counter words ``c0 … c3`` (broadcastable int64 tensors)."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        h0, l0 = _mul(_M0, c0)
        h1, l1 = _mul(_M1, c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def _frames(frames: torch.Tensor):
    f = frames.to(torch.int64)[:, None]
    return f & _MASK, (f >> 32) & _MASK


def _uniform(k: torch.Tensor) -> torch.Tensor:
    return (k.to(torch.float32) + 0.5) * 2.0 ** -24


def channel(seed: int, frames: torch.Tensor, n: int,
            sigma: float) -> torch.Tensor:
    """[F, n] f32 samples ``1 + σ·noise`` of the all-(+1) word for the
    frames ``frames`` ([F] int64)."""
    lo, hi = _frames(frames)
    j = torch.arange((n + 1) // 2, device=frames.device)[None, :]
    x0, x1, x2, x3 = philox(j, lo, hi, torch.zeros_like(j), seed)
    rows = frames.shape[0]
    k1 = torch.stack([x0, x2], -1).reshape(rows, -1)[:, :n] >> 8
    k2 = torch.stack([x1, x3], -1).reshape(rows, -1)[:, :n] >> 8
    u1, u2 = _uniform(k1), _uniform(k2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return 1.0 + sigma * (r * torch.cos(2.0 * math.pi * u2))


def decoder_noise(seed: int, frames: torch.Tensor, n: int, step: int,
                  scale: float) -> torch.Tensor:
    """[n, F] f32 perturbation ``scale·√2·erfinv(2u − 1)`` of step
    ``step`` for the frames ``frames``."""
    lo, hi = _frames(frames)
    j = torch.arange((n + 3) // 4, device=frames.device)[None, :]
    words = philox(j, lo, hi, torch.full_like(j, 1 + 2 * step), seed)
    k = torch.stack(words, -1).reshape(frames.shape[0], -1)[:, :n] >> 8
    t = 2.0 * _uniform(k) - 1.0
    return (0.0 + scale * (math.sqrt(2.0) * torch.erfinv(t))).t()
