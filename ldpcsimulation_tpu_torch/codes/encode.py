"""GF(2) linear algebra and systematic LDPC encoding.

Port of ``ldpcsimulation_tpu.codes.encode``: reduce H over GF(2), build a
systematic encoder, and batch-encode random information words on the
encoder's device.  The RREF is numpy (one-time setup); the mod-2 product
runs as an f32 matmul, exact while k < 2^24.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .code import Code, code_to_alist

__all__ = ["gf2_rref", "Encoder", "make_encoder", "random_codewords"]


def gf2_rref(h: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reduced row echelon form of a 0/1 matrix over GF(2).

    Returns (rref, pivot_cols, free_cols).  rank == len(pivot_cols); rows of
    rref beyond the rank are zero.
    """
    a = (np.asarray(h, dtype=np.uint8) & 1).copy()
    m, n = a.shape
    pivots = []
    r = 0
    for c in range(n):
        if r >= m:
            break
        rows = np.flatnonzero(a[r:, c]) + r
        if rows.size == 0:
            continue
        if rows[0] != r:
            a[[r, rows[0]]] = a[[rows[0], r]]
        # eliminate everywhere else in this column
        hit = np.flatnonzero(a[:, c])
        hit = hit[hit != r]
        a[hit] ^= a[r]
        pivots.append(c)
        r += 1
    pivot_cols = np.array(pivots, dtype=np.int64)
    free_cols = np.setdiff1d(np.arange(n), pivot_cols)
    return a, pivot_cols, free_cols


@dataclasses.dataclass
class Encoder:
    """Systematic GF(2) encoder for a parity-check matrix H.

    Information bits occupy ``free_cols`` (length k = n − rank(H)); parity
    bits occupy ``pivot_cols`` and are ``parity = info @ gen_t mod 2``.
    ``encode`` assembles the full n-bit codeword (H @ cw == 0 mod 2 by
    construction).
    """

    n: int
    k: int
    rank: int
    pivot_cols: torch.Tensor  # [rank] int64
    free_cols: torch.Tensor  # [k] int64
    gen_t: torch.Tensor  # [k, rank] f32 0/1: parity = info @ gen_t (mod 2)

    def encode(self, info: torch.Tensor) -> torch.Tensor:
        """info: [..., k] bits -> codeword [..., n] bits (uint8)."""
        info = torch.as_tensor(info, device=self.gen_t.device)
        parity = torch.remainder(info.float() @ self.gen_t, 2.0)
        cw = torch.zeros(info.shape[:-1] + (self.n,), dtype=torch.uint8,
                         device=info.device)
        cw[..., self.free_cols] = info.to(torch.uint8)
        cw[..., self.pivot_cols] = parity.to(torch.uint8)
        return cw


def make_encoder(code: Code) -> Encoder:
    """Build a systematic encoder from a Code (dense RREF; one-time setup),
    with its tables on the code's device.

    For each pivot row r with pivot column p_r, RREF gives
    ``x[p_r] = sum_f rref[r, f] * x[f] (mod 2)`` over free columns f.
    """
    device = code.cn_vn.device
    h = (code_to_alist(code).to_dense() != 0).astype(np.uint8)
    rref, pivot_cols, free_cols = gf2_rref(h)
    rank = len(pivot_cols)
    gen = rref[:rank][:, free_cols]  # [rank, k]
    return Encoder(
        n=code.n,
        k=code.n - rank,
        rank=rank,
        pivot_cols=torch.as_tensor(pivot_cols, device=device),
        free_cols=torch.as_tensor(free_cols, device=device),
        gen_t=torch.as_tensor(gen.T.astype(np.float32), device=device),
    )


def random_codewords(encoder: Encoder, generator: torch.Generator,
                     batch: int) -> torch.Tensor:
    """[batch, n] random codewords (uniform information bits drawn from
    ``generator``, which lives on the encoder's device)."""
    info = torch.randint(0, 2, (batch, encoder.k), generator=generator,
                         dtype=torch.uint8, device=encoder.gen_t.device)
    return encoder.encode(info)
