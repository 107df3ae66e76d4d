"""Non-binary channel front end: GF(2^m) symbols over bit-BPSK and AWGN.

Port of ``ldpcsimulation_tpu.channel.nb`` (the Davey–MacKay model the
reference's NB tree builds on): each symbol is sent as its m bits, BPSK
modulated, through AWGN; the bit posteriors combine, in the log domain,
into a probability vector over the q field elements per symbol.  The same
operations as the JAX function: the bit LLR ``4y/N0``, ``log P(0) =
−softplus(−llr)`` and ``log P(1) = −softplus(llr)`` (softplus as
``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it), each symbol's
log prior as its bit pattern's contraction with the log P(1) plus the
complement's with the log P(0), then a softmax over the field elements.
The contractions and the softmax's sum are written out as sequential
elementwise adds, so no reduction order depends on the batch's shape: on
the card a symbol's priors are the same in a stream pool and in a batch.
(On the CPU, PyTorch's vectorized ``exp``/``log1p`` take a scalar path at
a tensor's tail, an ulp away; tests that compare across shapes use sizes
with no tail.)  PyTorch's and XLA's ``exp``/``log1p`` differ by ulps, so
the two packages agree to ~1e-6, not bit for bit
(``tests/test_torch_nb.py``).
"""

from __future__ import annotations

import torch

from ..codes.gf import gf_bits

__all__ = ["symbols_to_bits", "bits_to_symbols", "symbol_priors"]


def symbols_to_bits(symbols: torch.Tensor, q: int) -> torch.Tensor:
    """[..., N] field elements -> [..., N, m] bits (LSB first)."""
    m = q.bit_length() - 1
    shifts = torch.arange(m, dtype=symbols.dtype, device=symbols.device)
    return (symbols[..., None] >> shifts) & 1


def bits_to_symbols(bits: torch.Tensor, q: int) -> torch.Tensor:
    """[..., N, m] bits (LSB first) -> [..., N] int32 field elements."""
    m = q.bit_length() - 1
    weights = 2 ** torch.arange(m, dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _contract(lp: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """out[..., n, a] = Σ_i lp[..., n, i]·bits[a, i], i ascending."""
    acc = lp[..., 0:1] * bits[:, 0]
    for i in range(1, bits.shape[1]):
        acc = acc + lp[..., i:i + 1] * bits[:, i]
    return acc


def symbol_priors(y_bits: torch.Tensor, n0, q: int) -> torch.Tensor:
    """Bit-level channel samples -> normalized symbol probabilities.

    y_bits: [..., N, m] AWGN outputs of BPSK bits (bit b -> 1 − 2b).
    Returns [..., N, q] rows summing to 1, in y_bits' dtype.
    """
    llr = 4.0 * y_bits / n0  # bit LLR, log(P0/P1)
    logp0 = -_softplus(-llr)
    logp1 = -_softplus(llr)
    patt = torch.as_tensor(gf_bits(q), device=y_bits.device).to(llr.dtype)
    logp = _contract(logp1, patt) + _contract(logp0, 1 - patt)
    e = torch.exp(logp - torch.amax(logp, dim=-1, keepdim=True))
    total = e[..., 0:1]
    for a in range(1, q):
        total = total + e[..., a:a + 1]
    return e / total
