"""Non-binary min-sum (max-log QSPA) and min-max decoders over GF(2^m).

Port of ``ldpcsimulation_tpu.decoders.nb_minsum`` (which cites the
reference's unfinished ``min_max.py``).  Messages are normalized
negative-log-likelihood vectors over GF(q) (0 = most likely).  The check
constraint Σ h_e·x_e = 0 becomes a (min, op)-convolution over the XOR
group,

    out[s] = min over configurations with ⊕ = s of op(inputs),

with op = sum (NB min-sum) or max (min-max), evaluated with exact
prefix/suffix pairwise convolutions (O(dc·q²) per check).  Per-edge
coefficients permute indices as in :mod:`.nb_qspa`.

After the negative log of the priors the decoders only select, add and
take minima, so on the same negative-log inputs they equal the JAX
decoders bit for bit (:func:`decode_nb_minsum_nll` takes them directly).
A decoder of the library API only: the JAX package runs it through no
harness and no sweep route, and neither does the port.
"""

from __future__ import annotations

import torch

from ..codes.code import Code
from ..codes.gf import gf_tables
from .base import run_flooding
from .nb_qspa import EPS, NBDecodeResult

__all__ = ["decode_nb_minsum", "decode_nb_minsum_nll", "nb_nll"]

#: the "impossible" negative log of the XOR-convolution's neutral element
BIGINF = 1e30


def _pairwise_conv(a: torch.Tensor, b: torch.Tensor, op: str):
    """(min, op)-convolution over XOR along the last axis:
    out[k] = min_j op(a[k ^ j], b[j]), as q steps of a static XOR
    permutation of ``a``."""
    q = a.shape[-1]
    out = None
    for j in range(q):
        perm = torch.arange(q, device=a.device) ^ j
        aj = a[..., perm]
        bj = b[..., j:j + 1]
        term = aj + bj if op == "sum" else torch.maximum(aj, bj)
        out = term if out is None else torch.minimum(out, term)
    return out


def nb_nll(priors: torch.Tensor) -> torch.Tensor:
    """[B, N, q] probabilities -> the decoders' normalized negative logs,
    [N, q, B] (minimum 0 per symbol)."""
    pri = priors.permute(1, 2, 0)
    eps = torch.full((), EPS, dtype=pri.dtype, device=pri.device)
    nll = -torch.log(pri + eps)
    return nll - torch.amin(nll, dim=1, keepdim=True)


def decode_nb_minsum(
    code: Code,
    priors: torch.Tensor,
    num_iterations: int,
    variant: str = "minsum",
    q: int = 0,
    early_termination: bool = True,
) -> NBDecodeResult:
    """Batched NB min-sum / min-max decode of [B, N, q] channel symbol
    probabilities; variant "minsum" or "minmax"."""
    return decode_nb_minsum_nll(code, nb_nll(priors), num_iterations,
                                variant, q, early_termination)


def decode_nb_minsum_nll(
    code: Code,
    nll: torch.Tensor,
    num_iterations: int,
    variant: str = "minsum",
    q: int = 0,
    early_termination: bool = True,
) -> NBDecodeResult:
    """:func:`decode_nb_minsum` from the normalized negative logs
    ``nll`` [N, q, B] (:func:`nb_nll`)."""
    if variant not in ("minsum", "minmax"):
        raise ValueError(f"unknown variant {variant!r}")
    op = "sum" if variant == "minsum" else "max"
    q = q or code.q
    n, qq, b = nll.shape
    if qq != q or n != code.n:
        raise ValueError(f"nll {tuple(nll.shape)} does not match the code "
                         f"(N={code.n}, q={q})")
    dev, dtype = nll.device, nll.dtype
    m, dc, dv = code.m, code.dc_max, code.dv_max
    mul_np, inv_np = gf_tables(q)
    mul = torch.as_tensor(mul_np, device=dev).long()
    inv = torch.as_tensor(inv_np, device=dev).long()

    h_cn = code.cn_coef.reshape(-1).to(dev, torch.long)
    # L_u[s] = L_x[h^-1 s] before the convolution, L_out[a] = L_s[h a] after
    pre_idx = mul[inv[h_cn]][:, :, None].expand(-1, -1, b)
    post_idx = mul[h_cn][:, :, None].expand(-1, -1, b)
    hmul = mul[h_cn]  # [slots, q]
    cn_gather = code.cn_from_vn.reshape(-1).to(dev, torch.long)
    vn_gather = code.vn_from_cn.reshape(-1).to(dev, torch.long)
    cn_vn = code.cn_vn.reshape(-1).to(dev, torch.long)
    cn_mask = code.cn_mask.reshape(-1).to(dev)
    vn_mask = code.vn_mask.reshape(-1)[:, None, None].to(dev)
    # the neutral element of the XOR convolution: NLL (0, inf, inf, ...)
    neutral_q = torch.full((q,), BIGINF, dtype=dtype, device=dev).masked_fill(
        torch.arange(q, device=dev) == 0, 0.0)

    def cn_update(v2c):
        g = v2c[cn_gather]  # [M·dc_max, q, B]
        g = torch.gather(g, 1, pre_idx)
        g = torch.where(cn_mask[:, None, None], g, neutral_q[None, :, None])
        f = torch.movedim(g, 1, -1).reshape(m, dc, b, q)
        neutral = neutral_q.expand(m, b, q)
        pre = [neutral]
        for t in range(dc - 1):
            pre.append(_pairwise_conv(pre[-1], f[:, t], op))
        suf = [neutral]
        for t in range(dc - 1, 0, -1):
            suf.append(_pairwise_conv(suf[-1], f[:, t], op))
        suf.reverse()
        excl = torch.stack([_pairwise_conv(pre[t], suf[t], op)
                            for t in range(dc)], dim=1)  # [M, dc, B, q]
        s = torch.movedim(excl.reshape(m * dc, b, q), -1, 1)  # [slots, q, B]
        out = torch.gather(s, 1, post_idx)
        return out - torch.amin(out, dim=1, keepdim=True)

    def vn_update(c2v):
        g = c2v[vn_gather]
        g = torch.where(vn_mask, g, torch.zeros_like(g))
        g = g.reshape(n, dv, q, b)
        zeros = torch.zeros((n, q, b), dtype=dtype, device=dev)
        pre = [zeros]
        for s in range(dv - 1):
            pre.append(pre[-1] + g[:, s])
        suf = [zeros]
        for s in range(dv - 1, 0, -1):
            suf.append(suf[-1] + g[:, s])
        suf.reverse()
        excl = torch.stack([nll + pre[s] + suf[s] for s in range(dv)], dim=1)
        excl = excl - torch.amin(excl, dim=2, keepdim=True)
        total = g[:, 0]
        for s in range(1, dv):
            total = total + g[:, s]
        return excl.reshape(n * dv, q, b), nll + total

    def decide(post):
        return torch.argmin(post, dim=1).to(torch.int32)

    def syndrome_ok(symbols):
        s = symbols[cn_vn].long()  # [slots, B]
        hs = torch.gather(hmul, 1, s)
        hs = torch.where(cn_mask[:, None], hs, 0).reshape(m, dc, b)
        acc = hs[:, 0]
        for t in range(1, dc):
            acc = acc ^ hs[:, t]
        return (acc == 0).all(dim=0)

    def step(st):
        v2c, _sym = st
        v2c_new, post = vn_update(cn_update(v2c))
        return v2c_new, decide(post)

    v2c0 = nll[:, None].expand(n, dv, q, b).reshape(n * dv, q, b)
    sym, iters, done = run_flooding(
        (v2c0, decide(nll)), step, lambda st: st[1], syndrome_ok,
        num_iterations, early_termination, b,
    )
    return NBDecodeResult(symbols=sym.t().to(torch.int32), iterations=iters,
                          satisfied=done)
