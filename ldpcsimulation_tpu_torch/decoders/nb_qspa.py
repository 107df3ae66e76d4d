"""Non-binary FFT-QSPA: GF(2^m) sum-product with Hadamard-domain checks.

Port of ``ldpcsimulation_tpu.decoders.nb_qspa`` (which cites the
reference's unfinished NB-LDPC tree and Davey–MacKay 1998).  Because
GF(2^m)'s additive group is (Z_2)^m, the check constraint Σ h_e·x_e = 0 is
a group convolution that the Walsh–Hadamard transform diagonalizes:

  CN:  per edge, rescale P_x by the edge coefficient, WHT, multiply the
       *other* edges' transforms (prefix/suffix products, exact exclusion),
       inverse WHT, inverse rescale;
  VN:  channel prior times the other edges' messages (log-domain
       prefix/suffix sums, max-normalized);
  decision: argmax of the posterior (the first maximum, in both
       packages); stop when H·z = 0 over GF(q).

Messages between the updates are log-domain, stored in ``storage_dtype``
(f16 halves the gather traffic) with f32 arithmetic; the CN output's log
carries ``eps = 1e-30`` added in the arithmetic dtype.  The three CN forms
of the JAX machine are kept, with their operation orders:

  * q ≤ 4: the rescale and the WHT fused into one ±1 combination per
    coefficient class, as adds and negations selected by class
    (:func:`_class_combine`);
  * 4 < q ≤ 8: the same combination as a multiply-add unroll against the
    per-slot sign tables (:func:`_signed_combine`);
  * q > 8: the coefficient permutation and butterfly WHTs
    (:func:`_gf2m_wht`).

The small-q forms run column by column over the check degree, as the JAX
machine does.  Sums whose order PyTorch does not fix (the posterior's sum
over the variable degree) are written out as sequential adds, so on the
card a frame's values do not depend on the batch it is in (a stream lane
equals its batch decode).  Decisions are int8 for q ≤ 128 (int32 above)
and int32 in the result.

Left behind: ``FLAT_GATHER`` (a TPU layout choice; the row gathers are
kept).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codes.code import Code
from ..codes.gf import gf_tables

__all__ = ["NBDecodeResult", "decode_nb_qspa", "nb_qspa_machine", "wht"]

#: the largest q whose CN rescale + WHT is a fused ±1 combination
_FUSED_QMAX = 8
#: added to the CN output before its log, in the arithmetic dtype
EPS = 1e-30


@dataclasses.dataclass
class NBDecodeResult:
    """symbols: [B, N] int32 hard GF-symbol decisions; iterations [B]
    int32; satisfied [B] bool."""

    symbols: torch.Tensor
    iterations: torch.Tensor
    satisfied: torch.Tensor


def _gf2m_wht(x: torch.Tensor) -> torch.Tensor:
    """WHT over the last axis (length q = 2^m), bit-plane butterflies.
    Diagonalizes XOR convolution; self-inverse up to a factor q."""
    q = x.shape[-1]
    m = q.bit_length() - 1
    if 2 ** m != q:
        raise ValueError(f"WHT length {q} is not a power of two")
    shape = x.shape
    for i in range(m):
        x = x.reshape(shape[:-1] + (q >> (i + 1), 2, 1 << i))
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2).reshape(shape)
    return x


def wht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The WHT along ``axis``; see :func:`_gf2m_wht`."""
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    return torch.movedim(_gf2m_wht(x), -1, axis)


@functools.lru_cache(maxsize=None)
def _wht_sign_tables(q: int):
    """Constant [q, q, q] f32 tables fwd[h, w, c] = (−1)^pc(w & (h⊗c)) and
    inv[h, a, c] = (−1)^pc((h⊗a) & c): the coefficient rescale and the WHT
    as one ±1 linear map, each way."""
    mul_np, _ = gf_tables(q)
    idx = np.arange(q)
    pc = np.array([bin(i).count("1") for i in range(q)])
    par = np.where(pc[idx[:, None] & idx[None, :]] % 2 == 0, 1.0, -1.0)
    fwd = par[:, mul_np].transpose(1, 0, 2)
    inv = par[mul_np]
    return (np.ascontiguousarray(fwd.astype(np.float32)),
            np.ascontiguousarray(inv.astype(np.float32)))


def _signed_combine(sgn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[s, w, b] = Σ_c sgn[s, w, c] · x[s, c, b], accumulated in c order."""
    q = x.shape[1]
    acc = sgn[:, :, 0, None] * x[:, None, 0, :]
    for c in range(1, q):
        acc = acc + sgn[:, :, c, None] * x[:, None, c, :]
    return acc


def _class_combine(h: torch.Tensor, x: torch.Tensor, tbl: np.ndarray):
    """y[s, w, b] = Σ_c tbl[h_s, w, c] · x[s, c, b]: for each coefficient
    class a static add/negate unroll (c ascending), selected by the slot's
    class ``h`` [s]."""
    q = x.shape[1]

    def static_combine(hc):
        cols = []
        for w in range(q):
            acc = None
            for c in range(q):
                t = x[:, c] if tbl[hc, w, c] > 0 else -x[:, c]
                acc = t if acc is None else acc + t
            cols.append(acc)
        return torch.stack(cols, dim=1)

    out = static_combine(1)
    for hc in range(2, q):
        out = torch.where((h == hc)[:, None, None], static_combine(hc), out)
    return out


@dataclasses.dataclass(frozen=True)
class _Tables:
    """The machine's index and coefficient tables on one device."""

    h_cols: torch.Tensor      # [M, dc_max] long, coefficient per CN slot
    pre_idx: torch.Tensor     # [slots, q] long: P_u[b] = P_x[h^-1 b]
    post_idx: torch.Tensor    # [slots, q] long: P_out[a] = P_s[h a]
    cn_gather: torch.Tensor   # [slots] long
    vn_gather: torch.Tensor   # [N·dv_max] long
    cn_vn: torch.Tensor       # [slots] long, VN id per CN slot
    cn_mask: torch.Tensor     # [M, dc_max] bool
    vn_mask: torch.Tensor     # [N·dv_max, 1, 1] bool
    fwd_s: torch.Tensor       # [M, dc_max, q, q] f32 (4 < q ≤ 8), else empty
    inv_s: torch.Tensor
    mconst: torch.Tensor      # [slots, m, m] symbol dtype, bit j of h·2^i
    syn_mask: torch.Tensor    # [slots, 1] symbol dtype


def _tables(code: Code, q: int, sym_dt, device) -> _Tables:
    mul_np, inv_np = gf_tables(q)
    h_np = code.cn_coef.cpu().numpy().astype(np.int64)  # 1 on padding
    h_flat = h_np.reshape(-1)
    m_bits = q.bit_length() - 1

    def t(a, dt=torch.long):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    if 4 < q <= _FUSED_QMAX:
        fwd_tbl, inv_tbl = _wht_sign_tables(q)
        fwd_s = t(fwd_tbl[h_np], torch.float32)
        inv_s = t(inv_tbl[h_np], torch.float32)
    else:
        fwd_s = inv_s = torch.empty(0, device=device)
    mcols = [mul_np[h_flat, 1 << i] for i in range(m_bits)]  # [slots] each
    mconst = np.stack(
        [np.stack([(mcols[i] >> j) & 1 for i in range(m_bits)], axis=-1)
         for j in range(m_bits)], axis=-2)  # [slots, m (out j), m (in i)]
    cn_mask = code.cn_mask.to(device)
    return _Tables(
        h_cols=t(h_np),
        pre_idx=t(mul_np[inv_np[h_flat]]),
        post_idx=t(mul_np[h_flat]),
        cn_gather=code.cn_from_vn.reshape(-1).to(device, torch.long),
        vn_gather=code.vn_from_cn.reshape(-1).to(device, torch.long),
        cn_vn=code.cn_vn.reshape(-1).to(device, torch.long),
        cn_mask=cn_mask,
        vn_mask=code.vn_mask.reshape(-1)[:, None, None].to(device),
        fwd_s=fwd_s,
        inv_s=inv_s,
        mconst=t(mconst, sym_dt),
        syn_mask=cn_mask.reshape(-1).to(sym_dt)[:, None],
    )


def nb_qspa_machine(code: Code, q: int, dtype=torch.float32,
                    storage_dtype=None):
    """The FFT-QSPA updates as functions of their inputs (the JAX
    ``nb_qspa_machine``'s operations), for the batch decoder and the
    stream adapter alike.  Tensors keep the batch on the last axis; the
    tables are built on each input's device at first use.

      * ``cn_update(v2c, log_pri=None, fresh=None)`` — [N·dv_max, q, B]
        log → [M·dc_max, q, B] log; ``fresh`` [B] bool (with ``log_pri``)
        makes those lanes read every slot as its variable's prior, as
        merging ``init(log_pri)`` into v2c first would, on the gathered
        rows;
      * ``vn_update(c2v, log_pri)`` → (v2c log, log posterior [N, q, B]);
      * ``decide(log_post)`` → [N, B] symbols (int8 for q ≤ 128);
      * ``syndrome_ok(symbols)`` → [B] bool, H·z == 0 over GF(q) (the
        bit-plane linear form);
      * ``init(log_pri)`` — the initial v2c planes;
      * ``log_of(pri)`` — max-normalized log priors of [N, q, B]
        probabilities.
    """
    sdtype = storage_dtype or dtype
    sym_dt = torch.int8 if q <= 128 else torch.int32
    m, n, dc, dv = code.m, code.n, code.dc_max, code.dv_max
    m_bits = q.bit_length() - 1

    @functools.lru_cache(maxsize=None)
    def tables(device):
        return _tables(code, q, sym_dt, device)

    def eps(device):  # a fill, not a host copy: no sync on the card
        return torch.full((), EPS, dtype=dtype, device=device)

    fwd_tbl, inv_tbl = _wht_sign_tables(q)

    def combine(tb, t, x, inverse):
        """The fused rescale + WHT (or its inverse) of CN column t."""
        if q <= 4:
            return _class_combine(tb.h_cols[:, t], x,
                                  inv_tbl if inverse else fwd_tbl)
        return _signed_combine((tb.inv_s if inverse else tb.fwd_s)[:, t], x)

    def exclusion_products(f, shape):
        ones = torch.ones(shape, dtype=dtype, device=f[0].device)
        pre = [ones]
        for t in range(dc - 1):
            pre.append(pre[-1] * f[t])
        suf = [ones]
        for t in range(dc - 1, 0, -1):
            suf.append(suf[-1] * f[t])
        suf.reverse()
        return pre, suf

    def cn_update(v2c, log_pri=None, fresh=None):
        tb = tables(v2c.device)
        b = v2c.shape[-1]
        g = v2c[tb.cn_gather]  # [M·dc_max, q, B]
        if fresh is not None:
            gi = log_pri.to(sdtype)[tb.cn_vn]
            g = torch.where(fresh[None, None, :], gi, g)
        g = torch.exp(g.to(dtype))
        e = eps(g.device)
        if q <= _FUSED_QMAX:
            gs = g.reshape(m, dc, q, b)
            f = []
            for t in range(dc):
                ft = combine(tb, t, gs[:, t], False)
                f.append(torch.where(tb.cn_mask[:, t, None, None], ft,
                                     torch.ones_like(ft)))
            pre, suf = exclusion_products(f, (m, q, b))
            outs = []
            for t in range(dc):
                o = combine(tb, t, pre[t] * suf[t], True)
                o = torch.clamp_min(o, 0.0)
                outs.append(torch.log(o + e).to(sdtype))
            return torch.stack(outs, dim=1).reshape(m * dc, q, b)
        # the coefficient rescale; a padding slot becomes the delta at 0
        # (the additive identity: a non-edge's contribution)
        g = torch.gather(g, 1, tb.pre_idx[:, :, None].expand(-1, -1, b))
        delta0 = (torch.arange(q, device=g.device) == 0).to(dtype)
        g = torch.where(tb.cn_mask.reshape(-1)[:, None, None], g,
                        delta0[None, :, None])
        f = _gf2m_wht(torch.movedim(g, 1, -1))  # [slots, B, q]
        f = f.reshape(m, dc, b, q)
        pre, suf = exclusion_products([f[:, t] for t in range(dc)],
                                      (m, b, q))
        excl = torch.stack([pre[t] * suf[t] for t in range(dc)], dim=1)
        s = _gf2m_wht(excl.reshape(m * dc, b, q))
        s = torch.movedim(s, -1, 1)  # [slots, q, B]: inverse WHT · q
        out = torch.gather(s, 1, tb.post_idx[:, :, None].expand(-1, -1, b))
        out = torch.clamp_min(out, 0.0)
        return torch.log(out + e).to(sdtype)

    def vn_update(c2v, log_pri):
        tb = tables(c2v.device)
        b = c2v.shape[-1]
        g = c2v[tb.vn_gather]  # [N·dv_max, q, B]
        logg = torch.where(tb.vn_mask, g.to(dtype),
                           torch.zeros((), dtype=dtype, device=g.device))
        logg = logg.reshape(n, dv, q, b)
        zeros = torch.zeros((n, q, b), dtype=dtype, device=g.device)
        pre = [zeros]
        for s in range(dv - 1):
            pre.append(pre[-1] + logg[:, s])
        suf = [zeros]
        for s in range(dv - 1, 0, -1):
            suf.append(suf[-1] + logg[:, s])
        suf.reverse()
        if q <= _FUSED_QMAX:
            outs = []
            for s in range(dv):
                excl = log_pri + pre[s] + suf[s]
                excl = excl - torch.amax(excl, dim=1, keepdim=True)
                outs.append(excl.to(sdtype))
            v2c = torch.stack(outs, dim=1).reshape(n * dv, q, b)
        else:
            excl = torch.stack([log_pri + pre[s] + suf[s]
                                for s in range(dv)], dim=1)
            excl = excl - torch.amax(excl, dim=2, keepdim=True)
            v2c = excl.to(sdtype).reshape(n * dv, q, b)
        total = logg[:, 0]
        for s in range(1, dv):
            total = total + logg[:, s]
        return v2c, log_pri + total

    def decide(log_post):
        return torch.argmax(log_post, dim=1).to(sym_dt)  # [N, B]

    def syndrome_ok(symbols):
        tb = tables(symbols.device)
        b = symbols.shape[-1]
        s = symbols[tb.cn_vn]  # [slots, B]
        sbits = [(s >> i) & 1 for i in range(m_bits)]
        hs = torch.zeros_like(s)
        for j in range(m_bits):
            bit = torch.zeros_like(s)
            for i in range(m_bits):
                bit = bit ^ (sbits[i] * tb.mconst[:, j, i][:, None])
            hs = hs | (bit << j)
        hs = (hs * tb.syn_mask).reshape(m, dc, b)
        acc = hs[:, 0]
        for t in range(1, dc):
            acc = acc ^ hs[:, t]
        return (acc == 0).all(dim=0)

    def init(log_pri):
        b = log_pri.shape[-1]
        return log_pri.to(sdtype)[:, None].expand(n, dv, q, b).reshape(
            n * dv, q, b)

    def log_of(pri):
        lp = torch.log(pri + eps(pri.device))
        return lp - torch.amax(lp, dim=1, keepdim=True)

    return dict(cn_update=cn_update, vn_update=vn_update, decide=decide,
                syndrome_ok=syndrome_ok, init=init, log_of=log_of)


def decode_nb_qspa(
    code: Code,
    priors: torch.Tensor,
    num_iterations: int,
    q: int = 0,
    early_termination: bool = True,
    storage_dtype=None,
) -> NBDecodeResult:
    """Batched FFT-QSPA decode.

    priors: [B, N, q] channel symbol probabilities (:mod:`..channel.nb`),
    on the device the decode runs on; the arithmetic is in their dtype.
    q: the field order (default ``code.q``).  storage_dtype: an optional
    narrower type (torch.float16) for the message planes between updates.
    With early termination the host reads "every frame done" once per
    iteration; only the symbol carry is masked (a satisfied frame's
    messages go on evolving, and nothing reads them).
    """
    q = q or code.q
    pri = priors.permute(1, 2, 0).contiguous()  # [N, q, B]
    n, qq, b = pri.shape
    if qq != q or n != code.n:
        raise ValueError(f"priors {tuple(priors.shape)} do not match the "
                         f"code (N={code.n}, q={q})")
    M = nb_qspa_machine(code, q, pri.dtype, storage_dtype)
    log_pri = M["log_of"](pri)
    decide, syndrome_ok = M["decide"], M["syndrome_ok"]

    def step(v2c):
        c2v = M["cn_update"](v2c)
        v2c, log_post = M["vn_update"](c2v, log_pri)
        return v2c, decide(log_post)

    v2c = M["init"](log_pri)
    sym = decide(log_pri)
    if not early_termination:
        for _ in range(num_iterations):
            v2c, sym = step(v2c)
        iters = torch.full((b,), num_iterations, dtype=torch.int32,
                           device=pri.device)
        done = syndrome_ok(sym)
    else:
        done = syndrome_ok(sym)
        iters = torch.zeros((b,), dtype=torch.int32, device=pri.device)
        t = 0
        while t < num_iterations and not bool(done.all()):
            v2c, sym_new = step(v2c)
            act = ~done
            sym = torch.where(act[None, :], sym_new, sym)
            iters = torch.where(act, t + 1, iters).to(torch.int32)
            done = done | syndrome_ok(sym)
            t += 1
    return NBDecodeResult(symbols=sym.t().to(torch.int32), iterations=iters,
                          satisfied=done)
