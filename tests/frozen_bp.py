"""Frozen copies of the sum-product check-update bodies as they were before
each route took kernel B8 (``csrc/bp_cn_pair.cu``): the QC update's one
row gather per slot, the slot array's CN-slot block, the stratified
update between its two grid gathers and the layered step's inline fold;
and of the QC step's variable-node side as it was before kernel B9
(``csrc/bp_vn_update.cu``): the fold over ``QCPlan.fold``, the
``total[row_col]`` gather, the clip and the saturating cast.

Each new route must equal its body bit for bit: on CPU tensors in
``tests/test_torch_bp_cn_pair.py`` and ``tests/test_torch_bp_vn.py`` (the
twins) and on the card in ``chip_smoke.py`` (the kernels).  Plain PyTorch, nothing of JAX: the card's
machine imports this module too.  The pair folds and the sign convention
are copied here as they were, so that a change to the port's fold (slot
order, neutral element, sign of zero) shows against these bodies.
"""

import torch

from ldpcsimulation_tpu_torch.decoders import qc_plan, stratified_plan
from ldpcsimulation_tpu_torch.decoders.base import (
    gather_cn,
    gather_vn,
    storage_cast,
)
from ldpcsimulation_tpu_torch.decoders.bp import MAXLLR
from ldpcsimulation_tpu_torch.decoders.bp_qc import qc_cn_bp as b8_qc_cn_bp
from ldpcsimulation_tpu_torch.decoders.minsum_layered import layered_scatter
from ldpcsimulation_tpu_torch.decoders.minsum_stratified import (
    stratified_to_cn,
    stratified_to_vn,
    stratified_zero_pad,
)


def sgn_pos(x):
    """sgn(0) = +1; -0.0 counts as +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def pair_excl_logmags(us):
    """``log(num / den)`` of each output's exclusive (s, d) pair: the
    prefix over u_0..u_{t-1} left to right and the suffix over
    u_{k-1}..u_{t+1} right to left, both from the neutral (1, 0)."""
    k = len(us)
    one = torch.ones_like(us[0])
    zero = torch.zeros_like(us[0])
    pre = [(one, zero)]
    for t in range(k - 1):
        s, d = pre[-1]
        u = us[t]
        pre.append((s + d * u, d + s * u))
    suf = [(one, zero)]
    for t in range(k - 1, 0, -1):
        s, d = suf[-1]
        u = us[t]
        suf.append((s + d * u, d + s * u))
    suf.reverse()
    return [torch.log((sp * ss + dp * ds) / (sp * ds + dp * ss))
            for (sp, dp), (ss, ds) in zip(pre, suf)]


def excl_sign_products(signs):
    """Per output the product of the other slots' ±1 signs: exclusive
    prefix times exclusive suffix."""
    k = len(signs)
    ones = torch.ones_like(signs[0])
    pre = [ones]
    for t in range(k - 1):
        pre.append(pre[-1] * signs[t])
    suf = [ones]
    for t in range(k - 1, 0, -1):
        suf.append(suf[-1] * signs[t])
    suf.reverse()
    return [p * s for p, s in zip(pre, suf)]


def qc_cn_bp(qc, v2c):
    """``decoders/bp_qc.py::qc_cn_bp`` before kernel B8: one row gather
    per slot of ``QCPlan.slots``, the pair folds on whole planes."""
    plan = qc_plan(qc, v2c.device)
    cdt = torch.promote_types(v2c.dtype, torch.float32)
    views = []
    for rows, gone, _ in plan.slots:
        msg = v2c[rows].to(cdt)
        if gone is not None:
            msg = torch.where(gone, float("inf"), msg)
        views.append(msg)
    mags = pair_excl_logmags([torch.exp(-v.abs()) for v in views])
    sprods = excl_sign_products([sgn_pos(v) for v in views])
    c2v = torch.empty((v2c.shape[0] + 1, v2c.shape[1]), dtype=cdt,
                      device=v2c.device)
    for (_, _, rows_w), sp, mg in zip(plan.slots, sprods, mags):
        c2v[rows_w] = sp * mg
    c2v = c2v[:-1]
    if plan.absent_rows is not None:
        c2v.index_fill_(0, plan.absent_rows, 0.0)
    return c2v


def bp_cn_update(code, v2c_flat):
    """``decoders/bp.py::bp_cn_update`` before kernel B8 (the pair folds
    on the ``[M, dc_max, B]`` block of CN slots, neutral elements in the
    padding slots), then ``bp_step``'s gather back to VN slots with the
    padding masked: c2v ``[N*dv_max, B]`` in VN-slot layout."""
    msgs = gather_cn(code, v2c_flat)
    cdt = torch.promote_types(msgs.dtype, torch.float32)
    m, dc_max, b = msgs.shape
    mask = code.cn_mask[:, :, None]
    msgs_c = msgs.to(cdt)
    u = torch.exp(-msgs_c.abs())
    sign = sgn_pos(msgs_c)
    u = torch.where(mask, u, torch.zeros_like(u))
    sign = torch.where(mask, sign, torch.ones_like(sign))
    mags = pair_excl_logmags([u[:, j] for j in range(dc_max)])
    sprods = excl_sign_products([sign[:, j] for j in range(dc_max)])
    c2v = torch.stack([sp * mg for sp, mg in zip(sprods, mags)], dim=1)
    c2v = torch.where(mask, c2v, torch.zeros_like(c2v))
    msgs = gather_vn(code, c2v.reshape(m * dc_max, b))
    msgs = torch.where(code.vn_mask[:, :, None], msgs, torch.zeros_like(msgs))
    return msgs.reshape(-1, b)


def stratified_bp_step(sc, v2c, yg, storage_dtype=None):
    """``decoders/bp_stratified.py::stratified_bp_step`` before kernel B8:
    ``_cn_bp`` over the ``[mb, h, kg, B]`` CN slots between the two row
    gathers, then the unchanged VN side; returns (v2c', total)."""
    x = stratified_to_cn(sc, v2c)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    valid = stratified_plan(sc, x.device).sc.cn_valid[..., None]
    u = torch.where(valid, torch.exp(-x.abs()), torch.zeros_like(x))
    sign = torch.where(valid, sgn_pos(x), torch.ones_like(x))
    mags = pair_excl_logmags([u[:, :, g] for g in range(sc.kg)])
    sprods = excl_sign_products([sign[:, :, g] for g in range(sc.kg)])
    out = torch.stack([sp * mg for sp, mg in zip(sprods, mags)], dim=2)
    c2v = stratified_to_vn(sc, torch.where(valid, out, torch.zeros_like(out)))
    acc = c2v[0]
    for s in range(1, sc.mb):
        acc = acc + c2v[s]
    total = yg.to(c2v.dtype) + acc
    sdt = storage_dtype if storage_dtype is not None else yg.dtype
    v2c_new = storage_cast(torch.clamp(total[None] - c2v, -MAXLLR, MAXLLR),
                           sdt)
    return stratified_zero_pad(sc, v2c_new), total


def qc_bp_layered_step(qc, q, L):
    """``decoders/bp_layered.py::qc_bp_layered_step`` before kernel B8:
    per layer the fold inline in the posterior's type, +inf put into the
    absent rows after the clip; returns (q', L')."""
    plan = qc_plan(qc, q.device)
    q = q.clone()
    L_new = []
    for lp, l_old in zip(plan.layers, L):
        qv = q[lp.cols]
        qext = qv - l_old
        qin = torch.clamp(qext, -MAXLLR, MAXLLR)
        if lp.absent is not None:
            qin.index_fill_(0, lp.absent, float("inf"))
        qin = qin.view(lp.dc, qc.z, -1)
        u = torch.exp(-qin.abs())
        sign = sgn_pos(qin)
        mags = pair_excl_logmags([u[t] for t in range(lp.dc)])
        sprods = excl_sign_products([sign[t] for t in range(lp.dc)])
        out = torch.cat([sp * mg for sp, mg in zip(sprods, mags)])
        if lp.absent is not None:
            out.index_fill_(0, lp.absent, 0.0)
        layered_scatter(q, lp, qv, qext, out)
        L_new.append(out)
    return q, tuple(L_new)


def qc_bp_vn(qc, c2v, yb, max_llr=MAXLLR, storage_dtype=None):
    """``decoders/bp_qc.py::qc_bp_step``'s VN side before kernel B9: the
    left fold of ``QCPlan.fold`` (``qc_fold``), the channel added last,
    then the extrinsic through ``total[row_col]``, the ±max_llr clip and
    the saturating cast; returns (v2c', total)."""
    plan = qc_plan(qc, c2v.device)
    acc = None
    for cols, rows in plan.fold:
        if acc is None:  # position 0: every column has a term
            acc = c2v[rows]
        elif cols is None:
            acc = acc + c2v[rows]
        else:
            acc[cols] = acc[cols] + c2v[rows]
    total = yb + acc
    sdt = storage_dtype if storage_dtype is not None else yb.dtype
    v2c = storage_cast(
        torch.clamp(total[plan.row_col] - c2v, -max_llr, max_llr), sdt)
    return v2c, total


def qc_bp_step(qc, max_llr=MAXLLR, storage_dtype=None):
    """``decoders/bp_qc.py::qc_bp_step`` before kernel B9: the check update
    (``decoders/bp_qc.py::qc_cn_bp``, B8's route) then :func:`qc_bp_vn`."""

    def step(v2c, yb):
        return qc_bp_vn(qc, b8_qc_cn_bp(qc, v2c), yb, max_llr, storage_dtype)

    return step
