"""A frozen copy of the row-layered min-sum step as it was before kernel B11
(``csrc/minsum_layer_step.cu``): per layer the posterior's gather, the
stored messages' widening, the extrinsic, kernel B1's scan over the f32
buffer (its twin on CPU tensors), the absent rows' fill,
``layered_scatter`` and the saturating storage cast, on every layer, pair
or not.

The new step must equal it bit for bit: on CPU tensors in
``tests/test_torch_layer_step.py`` (the twin) and on the card in
``chip_smoke.py`` (the kernel).  Plain PyTorch, nothing of JAX: the card's
machine imports this module too.
"""

from ldpcsimulation_tpu_torch.decoders import qc_plan
from ldpcsimulation_tpu_torch.decoders.base import storage_cast
from ldpcsimulation_tpu_torch.decoders.minsum_layered import layered_scatter
from ldpcsimulation_tpu_torch.kernels.minsum import minsum_cn_scan


def layer(q, lp, l_old, variant="plain", alpha=1.0, delta=0.0, sdt=None):
    """One layer of the pre-B11 step: updates ``q`` in place and returns
    the layer's new messages."""
    sdt = sdt if sdt is not None else q.dtype
    qv = q[lp.cols]
    qext = qv - l_old.to(q.dtype)
    out = minsum_cn_scan(qext, lp.scan_rows, variant, alpha, delta)
    if lp.absent is not None:  # rows B1 does not write
        out.index_fill_(0, lp.absent, 0.0)
    layered_scatter(q, lp, qv, qext, out)
    return storage_cast(out, sdt)


def qc_minsum_layered_step(qc, variant="plain", alpha=1.0, delta=0.0,
                           storage_dtype=None):
    """``decoders/minsum_layered.py::qc_minsum_layered_step`` before B11:
    ``step((q, L)) -> ((q', L'), total)``, the state given unchanged."""

    def step(qL):
        q, L = qL
        plan = qc_plan(qc, q.device)
        sdt = storage_dtype if storage_dtype is not None else q.dtype
        q = q.clone()
        L_new = [layer(q, lp, l_old, variant, alpha, delta, sdt)
                 for lp, l_old in zip(plan.layers, L)]
        return (q, tuple(L_new)), q

    return step
