"""Measure the throughput of every ported decoder family on one card.

Port of ``ldpcsimulation_tpu.tools.perf_report``.  Each row is a function
of ``(device, batch, repeats)``: one call runs the row's rounds — channel
(kernel B2) + decode + error count — on the device, bracketed by device
synchronizes, once to warm up and then ``repeats`` times; the row reports
the median call.  Stream rows time (pool build + call) per repeat and
report the pooled rate over the measured calls, as the JAX tool does.

    python -m ldpcsimulation_tpu_torch.tools.perf_report [--only TEXT] \
        [--repeats 3] [--out report.md] [--reference CHECKOUT]

Rows on the C reference's real parity-check matrices (the 802.3an H, the
GF(4)/GF(8) codes) run only with ``--reference`` pointing at a checkout
that holds them.  The NGDBFhw rows on codes without QC structure take the
dense graph operations (``decoders/dense_ops.py``) where the sweep does,
beside the gather baseline.  The real 802.3an H also runs through the
stratified decoder (``decoders/minsum_stratified.py``: kernel B1 on the
stratified routing table) beside the generic row, as in the JAX tool.

Byte models are the JAX tool's (the least traffic each algorithm must
move per frame and iteration); GB/s is that model over the measured time
and the share is against the H100's 3.35 TB/s.  Early-terminating batched
rows charge the iteration cap, so their bandwidth is an upper bound (≤);
stream rows charge the measured average iterations.  Rows with an
operation model (the dense products) add their TFLOP/s against the f16
tensor-core peak below the table.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional

import torch

from ..channel.awgn import (
    awgn_all_zero,
    llr_from_channel,
    snr_to_n0,
    snr_to_sigma,
)
from ..channel.nb import symbol_priors
from ..channel.quantize import quantize_no_zero
from ..codes import build_code, load_alist
from ..codes.construct import nb_regular
from ..codes.library import QC_NAMES, load_named_code, load_named_qc
from ..codes.qc import qc_peg
from ..codes.stratified import detect_stratified
from ..decoders.base import NoiseKey
from ..decoders.bp_qc import decode_bp_qc
from ..decoders.ddbmp import decode_ddbmp, decode_ddbmp_qc
from ..decoders.dense_ops import DenseGraph
from ..decoders.gdbf import decode_gdbf, preset
from ..decoders.minsum import decode_minsum
from ..decoders.minsum_layered import decode_minsum_layered_qc
from ..decoders.minsum_qc import decode_minsum_qc
from ..decoders.minsum_stratified import decode_minsum_stratified
from ..decoders.nb_qspa import decode_nb_qspa
from ..decoders.ngdbf_hw import NGDBFHwConfig, decode_ngdbf_hw
from ..harness.stream import (
    bp_qc_stream,
    build_channel_pool,
    build_channel_pool_nb,
    ddbmp_qc_stream,
    fetch,
    make_stream_call,
    minsum_layered_qc_stream,
    minsum_qc_stream,
    nb_qspa_stream,
    stream_init,
)
from ..harness.stream_gdbf import (
    build_channel_pool_gdbf,
    gdbf_stream_init,
    make_gdbf_stream_call,
)
from ..harness.stream_ngdbfhw import (
    build_channel_pool_hw,
    hw_stream_init,
    make_hw_stream_call,
)

__all__ = ["PEAK_HBM", "PEAK_F16", "Measured", "Row", "msg_bytes",
           "flip_bytes", "nb_bytes", "dense_hw_models", "stratified_models",
           "rows", "main"]

#: bytes/s, one H100 SXM (HBM3, at its 700 W limit)
PEAK_HBM = 3.35e12
#: dense f16 tensor-core FLOP/s, one H100 SXM (at its 700 W limit)
PEAK_F16 = 989e12
SEED = 0
REAL_802_3 = "C_implementations/codes/802_3/802_3_H.alist"
REAL_GF4 = "SystemC/NB-LDPC/codes/GF4/q4.sp.9000.6000.4500.1"
REAL_GF8 = "SystemC/NB-LDPC/codes/GF8/q8.sp.6000.4000.3000.1"


def msg_bytes(e, n, storage=4, ndirs=4, overhead=8):
    """Flooding message-passing traffic model: ndirs edge-array passes (CN
    read, CN write, VN read, VN write) at `storage` bytes plus
    per-variable channel/decision overhead."""
    return ndirs * e * storage + overhead * n


def flip_bytes(e, n, m):
    """Bit-flip family: two edge gathers (syndrome build + per-VN sum,
    values + int32 indices), syndrome r/w, d/y/E/noise arrays."""
    return 2 * e * (4 + 4) + 8 * m + 24 * n


def nb_bytes(e, n, q):
    """NB FFT-QSPA: q·E log-domain messages in 4 edge-array passes at f16,
    2 int32 gather index streams, the f32 priors/posteriors."""
    return 4 * e * q * 2 + 2 * e * 4 + 2 * n * q * 4


def dense_hw_models(n, m, batch):
    """Dense NGDBFhw per frame and iteration: (bytes, operations).  Two
    products with H per iteration (H·d and Hᵀ·s), 2 operations per entry
    each; the traffic is the 2-byte H twice per iteration over the batch
    plus the d/y'/E/noise/syndrome vectors."""
    flops = 2 * 2 * m * n
    bytes_ = 2 * m * n * 2 / batch + 8 * m + 24 * n
    return bytes_, flops


def stratified_models(sc, batch):
    """The JAX tool's stratified min-sum model per frame and iteration:
    (bytes, one-hot operations).  The VN slot grids ``[mb, kg, w]`` move
    twice in f16 storage and twice in f32, the CN slot grids ``[mb, h, kg]``
    four times in f32, the one-hot ``[mb, kg, w, h]`` f32 twice per
    iteration over the batch; the operations are the TPU form's two one-hot
    einsums, 2 per cell each.  The port moves the messages by B1's routing
    table and does no products, so its row is charged the bytes only."""
    s_vn = sc.mb * sc.kg * sc.w
    s_cn = sc.mb * sc.h * sc.kg
    oh = s_vn * sc.h
    bytes_ = s_vn * (2 * 2 + 2 * 4) + s_cn * 4 * 4 + 8 * sc.n + (
        2 * oh * 4 / batch)
    return bytes_, 2 * 2 * oh


@dataclasses.dataclass
class Measured:
    """One row's result.  ``frames`` per call (streams: retired per call,
    the mean of the measured calls); ``seconds`` per call (median; streams
    the mean); ``bytes_per_s`` the byte model over the time (None without
    a model); ``upper`` when the model charges the iteration cap;
    ``flops_per_s`` the operation model over the time (None without one).
    """

    label: str
    frames: int
    seconds: float
    bits_per_s: float
    bytes_per_s: Optional[float]
    upper: bool = False
    avg_iters: Optional[float] = None
    flops_per_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Row:
    """A table row: ``measure(device, batch, repeats) -> Measured`` with
    ``batch`` frames per decode (lanes for a stream) by default."""

    label: str
    batch: int
    measure: Callable[..., Measured]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=None)
def _code(name, device):
    """A registry code's slot arrays (a QC code's own expansion) on
    ``device``."""
    if name in QC_NAMES:
        return load_named_qc(name).to_code(device)
    return load_named_code(name, device)


@functools.lru_cache(maxsize=None)
def _alist_code(path, device):
    return build_code(load_alist(path), device)


@functools.lru_cache(maxsize=None)
def _stratified(path):
    """The stratified structure of an alist file (None if it has none)."""
    return detect_stratified(load_alist(path))


@functools.lru_cache(maxsize=None)
def _dense(code):
    """The dense graph of a code, on the code's device (built once)."""
    return DenseGraph.from_code(code, code.vn_deg.device)


@functools.lru_cache(maxsize=None)
def _nb64(device):
    """The GF(64) row's (96, 48) symbol code."""
    return build_code(nb_regular(96, 48, 3, q=64, seed=2), device)


def _batched(label, batch, rounds, n, sigma, k_info, iters, decode,
             bytes_fi=None, upper=False, flops_fi=None):
    """A batched row: a call is ``rounds`` × (B2 channel of ``batch``
    frames, ``decode(y, device, frame0) -> error count``)."""

    def measure(device, batch=batch, repeats=3):
        device = torch.device(device)

        def call(base):
            acc = torch.zeros((), dtype=torch.int64, device=device)
            for i in range(rounds):
                frame0 = base + i * batch
                y = awgn_all_zero(SEED, frame0, batch, n, sigma, device)
                acc += decode(y, device, frame0)
            return acc

        call(0)  # warm-up: allocator, plans, the kernel build
        _sync(device)
        ts = []
        for r in range(repeats):
            t0 = time.perf_counter()
            call((1 + r) * rounds * batch)
            _sync(device)
            ts.append(time.perf_counter() - t0)
        dt = statistics.median(ts)
        frames = batch * rounds
        return Measured(
            label, frames, dt, frames * k_info / dt,
            frames * iters * bytes_fi / dt if bytes_fi else None, upper,
            flops_per_s=frames * iters * flops_fi / dt if flops_fi else None,
        )

    return Row(label, batch, measure)


def _streamed(label, lanes, rounds, k_info, bytes_fi, setup):
    """A stream row: ``setup(device, lanes, rounds) -> (state, call,
    pool_of)`` with ``pool_of(base) -> pool args`` and ``call(state,
    *pool, base) -> (state', acc, rec)``.  A timed repeat builds the pool
    and runs one call; the first (warm-up) is not counted."""

    def measure(device, batch=lanes, repeats=3):
        device = torch.device(device)
        state, call, pool_of = setup(device, batch, rounds)
        base = 0
        samples = []
        for i in range(1 + repeats):
            _sync(device)
            t0 = time.perf_counter()
            pool = pool_of(base)
            state, acc, _rec = call(state, *pool, base)
            a = fetch(acc)
            dtc = time.perf_counter() - t0
            base += a["consumed"]
            if i > 0:
                samples.append((dtc, a["frames"], a["iter_sum"]))
        # pooled: frames spanning calls make per-call counts swing, so the
        # total retired over the total wall is the steady rate
        dtm = sum(s[0] for s in samples) / len(samples)
        fr = sum(s[1] for s in samples) / len(samples)
        avg_it = sum(s[2] for s in samples) / max(
            sum(s[1] for s in samples), 1)
        return Measured(
            label, int(fr), dtm, fr * k_info / dtm,
            fr * avg_it * bytes_fi / dtm if bytes_fi else None,
            avg_iters=avg_it,
        )

    return Row(label, lanes, measure)


def _soft_stream(make_dec, n, T, K, avg_hint, sigma, preprocess=None):
    """Setup of a :mod:`..harness.stream` adapter on an f16 pool."""

    def setup(device, lanes, rounds):
        dec = make_dec()
        pool_f = lanes + int(lanes * rounds * K / avg_hint)
        state = stream_init(dec, lanes, n, torch.float16, device)
        call = make_stream_call(dec, n, T, rounds, K)
        return state, call, lambda base: build_channel_pool(
            dec, SEED, base, pool_f, n, sigma, preprocess,
            pool_dtype=torch.float16, device=device)

    return setup


def _gdbf_stream(code_name, cfg, sigma, K, avg_hint, pool_dtype=None):
    def setup(device, lanes, rounds):
        qc = load_named_qc(code_name)
        code = _code(code_name, device)
        pool_f = lanes + int(lanes * rounds * K / avg_hint)
        state = gdbf_stream_init(code, cfg, lanes,
                                 pool_dtype or torch.float32, device)
        inner = make_gdbf_stream_call(code, rounds, K, qc=qc)

        def call(state, pool, unc, sat0, base):
            return inner(state, pool, unc, sat0, base, SEED, sigma, cfg)

        return state, call, lambda base: build_channel_pool_gdbf(
            code, SEED, base, pool_f, sigma, pool_dtype=pool_dtype, qc=qc,
            device=device)

    return setup


def _hw_stream(get_code, cfg, sigma, K, avg_hint, dense=False):
    def setup(device, lanes, rounds):
        code = get_code(device)
        dg = _dense(code) if dense else None
        pool_f = lanes + int(lanes * rounds * K / avg_hint)
        state = hw_stream_init(code, cfg, lanes, device)
        inner = make_hw_stream_call(code, cfg, rounds, K, dense=dg)

        def call(state, pool, unc, sat0, base):
            return inner(state, pool, unc, sat0, base, SEED, sigma)

        return state, call, lambda base: build_channel_pool_hw(
            code, SEED, base, pool_f, sigma, dense=dg, device=device)

    return setup


def _nb_stream(path, snr, T, avg_hint):
    def setup(device, lanes, rounds):
        code = _alist_code(path, device)
        q = code.q
        m_bits = q.bit_length() - 1
        n0 = snr_to_n0(snr, (code.n - code.m) / code.n)
        dec = nb_qspa_stream(code, n0, q, storage_dtype=torch.float16)
        pool_f = lanes + int(lanes * rounds / avg_hint)
        state = stream_init(dec, lanes, code.n * q, torch.float32, device)
        call = make_stream_call(dec, code.n, T, rounds, 1,
                                max_weight=code.n * m_bits)
        return state, call, lambda base: build_channel_pool_nb(
            dec, SEED, base, pool_f, code.n, q, (n0 / 2) ** 0.5, device)

    return setup


def _errors(hard):
    return (hard != 1).sum()


def rows(reference: Optional[str] = None) -> List[Row]:
    """Every row, in the JAX tool's order; the rows on the reference's real
    matrices only when ``reference`` holds them."""
    f16 = torch.float16

    def real(rel):
        if reference is None:
            return None
        p = os.path.join(reference, rel)
        return p if os.path.exists(p) else None

    out: List[Row] = []
    add = out.append
    sigma = snr_to_sigma(2.0, 0.5)
    n0 = snr_to_n0(2.0, 0.5)
    qcn = "qc_1008_504"
    qc = load_named_qc(qcn)

    add(_batched(
        "min-sum T=10, QC f16 (flagship)", 16384, 8, qc.n, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_minsum_qc(
            qc, y, 10, storage_dtype=f16).hard),
        msg_bytes(3024, qc.n, storage=2)))
    add(_batched(
        "min-sum T=10, generic slot arrays", 8192, 4, 1008, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_minsum(
            _code("peg_1008_504", dev), y, 10).hard),
        msg_bytes(3024, 1008) + 2 * 3024 * 4))
    add(_batched(
        "min-sum T=10, generic f16 storage", 8192, 4, 1008, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_minsum(
            _code("peg_1008_504", dev), y, 10, storage_dtype=f16).hard),
        msg_bytes(3024, 1008, storage=2) + 2 * 3024 * 4))

    p8023 = real(REAL_802_3)
    if p8023 is not None:
        add(_batched(
            "min-sum T=10, REAL 802.3an H, generic f16", 8192, 2, 2048,
            snr_to_sigma(4.25, 0.8413), 1723, 10,
            lambda y, dev, f0: _errors(decode_minsum(
                _alist_code(p8023, dev), y, 10, storage_dtype=f16).hard),
            msg_bytes(12288, 2048, storage=2) + 2 * 12288 * 4))
        # the same H through the stratified decoder (the JAX tool's row)
        sc = _stratified(p8023)
        if sc is not None:
            add(_batched(
                f"min-sum T=10, REAL 802.3an H, stratified f16 (cost "
                f"{sc.cost:g})", 16384, 2, 2048, snr_to_sigma(4.25, 0.8413),
                1723, 10,
                lambda y, dev, f0: _errors(decode_minsum_stratified(
                    sc, y, 10, storage_dtype=f16).hard),
                stratified_models(sc, 16384)[0]))

    dvbn = "dvbs2_1_2_qc"
    dvb = load_named_qc(dvbn)
    e_dvb = sum(len(bl) for bl in dvb.vn_blocks) * dvb.z - len(
        dvb.minus_edges)
    sigma_d = snr_to_sigma(1.2, 0.5)
    add(_batched(
        "min-sum T=10, REAL DVB-S2 (64800,32400), generalized-QC rolls",
        2048, 2, dvb.n, sigma_d, 32400, 10,
        lambda y, dev, f0: _errors(decode_minsum_qc(
            dvb, y, 10, storage_dtype=f16).hard),
        msg_bytes(e_dvb, dvb.n, storage=2)))
    # the padded slot arrays move once each way, plus two int32 index
    # streams and the per-variable overhead
    pad_slots = dvb.n * dvb.dv_max + dvb.m * dvb.dc_max
    add(_batched(
        "min-sum T=10, REAL DVB-S2 (64800,32400), generic gather f16",
        1024, 2, dvb.n, sigma_d, 32400, 10,
        lambda y, dev, f0: _errors(decode_minsum(
            _code(dvbn, dev), y, 10, storage_dtype=f16).hard),
        2 * pad_slots * 2 + 2 * e_dvb * 4 + 8 * dvb.n))
    add(_batched(
        "layered min-sum T=10, REAL DVB-S2 (per-layer state)", 2048, 2,
        dvb.n, sigma_d, 32400, 10,
        lambda y, dev, f0: _errors(decode_minsum_layered_qc(
            dvb, y, 10, storage_dtype=f16).hard),
        msg_bytes(e_dvb, dvb.n, storage=2, ndirs=2)))

    add(_batched(
        "BP T<=30 (early term), QC f16", 8192, 16, qc.n, sigma, 504, 30,
        lambda y, dev, f0: _errors(decode_bp_qc(
            qc, llr_from_channel(y, n0), 30, early_termination=True,
            storage_dtype=f16).hard),
        msg_bytes(3024, qc.n, storage=2), upper=True))

    add(_streamed(
        "min-sum T<=30 ET, STREAM refill (K=4), QC f16 (f16 pool)",
        8192, 64, 504, msg_bytes(3024, qc.n, storage=2),
        _soft_stream(lambda: minsum_qc_stream(qc, storage_dtype=f16),
                     qc.n, 30, 4, 15.0, sigma)))
    add(_streamed(
        "BP T<=30 ET, STREAM refill (K=2), QC f16 (f16 pool)",
        8192, 64, 504, msg_bytes(3024, qc.n, storage=2),
        _soft_stream(lambda: bp_qc_stream(qc, storage_dtype=f16),
                     qc.n, 30, 2, 10.0, sigma,
                     lambda y: llr_from_channel(y, n0))))
    sigma16 = snr_to_sigma(1.6, 0.5)
    add(_streamed(
        "layered min-sum T<=20 ET REAL DVB-S2 @1.6dB, STREAM refill (K=2)",
        1024, 16, 32400, msg_bytes(e_dvb, dvb.n, storage=2, ndirs=2),
        _soft_stream(lambda: minsum_layered_qc_stream(dvb, storage_dtype=f16),
                     dvb.n, 20, 2, 12.0, sigma16)))
    add(_streamed(
        "min-sum T<=40 ET REAL DVB-S2 @1.6dB, STREAM refill (K=2)",
        1024, 16, 32400, msg_bytes(e_dvb, dvb.n, storage=2),
        _soft_stream(lambda: minsum_qc_stream(dvb, storage_dtype=f16),
                     dvb.n, 40, 2, 25.0, sigma16)))

    add(_batched(
        "BP T=10 fixed, QC f16", 8192, 4, qc.n, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_bp_qc(
            qc, llr_from_channel(y, n0), 10, storage_dtype=f16).hard),
        msg_bytes(3024, qc.n, storage=2)))
    add(_batched(
        "layered min-sum T=10, QC", 8192, 4, qc.n, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_minsum_layered_qc(qc, y, 10).hard),
        msg_bytes(3024, qc.n, ndirs=2)))

    wifi = load_named_qc("wifi_1944_972")
    e_w = 87 * 81
    add(_batched(
        "min-sum T=10, REAL 802.11n (1944,972) z=81, QC f16", 8192, 4,
        wifi.n, sigma, 972, 10,
        lambda y, dev, f0: _errors(decode_minsum_qc(
            wifi, y, 10, storage_dtype=f16).hard),
        msg_bytes(e_w, wifi.n, storage=2)))
    add(_batched(
        "layered min-sum T=10, REAL 802.11n (1944,972) z=81", 8192, 4,
        wifi.n, sigma, 972, 10,
        lambda y, dev, f0: _errors(decode_minsum_layered_qc(
            wifi, y, 10).hard),
        msg_bytes(e_w, wifi.n, ndirs=2)))

    # SM-NGDBF on QC graph operations, T=100 at the script's point
    sigma_g = snr_to_sigma(3.25, 0.5)
    cfg_g = preset("SMNGDBF", num_iterations=100, theta=-0.9,
                   noise_scale=0.975, lam=0.988, alpha=2.3, window_size=64)
    add(_batched(
        "SM-NGDBF T<=100 @3.25dB, QC ops", 4096, 4, qc.n, sigma_g, 504, 100,
        lambda y, dev, f0: _errors(decode_gdbf(
            _code(qcn, dev), torch.clamp(y, -2.5, 2.5), sigma_g, cfg_g,
            key=NoiseKey(SEED, f0), qc=qc).hard),
        flip_bytes(3024, qc.n, 504), upper=True))
    # the working point (α = 0.75 at 3.5 dB): batched against the stream
    sigma_w2 = snr_to_sigma(3.5, 0.5)
    cfg_w2 = preset("SMNGDBF", num_iterations=100, theta=-0.9,
                    noise_scale=0.975, lam=0.988, alpha=0.75,
                    window_size=64)
    add(_batched(
        "SM-NGDBF T<=100 @3.5dB (working pt), QC, batched ET", 8192, 2,
        qc.n, sigma_w2, 504, 100,
        lambda y, dev, f0: _errors(decode_gdbf(
            _code(qcn, dev), y, sigma_w2, cfg_w2, key=NoiseKey(SEED, f0),
            qc=qc).hard),
        flip_bytes(3024, qc.n, 504), upper=True))
    add(_streamed(
        "SM-NGDBF T<=100 @3.5dB (working pt), QC, STREAM refill (K=8)",
        8192, 32, 504, flip_bytes(3024, qc.n, 504),
        _gdbf_stream(qcn, cfg_w2, sigma_w2, 8, 53.0)))

    # SM-NGDBF on the real DVB-S2 code (the reference's biggest NGDBF job,
    # at the cross-validated α = 1.2)
    cfg_dvb = preset("SMNGDBF", num_iterations=700, theta=-1.1,
                     noise_scale=0.775, lam=0.987, alpha=1.2, window_size=64)
    sigma_dvb = snr_to_sigma(3.4, 0.5)
    add(_batched(
        "SM-NGDBF T<=700 REAL DVB-S2 @3.4dB (working pt), batched ET",
        2048, 1, dvb.n, sigma_dvb, 32400, 700,
        lambda y, dev, f0: _errors(decode_gdbf(
            _code(dvbn, dev), y, sigma_dvb, cfg_dvb,
            key=NoiseKey(SEED, f0), qc=dvb).hard),
        flip_bytes(e_dvb, dvb.n, dvb.m), upper=True))
    add(_streamed(
        "SM-NGDBF T<=700 REAL DVB-S2 @3.4dB, STREAM refill (K=16)",
        2048, 16, 32400, flip_bytes(e_dvb, dvb.n, dvb.m),
        _gdbf_stream(dvbn, cfg_dvb, sigma_dvb, 16, 456.0, f16)))

    # NGDBFhw fixed point, 802.3an class, T=200 at 4.25 dB
    hwn = "highrate_2048_384"
    cfg_hw = NGDBFHwConfig(num_iterations=200, ring_len=2648)
    sigma_hw = snr_to_sigma(4.25, 0.8413)
    add(_batched(
        "NGDBFhw T<=200 (2048,1664-class), gather baseline", 2048, 2, 2048,
        sigma_hw, 1664, 200,
        lambda y, dev, f0: decode_ngdbf_hw(
            _code(hwn, dev), y, sigma_hw, cfg_hw,
            key=NoiseKey(SEED, f0)).least_errors.sum(),
        flip_bytes(12288, 2048, 384), upper=True))
    hw_bytes, hw_flops = dense_hw_models(2048, 384, 2048)
    add(_batched(
        "NGDBFhw T<=200 (2048,1664-class), dense ops (sweep default)", 2048,
        2, 2048, sigma_hw, 1664, 200,
        lambda y, dev, f0: decode_ngdbf_hw(
            _code(hwn, dev), y, sigma_hw, cfg_hw, key=NoiseKey(SEED, f0),
            dense=_dense(_code(hwn, dev))).least_errors.sum(),
        hw_bytes, upper=True, flops_fi=hw_flops))
    if p8023 is not None:  # the real H is 2048 x 384 as well
        add(_batched(
            "NGDBFhw T<=200 REAL 802.3an H, dense ops", 2048, 2, 2048,
            sigma_hw, 1723, 200,
            lambda y, dev, f0: decode_ngdbf_hw(
                _alist_code(p8023, dev), y, sigma_hw, cfg_hw,
                key=NoiseKey(SEED, f0),
                dense=_dense(_alist_code(p8023, dev))).least_errors.sum(),
            hw_bytes, upper=True, flops_fi=hw_flops))
    add(_streamed(
        "NGDBFhw T<=200 (2048,1664-class), STREAM refill (K=16)",
        4096, 32, 1664, flip_bytes(12288, 2048, 384),
        _hw_stream(lambda dev: _code(hwn, dev), cfg_hw, sigma_hw, 16,
                   48.0)))
    if p8023 is not None:
        add(_streamed(
            "NGDBFhw T<=200 REAL 802.3an H, STREAM refill (K=16)",
            4096, 32, 1723, flip_bytes(12288, 2048, 384),
            _hw_stream(lambda dev: _alist_code(p8023, dev), cfg_hw,
                       sigma_hw, 16, 26.0, dense=True)))

    # DD-BMP T=50 on a QC (4000,2000)-class code
    dd_qc = qc_peg(40, 20, 4, z=100, seed=2)
    sigma_dd = snr_to_sigma(3.9, 0.5)
    add(_batched(
        "DD-BMP T<=50 QC (4000,2000) @3.9dB, rolls (sweep default)", 2048,
        2, dd_qc.n, sigma_dd, 2000, 50,
        lambda y, dev, f0: _errors(decode_ddbmp_qc(
            dd_qc, quantize_no_zero(y, 1.5, 8.0), 50).hard),
        flip_bytes(16000, 4000, 2000), upper=True))
    add(_streamed(
        "DD-BMP T<=50 QC @3.9dB, STREAM refill (K=4)", 4096, 32, 2000,
        flip_bytes(16000, 4000, 2000),
        _soft_stream(lambda: ddbmp_qc_stream(dd_qc), dd_qc.n, 50, 4, 32.0,
                     sigma_dd, lambda y: quantize_no_zero(y, 1.5, 8.0))))
    add(_batched(
        "DD-BMP T<=50 (4000,2000) @3.9dB, gather baseline", 1024, 2, 4000,
        sigma_dd, 2000, 50,
        lambda y, dev, f0: _errors(decode_ddbmp(
            _code("reg4_4000_2000", dev), quantize_no_zero(y, 1.5, 8.0),
            50).hard),
        msg_bytes(16000, 4000), upper=True))

    # single-frame latency: 256 sequential B=1 decodes per call
    add(_batched(
        "min-sum T=10 QC, single-frame latency (256 serial decodes)", 1,
        256, qc.n, sigma, 504, 10,
        lambda y, dev, f0: _errors(decode_minsum_qc(
            qc, y, 10, storage_dtype=f16).hard)))

    # NB FFT-QSPA GF(64), (96,48) symbols, T=20
    n0_nb = snr_to_n0(5.5, 0.5)
    sig_nb = (n0_nb / 2) ** 0.5
    add(_batched(
        "FFT-QSPA GF(64) T<=20 (96,48)sym", 256, 2, 96 * 6, sig_nb, 48 * 6,
        20,
        lambda y, dev, f0: (decode_nb_qspa(
            _nb64(dev),
            symbol_priors(y.reshape(-1, 96, 6), n0_nb, 64), 20,
        ).symbols != 0).sum(),
        12 * 288 * 64 * 4, upper=True))

    # the reference's real non-binary codes: batched, then streamed
    def real_nb_decode(path, n0r, m_bits, q):
        def decode(y, dev, f0):
            priors = symbol_priors(y.reshape(y.shape[0], -1, m_bits), n0r, q)
            return (decode_nb_qspa(
                _alist_code(path, dev), priors, 20, early_termination=True,
                storage_dtype=f16).symbols != 0).sum()
        return decode

    for rel, label, snr_nb in [
        (REAL_GF4, "FFT-QSPA GF(4) T<=20 REAL (9000,6000)sym @2.2dB, "
         "log-f16", 2.2),
        (REAL_GF8, "FFT-QSPA GF(8) T<=20 REAL (6000,4000)sym @2.4dB, "
         "log-f16", 2.4),
    ]:
        p = real(rel)
        if p is None:
            continue
        nbc = _alist_code(p, "cpu")
        q_nb, m_bits = nbc.q, nbc.q.bit_length() - 1
        e_nb = int(nbc.cn_mask.sum())
        n0r = snr_to_n0(snr_nb, (nbc.n - nbc.m) / nbc.n)
        add(_batched(
            label, 256, 2, nbc.n * m_bits, (n0r / 2) ** 0.5,
            (nbc.n - nbc.m) * m_bits, 20,
            real_nb_decode(p, n0r, m_bits, q_nb),
            nb_bytes(e_nb, nbc.n, q_nb), upper=True))
    for rel, label, snr_nb, avg in [
        (REAL_GF4, "FFT-QSPA GF(4) T<=20 REAL @2.2dB, STREAM refill, "
         "log-f16", 2.2, 10.0),
        (REAL_GF8, "FFT-QSPA GF(8) T<=20 REAL @2.4dB, STREAM refill, "
         "log-f16", 2.4, 8.0),
    ]:
        p = real(rel)
        if p is None:
            continue
        nbc = _alist_code(p, "cpu")
        m_bits = nbc.q.bit_length() - 1
        add(_streamed(
            label, 512, 64, (nbc.n - nbc.m) * m_bits,
            nb_bytes(int(nbc.cn_mask.sum()), nbc.n, nbc.q),
            _nb_stream(p, snr_nb, 20, avg)))
    return out


def card_line(device) -> str:
    """The card's name and power limit (``nvidia-smi``), or a note that the
    run is on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "CPU (the kernels' plain twins; not a device measurement)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def format_table(results: List[Measured], card: str,
                 header: bool = True) -> str:
    lines = []
    if header:
        lines = [
            "# Measured decoder throughput (one card)",
            "",
            f"Card: {card}.",
            "",
            "Full pipeline per call: channel (kernel B2) + decode + error",
            "count, bracketed by device synchronizes; median of repeats",
            "after a warm-up call (stream rows: pooled over the measured",
            "calls).  Info-bit rates use each code's design k.  GB/s is the",
            "byte model of tools/perf_report.py over the measured time; the",
            "share is against 3.35 TB/s.  Early-terminating batched rows",
            "charge the iteration cap, so their bandwidth is an upper bound",
            "(≤).",
            "",
            "| configuration | frames/call | median ms | info Mbit/s | GB/s "
            "| % of 3.35 TB/s |",
            "|---|---|---|---|---|---|",
        ]
    for r in results:
        pre = "≤" if r.upper else ""
        bw = f"{pre}{r.bytes_per_s / 1e9:.0f}" if r.bytes_per_s else "—"
        pct = (f"{pre}{100 * r.bytes_per_s / PEAK_HBM:.0f}%"
               if r.bytes_per_s else "—")
        lines.append(
            f"| {r.label} | {r.frames} | {r.seconds * 1e3:.1f} | "
            f"{r.bits_per_s / 1e6:.1f} | {bw} | {pct} |"
        )
    flops = [r for r in results if r.flops_per_s]
    if flops:
        lines.append("")
    for r in flops:
        pre = "≤" if r.upper else ""
        lines.append(
            f"- {r.label}: {pre}{r.flops_per_s / 1e12:.1f} TFLOP/s "
            f"({pre}{100 * r.flops_per_s / PEAK_F16:.1f}% of the f16 "
            "tensor-core peak, 989 TFLOP/s)"
        )
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="perf_report")
    p.add_argument("--out", default=None,
                   help="write the table here (default: stdout)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--only", default=None,
                   help="substring filter: run only matching configs")
    p.add_argument("--append", action="store_true",
                   help="append table rows to --out instead of rewriting")
    p.add_argument("--reference", default=None,
                   help="checkout of the C reference (its real 802.3an "
                        "and NB matrices); without it those rows skip")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU runs the "
                        "kernels' plain twins)")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "perf_report: error: --device cuda, but no CUDA device is "
            "available (pass --device cpu to run the plain PyTorch path)"
        )
    results = []
    for row in rows(args.reference):
        if args.only and args.only.lower() not in row.label.lower():
            continue
        r = row.measure(device, repeats=args.repeats)
        results.append(r)
        avg = (f" (avg {r.avg_iters:.1f} it/frame)"
               if r.avg_iters is not None else "")
        print(f"{r.label}: {r.seconds * 1e3:.1f} ms, "
              f"{r.bits_per_s / 1e6:.1f} Mb/s{avg}", file=sys.stderr)
    out = format_table(results, card_line(device), header=not args.append)
    if args.out:
        with open(args.out, "a" if args.append else "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
