"""The SystemC NGDBF hardware model's semantics as a batched decoder.

Port of ``ldpcsimulation_tpu.decoders.ngdbf_systemc`` (whose docstring
cites the reference's SystemC sources), with the same f32 operations in the
same order, so the decisions equal the JAX decoder's run op by op on the
same samples and the same source stream.  In short:

  * the received samples (additive AWGN, ``simulate(awgn_form="additive")``)
    and the noise go through the threshold-table quantizer
    (:func:`..channel.quantize.quantize_threshold_table`);
  * a per-node syndrome weight ``w_i = α·Ymax/dv_i``;
  * ``E = x·r + rnd + w·Σs``; flip when ``E < quantize(θ_i)``; θ adapts on
    both sides: ``θ/λ`` on a flip, ``θ·λ`` otherwise;
  * ONE quantized Gaussian per clock is shifted through the node chain:
    node i at iteration k reads source sample ``(N−1−i) + k``;
  * an up/down counter over the last 32 iterations rewrites a frame that
    never checks out.

Noise.  The JAX decoder draws the ``[N + T, B]`` source stream from its
key; here frame ``f`` of seed ``s`` draws its column with kernel B4
(:func:`..kernels.channel.gauss_philox`, offset 0, scale ``f32(σ)``) on
:data:`..kernels.channel.SYSTEMC_STREAM`, so a frame decodes the same in
any batch.  ``noise_stream=`` injects a pre-drawn stream.

The JAX ``while_loop`` tests "every frame done" at every step; here the
host reads it every few steps.  A done frame changes no state, so the extra
steps are exact.  The JAX decoder closes over its config (a static
argument), so XLA may fold ``θ / λ`` into a multiply by ``1/λ`` and contract
``x·r + rnd + w·Σs`` into fused multiply-adds when it compiles; the port
divides by ``f32(λ)`` and rounds each product, as the JAX operations do run
one by one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..channel.quantize import quantize_threshold_table
from ..codes.code import Code
from ..kernels.channel import SYSTEMC_STREAM, gauss_philox
from .base import DecodeResult, NoiseKey
from .gdbf import DONE_CHECK_EVERY
from .qc_ops import slot_graph, syndrome_bipolar, syndrome_sum_per_vn

__all__ = [
    "SMOOTHING_WINDOW",
    "SystemCNGDBFConfig",
    "keyed_source",
    "decode_ngdbf_systemc",
]

SMOOTHING_WINDOW = 32  # the model's compile-time smoothing window


@dataclasses.dataclass(frozen=True)
class SystemCNGDBFConfig:
    """The JAX ``SystemCNGDBFConfig``'s fields: iterations, θ, λ, α, Ymax,
    quantizer levels and output smoothing."""

    num_iterations: int
    theta: float
    lam: float = 0.975
    alpha: float = 0.95
    ymax: float = 3.0
    nq_levels: int = 16
    smoothed: bool = True


def keyed_source(cfg: SystemCNGDBFConfig, sigma: float, key: NoiseKey,
                 n: int, batch: int, device) -> torch.Tensor:
    """The raw source stream ``[n + T, batch]`` (σ·n, before quantization)
    the decoder draws for the frames key.frame0 … (kernel B4), for
    injection and replay."""
    return gauss_philox(key.seed, key.frame0, batch, n + cfg.num_iterations,
                        SYSTEMC_STREAM, 0.0, float(np.float32(sigma)),
                        device)


def decode_ngdbf_systemc(
    code: Code,
    y: torch.Tensor,
    sigma: float,
    cfg: SystemCNGDBFConfig,
    key: Optional[NoiseKey] = None,
    noise_stream: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """Batched decode with the SystemC model's semantics.

    y: [B, N] raw additive-AWGN samples (the decoder quantizes them).
    sigma: the channel's noise std-dev.  key: the frames' noise coordinates
    (needed unless ``noise_stream`` is given).  noise_stream: optional
    [N + T, B] raw source samples (σ·n, before quantization); sample
    ``(N−1−i) + k`` reaches node i at iteration k.
    """
    if noise_stream is None and key is None:
        raise ValueError("decode_ngdbf_systemc needs a noise key or "
                         "noise_stream")
    y_t = y.t().to(torch.float32)  # [N, B]
    device = y_t.device
    n, b = y_t.shape
    T = cfg.num_iterations

    def qz(v):
        return quantize_threshold_table(v, cfg.ymax, cfg.nq_levels)

    r = qz(y_t)
    x = torch.where(r > 0, 1, -1).to(torch.int8)  # ±1
    num = torch.tensor(cfg.alpha * cfg.ymax, dtype=torch.float32,
                       device=device)
    w = (num / code.vn_deg.to(device, torch.float32))[:, None]
    src = (noise_stream.to(device, torch.float32)
           if noise_stream is not None
           else keyed_source(cfg, sigma, key, n, b, device))
    gq = qz(src)  # [N + T, B]
    lam = torch.tensor(cfg.lam, dtype=torch.float32, device=device)
    theta = torch.full((n, b), float(np.float32(cfg.theta)),
                       dtype=torch.float32, device=device)
    updown = torch.zeros((n, b), dtype=torch.int32, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    iters = torch.full((b,), T, dtype=torch.int32, device=device)
    graph = slot_graph(code, device)

    for k in range(T):
        if k % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        syn = syndrome_bipolar(graph, x)  # [M, B] ±1, +1 satisfied
        satisfied = (syn > 0).all(dim=0)
        iters = torch.where(~done & satisfied, k, iters)
        done = done | satisfied
        act = ~done[None, :]

        # shift chain: node i reads the sample generated (N-1-i)+k in
        rnd = gq[k:k + n].flip(0)
        ssum = syndrome_sum_per_vn(graph, syn).to(torch.float32)
        e = x.to(torch.float32) * r + rnd + w * ssum
        flip = e < qz(theta)
        x = torch.where(act & flip, -x, x)
        theta = torch.where(
            act, torch.where(flip, theta / lam, theta * lam), theta)
        if cfg.smoothed and k + 1 > T - SMOOTHING_WINDOW:
            updown = torch.where(act, updown + x, updown)

    if cfg.smoothed:
        # the counters rewrite the frames that never checked out; a
        # counter of 0 gives -1
        smoothed = torch.where(updown > 0, 1, -1).to(torch.int8)
        x = torch.where(done[None, :], x, smoothed)
    # satisfied: stopped early, or the final output checks out at the cap
    final_sat = done | (syndrome_bipolar(graph, x) > 0).all(dim=0)
    return DecodeResult(hard=x.to(torch.int32).t(), iterations=iters,
                        satisfied=final_sat)
