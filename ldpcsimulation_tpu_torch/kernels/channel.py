"""Keyed Philox draws on the card: kernel B2, the AWGN samples of the
all-(+1) word (``csrc/awgn_philox.cu``), and kernels B3 and B4, the
decoders' uniforms and erfinv Gaussians (``csrc/uniform_philox.cu``).

B2.

Port of ``ldpcsimulation_tpu.kernels.channel_pallas.awgn_all_zero_pallas``.
Frame ``f`` of seed ``s`` draws its noise from Philox4x32-10 with key ``s``
and counter ``(pair j, f lo, f hi, 0)``: each call gives two Box–Muller
pairs, for columns 2j and 2j+1.  The frame's samples are a pure function of
(seed, frame index), whatever the batch.

:func:`awgn_philox` launches the CUDA kernel for a CUDA device and runs the
plain twin :func:`awgn_philox_plain` for the CPU.  The twin computes the
same Philox integers (int64 tensor arithmetic, 16-bit limbs for the 32×32
products) and the same f32 operations in the same order; only ``log`` and
``cos`` come from another math library (libdevice's on the card, PyTorch's
here), and on the H100 the two give equal samples, which ``chip_smoke.py``
checks with ``torch.equal``.

B3 and B4.  Ports of ``channel_pallas.uniform_pallas`` and
``channel_pallas.awgn_all_zero_hybrid``.  The same key, with the counter
``(quad j, f lo, f hi, stream)``: each call gives four words, for columns
4j … 4j+3, and each word becomes ``u = (k + 0.5)·2⁻²⁴`` with ``k = word >>
8``, as B2 forms its uniforms.  :func:`uniform_philox` writes u (exact, so
kernel and twin are equal); :func:`gauss_philox` writes ``offset + scale·
(√2·erfinv(2u − 1))`` in the TPU function's f32 operation order, with
``erfinv`` from libdevice on the card and from PyTorch in the twin (on the
card the two give equal samples).  Above k = 2²³ the f32 sum ``k + 0.5`` rounds to
even, so k = 2²⁴ − 1 gives u = 1.0 and a Gaussian of +inf, once in 2²⁴
draws — as the TPU functions do.  The decoders key their draws with
:func:`noise_stream`; stream 0 is B2's, so no decoder draw repeats a
channel draw, and the two top streams are the NGDBFhw noise ring's and the
SystemC model's source stream.  Both layouts are written directly: ``"nb"`` is the
decoders' ``[n, batch]``, ``"bn"`` the TPU functions' ``[batch, n]``.

Per-lane keys.  A streaming decoder holds one frame per lane, each at its
own step: :func:`uniform_philox_lanes` and :func:`gauss_philox_lanes` take
an int64 frame id ``gid[b]`` and an int32 step ``step[b]`` per column, on the
device, and draw column b with the counter ``(quad j, gid[b] lo, gid[b] hi,
1 + 2·step[b] + domain)`` — the key :func:`noise_stream` gives frame
``gid[b]`` at that step.  On contiguous gids and one step they write the
bits of the contiguous entries, so a streamed frame draws what its batch
decode draws.  The same kernels' per-lane instances; their twins
(:func:`uniform_philox_lanes_plain`, :func:`gauss_philox_lanes_plain`)
run the same Philox on tensor counters.
"""

from __future__ import annotations

import math

import torch

from . import build

__all__ = [
    "philox4x32_10",
    "awgn_philox",
    "awgn_philox_plain",
    "LAYOUTS",
    "noise_stream",
    "NGDBFHW_RING_STREAM",
    "SYSTEMC_STREAM",
    "uniform_philox",
    "uniform_philox_plain",
    "gauss_philox",
    "gauss_philox_plain",
    "uniform_philox_lanes",
    "uniform_philox_lanes_plain",
    "gauss_philox_lanes",
    "gauss_philox_lanes_plain",
]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi  # rounded to f32 where it meets an f32 tensor
_U64 = 1 << 64
_SQRT2 = math.sqrt(2.0)  # rounded to f32 where it meets an f32 tensor
#: layout name -> id passed to the B3/B4 kernels
LAYOUTS = {"bn": 0, "nb": 1}


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


def _frame_words(frame0: int, batch: int, device):
    """Counter words (f lo, f hi) of frames frame0 … frame0+batch−1 as
    [batch, 1] int64 tensors (frame0 + row may pass 2^63)."""
    f = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    f_lo = (f + (frame0 & _MASK32)) & _MASK32
    carry = (f + (frame0 & _MASK32)) >> 32
    return f_lo, (carry + (frame0 >> 32)) & _MASK32


def awgn_philox_plain(seed: int, frame0: int, batch: int, n: int,
                      sigma: float, device="cpu", with_bits: bool = False):
    """Plain PyTorch twin of the kernel (same integers, same f32 steps)."""
    _check_args(seed, frame0, batch, n)
    npairs = (n + 1) // 2
    j = torch.arange(npairs, dtype=torch.int64, device=device)[None, :]
    f_lo, f_hi = _frame_words(frame0, batch, device)
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
    build.launch_philox(
        "ldpc_awgn_philox", "awgn_philox", seed, frame0, batch, n, sigma,
        y.data_ptr(), bits.data_ptr() if with_bits else None, device.index,
        build.stream_of(device),
    )
    return (y, bits) if with_bits else y


#: the NGDBFhw noise ring's stream (one draw per frame), and the SystemC
#: model's source stream; :func:`noise_stream` never returns either
NGDBFHW_RING_STREAM = _MASK32
SYSTEMC_STREAM = _MASK32 - 1


def noise_stream(step: int, domain: int) -> int:
    """Philox stream of a decoder draw: ``1 + 2·step + domain`` (domain 0
    the perturbation, 1 the stochastic flips; stream 0 is the channel's).
    Steps stop below 2³¹ − 2, so the streams stop below
    :data:`SYSTEMC_STREAM`."""
    if domain not in (0, 1) or not 0 <= step < (1 << 31) - 2:
        raise ValueError(f"no noise stream for step {step}, domain {domain}")
    return 1 + 2 * step + domain


def _check_draw(seed, frame0, batch, n, stream, layout):
    _check_args(seed, frame0, batch, n)
    if not 0 <= stream <= _MASK32:
        raise ValueError(f"stream {stream} outside [0, 2^32)")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (want one of "
                         f"{sorted(LAYOUTS)})")


def _plain_bits(seed, frame0, batch, n, stream, layout, device):
    """[batch, n] (or [n, batch] for "nb") int64 24-bit integers k."""
    nquads = (n + 3) // 4
    j = torch.arange(nquads, dtype=torch.int64, device=device)[None, :]
    f_lo, f_hi = _frame_words(frame0, batch, device)
    words = philox4x32_10(
        (j, f_lo, f_hi, stream), (seed & _MASK32, seed >> 32)
    )
    k = torch.stack(words, dim=-1).reshape(batch, 4 * nquads)[:, :n] >> 8
    return k.t().contiguous() if layout == "nb" else k


def _plain_uniform(k):
    return (k.to(torch.float32) + 0.5) * 2.0 ** -24


def uniform_philox_plain(seed: int, frame0: int, batch: int, n: int,
                         stream: int, layout: str = "nb", device="cpu",
                         with_bits: bool = False):
    """Plain PyTorch twin of kernel B3 (same integers, same f32 steps)."""
    _check_draw(seed, frame0, batch, n, stream, layout)
    k = _plain_bits(seed, frame0, batch, n, stream, layout, device)
    u = _plain_uniform(k)
    return (u, k.to(torch.int32)) if with_bits else u


def gauss_philox_plain(seed: int, frame0: int, batch: int, n: int,
                       stream: int, offset: float, scale: float,
                       layout: str = "nb", device="cpu",
                       with_bits: bool = False):
    """Plain PyTorch twin of kernel B4: ``offset + scale·(√2·erfinv(2u −
    1))`` on B3's uniforms, with PyTorch's ``erfinv``."""
    _check_draw(seed, frame0, batch, n, stream, layout)
    k = _plain_bits(seed, frame0, batch, n, stream, layout, device)
    nrm = _SQRT2 * torch.erfinv(2.0 * _plain_uniform(k) - 1.0)
    y = offset + scale * nrm
    return (y, k.to(torch.int32)) if with_bits else y


def _draw(entry, name, seed, frame0, batch, n, stream, layout, device,
          with_bits, *scalars):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    _check_draw(seed, frame0, batch, n, stream, layout)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = (n, batch) if layout == "nb" else (batch, n)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    bits = (torch.empty(shape, dtype=torch.int32, device=device)
            if with_bits else None)
    build.launch_philox(
        entry, name, seed, frame0, batch, n, stream, LAYOUTS[layout],
        *scalars, out.data_ptr(), bits.data_ptr() if with_bits else None,
        device.index, build.stream_of(device),
    )
    return (out, bits) if with_bits else out


def uniform_philox(seed: int, frame0: int, batch: int, n: int, stream: int,
                   device, layout: str = "nb", with_bits: bool = False):
    """Keyed uniforms of frames frame0 … frame0+batch−1 on ``stream``:
    f32 ``[n, batch]`` (layout "nb") or ``[batch, n]`` ("bn").

    ``with_bits`` also returns the int32 24-bit integers behind them.  CPU:
    the plain twin.  CUDA: kernel B3, or an exception."""
    if torch.device(device).type == "cpu":
        return uniform_philox_plain(seed, frame0, batch, n, stream, layout,
                                    device, with_bits)
    return _draw("ldpc_uniform_philox", "uniform_philox", seed, frame0,
                 batch, n, stream, layout, device, with_bits)


def gauss_philox(seed: int, frame0: int, batch: int, n: int, stream: int,
                 offset: float, scale: float, device, layout: str = "nb",
                 with_bits: bool = False):
    """Keyed Gaussians ``offset + scale·(√2·erfinv(2u − 1))`` on B3's
    uniforms, in :func:`uniform_philox`'s layouts.  ``offset`` and
    ``scale`` act as f32 values.  CPU: the plain twin.  CUDA: kernel B4, or
    an exception."""
    if torch.device(device).type == "cpu":
        return gauss_philox_plain(seed, frame0, batch, n, stream, offset,
                                  scale, layout, device, with_bits)
    return _draw("ldpc_gauss_philox", "gauss_philox", seed, frame0, batch,
                 n, stream, layout, device, with_bits, offset, scale)


def _check_lanes(gid, step, n, domain, layout):
    if gid.dim() != 1 or gid.dtype != torch.int64:
        raise ValueError(f"gid must be [batch] int64, got {tuple(gid.shape)} "
                         f"{gid.dtype}")
    if step.shape != gid.shape or step.dtype != torch.int32:
        raise ValueError(f"step must be [{gid.shape[0]}] int32, got "
                         f"{tuple(step.shape)} {step.dtype}")
    if step.device != gid.device:
        raise ValueError(f"step on {step.device}, gid on {gid.device}")
    if domain not in (0, 1) or n < 0:
        raise ValueError(f"bad domain {domain} or n {n}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (want one of "
                         f"{sorted(LAYOUTS)})")


def _plain_lane_bits(seed, gid, step, n, domain, layout):
    """[batch, n] (or [n, batch] for "nb") int64 24-bit integers k of the
    per-lane keys."""
    nquads = (n + 3) // 4
    j = torch.arange(nquads, dtype=torch.int64, device=gid.device)[None, :]
    g = gid[:, None]
    stream = (1 + 2 * step.to(torch.int64)[:, None] + domain) & _MASK32
    words = philox4x32_10(
        (j, g & _MASK32, (g >> 32) & _MASK32, stream),
        (seed & _MASK32, seed >> 32),
    )
    k = torch.stack(words, dim=-1).reshape(len(gid), 4 * nquads)[:, :n] >> 8
    return k.t().contiguous() if layout == "nb" else k


def uniform_philox_lanes_plain(seed: int, gid: torch.Tensor,
                               step: torch.Tensor, n: int, domain: int,
                               layout: str = "nb", with_bits: bool = False):
    """Plain PyTorch twin of B3's per-lane instance."""
    _check_lanes(gid, step, n, domain, layout)
    k = _plain_lane_bits(seed, gid, step, n, domain, layout)
    u = _plain_uniform(k)
    return (u, k.to(torch.int32)) if with_bits else u


def gauss_philox_lanes_plain(seed: int, gid: torch.Tensor, step: torch.Tensor,
                             n: int, domain: int, offset: float, scale: float,
                             layout: str = "nb", with_bits: bool = False):
    """Plain PyTorch twin of B4's per-lane instance."""
    _check_lanes(gid, step, n, domain, layout)
    k = _plain_lane_bits(seed, gid, step, n, domain, layout)
    nrm = _SQRT2 * torch.erfinv(2.0 * _plain_uniform(k) - 1.0)
    y = offset + scale * nrm
    return (y, k.to(torch.int32)) if with_bits else y


def _draw_lanes(entry, name, seed, gid, step, n, domain, layout, with_bits,
                *scalars):
    device = gid.device
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    _check_lanes(gid, step, n, domain, layout)
    if not 0 <= seed < _U64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    gid, step = gid.contiguous(), step.contiguous()
    batch = gid.shape[0]
    shape = (n, batch) if layout == "nb" else (batch, n)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    bits = (torch.empty(shape, dtype=torch.int32, device=device)
            if with_bits else None)
    build.launch_philox(
        entry, name, seed, gid.data_ptr(), step.data_ptr(), batch, n, domain,
        LAYOUTS[layout], *scalars, out.data_ptr(),
        bits.data_ptr() if with_bits else None, device.index,
        build.stream_of(device),
    )
    return (out, bits) if with_bits else out


def uniform_philox_lanes(seed: int, gid: torch.Tensor, step: torch.Tensor,
                         n: int, domain: int, layout: str = "nb",
                         with_bits: bool = False):
    """Keyed uniforms of lane b's frame ``gid[b]`` at its step ``step[b]``
    (stream ``1 + 2·step[b] + domain``), in :func:`uniform_philox`'s
    layouts, on gid's device.  CPU: the plain twin.  CUDA: kernel B3's
    per-lane instance, or an exception."""
    if gid.device.type == "cpu":
        return uniform_philox_lanes_plain(seed, gid, step, n, domain,
                                          layout, with_bits)
    return _draw_lanes("ldpc_uniform_philox_lanes", "uniform_philox_lanes",
                       seed, gid, step, n, domain, layout, with_bits)


def gauss_philox_lanes(seed: int, gid: torch.Tensor, step: torch.Tensor,
                       n: int, domain: int, offset: float, scale: float,
                       layout: str = "nb", with_bits: bool = False):
    """Keyed Gaussians ``offset + scale·(√2·erfinv(2u − 1))`` on the
    per-lane uniforms of :func:`uniform_philox_lanes`.  CPU: the plain
    twin.  CUDA: kernel B4's per-lane instance, or an exception."""
    if gid.device.type == "cpu":
        return gauss_philox_lanes_plain(seed, gid, step, n, domain, offset,
                                        scale, layout, with_bits)
    return _draw_lanes("ldpc_gauss_philox_lanes", "gauss_philox_lanes", seed,
                       gid, step, n, domain, layout, with_bits, offset,
                       scale)
