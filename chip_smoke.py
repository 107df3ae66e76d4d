"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, checks each
against its plain PyTorch twin on the card, and drives the min-sum main path
and the SMNGDBF bit-flip path at full width.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (``CUDA_HOME`` or /usr/local/cuda) and this
checkout.  Phases (any failed check raises and the exit code is non-zero):

  1. the card (``nvidia-smi`` name and power limit);
  2. build the kernels from ``ldpcsimulation_tpu_torch/csrc`` (seconds, and
     the compiler's register report);
  3. kernel B1 (min-sum CN update) against its twin at the main path's
     shapes — qc_1008_504, B=32768, f16 and f32 storage, all three
     variants — equal under ``torch.equal``;
  4. kernel B2 (Philox AWGN) against its twin: equal 24-bit integers, y
     within 1e-5 (FMA-free arithmetic, but libdevice's logf/cosf against
     PyTorch's), then the decode of that y with the kernels equal bit for
     bit to the plain path's decode on the CPU;
  5. the main path: ``simulate`` on qc_1008_504 at 2.0 dB, T=10, f16
     storage, 4 batches of 32768 frames, with the launch counters reset just
     before and read just after — BER in [2.2e-2, 2.6e-2], both kernels
     launched; decoded info bits/s and a per-layer time breakdown;
  6. the sweep CLI in-process for one point, and its log row;
  7. kernel B3 (keyed Philox uniforms) against its twin at [1008 x 32768]
     in both layouts: equal under ``torch.equal``, on the 24-bit grid;
  8. kernel B4 (keyed erfinv Gaussians) against its twin, channel form
     (offset 1, scale sigma) and decoder form (offset 0): equal 24-bit
     integers, values within 4 ulps of the decoder form (libdevice's
     erfinvf against PyTorch's erfinv; |dy| <= 4e-6 in the channel form),
     and the channel form's moments;
  9. the GDBF decode on the card against the CPU plain path, bit for bit,
     for SMNGDBF, RSMNGDBF (3 phases) and StochasticNGDBF at 256 frames:
     the keyed draws are made on the card (B4/B3), copied to the CPU and
     injected there; the keyed card decode also equals the card decode
     with its own draws injected;
 10. the SMNGDBF main path: ``simulate`` on qc_1008_504 at 3.25 dB, T=300,
     4 batches of 32768 frames after a warm-up batch, counters reset just
     before and read just after — B2 launched once per batch, B4 once per
     executed decoder step, B1 never; BER, FER and average iterations
     within 4 joint standard errors of the JAX package's values; decoded
     info bits/s and a per-layer breakdown;
 11. the sweep CLI's gdbf route for one point each of ``SMNGDBF
     --uniform-noise`` and ``StochasticNGDBF --nq 3 --ymax 2.5``, counters
     reset before and read after: B3 launched, rows well formed.

The last two lines are one JSON object describing the kernels (each with
the launches of the path that runs it) and one
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile

import numpy as np
import torch

CODE = "qc_1008_504"
BATCH = 32768
SNR_DB = 2.0
T = 10
SEED = 2024

# The SMNGDBF path: the reference's ngdbf_example_PEGReg504x1008.sh point
# with the working alpha of docs/VALIDATION.md, on qc_1008_504.
GDBF_SNR_DB = 3.25
GDBF_T = 300
GDBF_KW = dict(theta=-0.9, noise_scale=0.975, lam=0.988, alpha=0.75,
               window_size=64)
GDBF_YMAX = 2.5
# The JAX package's statistics at that point (its CPU run, 131072 frames,
# seed 0; PERF.md): (value, standard error).
JAX_SMNGDBF = dict(
    ber=(2.676872980026972e-04, 1.0231122548830475e-05),
    fer=(1.318359375e-02, 3.1505046386775366e-04),
    avg_iterations=(73.43167877197266, 0.13458862689481313),
)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tied_messages(gen, rows, batch, dtype, device):
    """Messages with exact ties, zeros and -0.0 (the scan's hazards)."""
    v = torch.round(torch.randn(rows, batch, generator=gen, device=device)
                    * 4.0) / 2.0
    neg_zero = torch.rand(rows, batch, generator=gen, device=device) < 0.05
    v = torch.where(neg_zero, torch.full_like(v, -0.0), v)
    return v.to(dtype)


def phase_b1(qc, device, batch, sigma, timer):
    """Kernel B1 against its twin at the main path's shapes.  Returns
    (max |kernel - plain|, {dtype: (kernel ms, plain ms)})."""
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import (
        qc_plan,
        qc_ragged_init,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox
    from ldpcsimulation_tpu_torch.kernels.minsum import (
        minsum_cn_scan,
        minsum_cn_scan_plain,
    )

    plan = qc_plan(qc, device)
    gen = torch.Generator(device=device).manual_seed(7)
    y = awgn_philox(SEED, 0, batch, qc.n, sigma, device)
    times, max_err = {}, 0.0
    for dtype in (torch.float16, torch.float32):
        states = {
            "channel": qc_ragged_init(qc, y.t().contiguous(), dtype),
            "tied": tied_messages(gen, plan.num_planes * qc.z, batch, dtype,
                                  device),
        }
        for variant, kw in (("plain", {}), ("normalized", {"alpha": 0.8}),
                            ("offset", {"delta": 0.15})):
            for name, v2c in states.items():
                got = minsum_cn_scan(v2c, plan.cn_rows, variant, **kw)
                want = minsum_cn_scan_plain(v2c, plan.cn_rows, variant, **kw)
                max_err = max(max_err, float((got - want).abs().max()))
                check(torch.equal(got, want),
                      f"B1 {variant} {dtype} {name}: kernel != plain")
            print(f"  B1 {variant:10s} {str(dtype):13s} equal (2 states)")
        v2c = states["channel"]
        times[dtype] = (
            timer(lambda: minsum_cn_scan(v2c, plan.cn_rows)),
            timer(lambda: minsum_cn_scan_plain(v2c, plan.cn_rows), 3),
        )
        print(f"  B1 {str(dtype)} kernel {times[dtype][0]:.4f} ms, plain "
              f"{times[dtype][1]:.4f} ms per call [{plan.num_planes * qc.z}"
              f" x {batch}]")
    return max_err, times


def phase_b2(qc, device, batch, sigma, timer):
    """Kernel B2 against its twin, then the decode of its samples."""
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.kernels.channel import (
        awgn_philox,
        awgn_philox_plain,
    )

    y, bits = awgn_philox(SEED, 5 * batch, batch, qc.n, sigma, device,
                          with_bits=True)
    y_p, bits_p = awgn_philox_plain(SEED, 5 * batch, batch, qc.n, sigma,
                                    device, with_bits=True)
    check(torch.equal(bits, bits_p), "B2 24-bit integers: kernel != plain")
    err = float((y - y_p).abs().max())
    check(err <= 1e-5, f"B2 samples differ by {err} > 1e-5")
    print(f"  B2 integers equal, max |y - y_plain| = {err:.3g} "
          f"(exactly equal: {torch.equal(y, y_p)})")
    check(abs(float(y.mean()) - 1.0) < 2e-3
          and abs(float(y.std()) - sigma) < 2e-3, "B2 moments")

    sdt = torch.float16
    sub = min(batch, 4096)
    for et, rows in ((False, sub), (True, min(batch, 1024))):
        res = decode_minsum_qc(qc, y, T, early_termination=et,
                               storage_dtype=sdt)
        ref = decode_minsum_qc(qc, y[:rows].cpu(), T, early_termination=et,
                               storage_dtype=sdt)
        for f in ("hard", "iterations", "satisfied"):
            check(torch.equal(getattr(res, f)[:rows].cpu(), getattr(ref, f)),
                  f"decode (early_termination={et}) {f}: kernel path != "
                  "plain path")
        print(f"  decode of B2's samples (ET={et}): kernel path on the card"
              f" == plain path on the CPU for {rows} frames")
    times = (
        timer(lambda: awgn_philox(SEED, 0, batch, qc.n, sigma, device)),
        timer(lambda: awgn_philox_plain(SEED, 0, batch, qc.n, sigma, device),
              3),
    )
    print(f"  B2 kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms per call "
          f"[{batch} x {qc.n}]")
    return err, times


def breakdown(qc, device, batch, sigma, timer):
    """Device time of each layer of one main-path batch (CUDA events)."""
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import (
        qc_check_satisfied,
        qc_minsum_step,
        qc_plan,
        qc_ragged_init,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import awgn_philox
    from ldpcsimulation_tpu_torch.kernels.minsum import minsum_cn_scan

    plan = qc_plan(qc, device)
    y = awgn_philox(SEED, 0, batch, qc.n, sigma, device)
    yt = y.t().contiguous()
    v2c = qc_ragged_init(qc, yt, torch.float16)
    step = qc_minsum_step(qc, storage_dtype=torch.float16)
    d = torch.where(yt > 0, 1, -1).to(torch.int32)
    parts = {
        "channel (B2)": timer(
            lambda: awgn_philox(SEED, 0, batch, qc.n, sigma, device)),
        "CN update (B1)": timer(lambda: minsum_cn_scan(v2c, plan.cn_rows)),
        "iteration (B1 + VN)": timer(lambda: step(v2c, yt)),
        "syndrome check": timer(lambda: qc_check_satisfied(qc, d)),
        "decode T=10": timer(
            lambda: decode_minsum_qc(qc, y, T, storage_dtype=torch.float16),
            3),
        "error count": timer(lambda: (d.t() != 1).sum(dim=1)),
    }
    for k, v in parts.items():
        print(f"  {k:22s} {v:9.4f} ms")
    return parts


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place, for finite f32 values of one
    sign (int64 distance of the bit patterns)."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def phase_b3(n, device, batch, timer):
    """Kernel B3 against its twin in both layouts."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        noise_stream,
        uniform_philox,
        uniform_philox_plain,
    )

    stream = noise_stream(17, 1)
    max_err = 0.0
    for layout in ("nb", "bn"):
        u, k = uniform_philox(SEED, 3 * batch, batch, n, stream, device,
                              layout, with_bits=True)
        u_p, k_p = uniform_philox_plain(SEED, 3 * batch, batch, n, stream,
                                        layout, device, with_bits=True)
        check(torch.equal(k, k_p), f"B3 {layout} integers: kernel != plain")
        max_err = max(max_err, float((u - u_p).abs().max()))
        check(torch.equal(u, u_p), f"B3 {layout} uniforms: kernel != plain")
        check(bool((u > 0).all()) and bool((u <= 1).all()),
              f"B3 {layout} range")
        check(torch.equal(u, (k.float() + 0.5) * 2.0**-24),
              f"B3 {layout} grid")
        check(abs(float(u.mean()) - 0.5) < 1e-3, f"B3 {layout} mean")
        print(f"  B3 {layout}: kernel == plain, {u.numel()} uniforms in "
              "(0, 1] on the grid")
    times = (
        timer(lambda: uniform_philox(SEED, 0, batch, n, stream, device)),
        timer(lambda: uniform_philox_plain(SEED, 0, batch, n, stream, "nb",
                                           device), 3),
    )
    print(f"  B3 kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms per call "
          f"[{n} x {batch}]")
    return max_err, times


def phase_b4(n, device, batch, sigma, timer):
    """Kernel B4 against its twin, channel form and decoder form."""
    from ldpcsimulation_tpu_torch.kernels.channel import (
        gauss_philox,
        gauss_philox_plain,
        noise_stream,
    )

    stream = noise_stream(5, 0)
    max_err = 0.0
    for form, offset, scale, layout in (("channel", 1.0, sigma, "bn"),
                                        ("decoder", 0.0, 0.6817, "nb")):
        y, k = gauss_philox(SEED, 7 * batch, batch, n, stream, offset,
                            scale, device, layout, with_bits=True)
        y_p, k_p = gauss_philox_plain(SEED, 7 * batch, batch, n, stream,
                                      offset, scale, layout, device,
                                      with_bits=True)
        check(torch.equal(k, k_p), f"B4 {form} integers: kernel != plain")
        fin = torch.isfinite(y_p)
        check(torch.equal(fin, torch.isfinite(y))
              and torch.equal(y[~fin], y_p[~fin]), f"B4 {form} infinities")
        err = float((y[fin] - y_p[fin]).abs().max())
        max_err = max(max_err, err)
        u = ulps(y[fin], y_p[fin])
        exact = float((y == y_p).float().mean())
        print(f"  B4 {form} form: integers equal, max |y - y_plain| = "
              f"{err:.3g}, max {int(u.max())} ulps, exactly equal "
              f"{exact:.4f}, {int((~fin).sum())} infinite (u = 1.0)")
        if form == "decoder":
            check(int(u.max()) <= 4, f"B4 decoder form {int(u.max())} ulps")
        else:
            check(err <= 4e-6, f"B4 channel form |dy| {err} > 4e-6")
            yf = y[fin]
            check(abs(float(yf.mean()) - 1.0) < 2e-3
                  and abs(float(yf.std()) - sigma) < 2e-3, "B4 moments")
    times = (
        timer(lambda: gauss_philox(SEED, 0, batch, n, stream, 0.0, 0.6817,
                                   device)),
        timer(lambda: gauss_philox_plain(SEED, 0, batch, n, stream, 0.0,
                                         0.6817, "nb", device), 3),
    )
    print(f"  B4 kernel {times[0]:.4f} ms, plain {times[1]:.4f} ms per call "
          f"[{n} x {batch}]")
    return max_err, times


def phase_gdbf_equal(qc, device, frames=256):
    """The GDBF decode on the card against the CPU plain path, bit for bit,
    on the card's keyed draws."""
    from ldpcsimulation_tpu_torch.channel import (
        awgn_all_zero,
        saturate,
        snr_to_sigma,
    )
    from ldpcsimulation_tpu_torch.decoders import (
        NoiseKey,
        decode_gdbf,
        keyed_draws,
        preset,
    )
    from ldpcsimulation_tpu_torch.kernels import build

    fields = ("hard", "iterations", "satisfied", "phases", "smoothing_used")
    code_d, code_c = qc.to_code(device), qc.to_code("cpu")
    rate = (qc.n - qc.m) / qc.n
    for name, snr, T, extra in (
        ("SMNGDBF", 3.25, 100, {}),
        ("RSMNGDBF", 3.0, 40, dict(max_phases=3)),
        ("StochasticNGDBF", 3.5, 100, {}),
    ):
        cfg = preset(name, T, **GDBF_KW, **extra)
        sigma = snr_to_sigma(snr, rate)
        frame0 = 11 * frames
        y = saturate(awgn_all_zero(SEED, frame0, frames, qc.n, sigma,
                                   device), GDBF_YMAX)
        key = NoiseKey(SEED, frame0)
        build.LAUNCHES.clear()
        res = decode_gdbf(code_d, y, sigma, cfg, key=key, qc=qc)
        launched = dict(build.LAUNCHES)
        want = {"gauss_philox": res.steps} if cfg.add_noise else {
            "uniform_philox": res.steps}
        check(launched == want, f"{name}: launches {launched} != {want}")
        steps = cfg.max_phases * T
        pert, unif = keyed_draws(cfg, sigma, key, qc.n, frames, steps,
                                 device)
        inj = decode_gdbf(code_d, y, sigma, cfg, perturbations=pert,
                          stoch_uniforms=unif, qc=qc)
        cpu = decode_gdbf(
            code_c, y.cpu(), sigma, cfg, qc=qc,
            perturbations=None if pert is None else pert.cpu(),
            stoch_uniforms=None if unif is None else unif.cpu(),
        )
        for f in fields:
            got = getattr(res, f)
            check(torch.equal(got, getattr(inj, f)),
                  f"{name} {f}: keyed != injected on the card")
            check(torch.equal(got.cpu(), getattr(cpu, f)),
                  f"{name} {f}: card != CPU plain path")
        drawn = (pert if pert is not None else unif).numel() * 4
        unsat = float((~res.satisfied).float().mean())
        print(f"  {name} T={T} x{cfg.max_phases}: card == CPU for "
              f"{frames} frames ({res.steps} steps, {drawn / 1e6:.0f} MB "
              f"injected, unsatisfied {unsat:.3g}, max phases "
              f"{int(res.phases.max())}); launches {launched}")


def mc_moments(stats, n):
    """(value, standard error) of BER, FER and average iterations from a
    run's per-frame histograms."""
    f = stats.total_words
    w = np.arange(1, n + 1)
    h = stats.error_weight_hist
    mean_e = stats.errors / f
    ber_se = math.sqrt(((w**2 * h).sum() / f - mean_e**2) / (f - 1)) / n
    ith = stats.iteration_hist
    it = np.arange(len(ith))
    mean_i = (it * ith).sum() / f
    it_se = math.sqrt(((it**2 * ith).sum() / f - mean_i**2) / (f - 1))
    fer_se = math.sqrt(stats.fer * (1 - stats.fer) / f)
    return dict(ber=(stats.ber, ber_se), fer=(stats.fer, fer_se),
                avg_iterations=(stats.avg_iterations, it_se))


def gdbf_breakdown(qc, device, batch, sigma, timer):
    """Device time of each layer of one SMNGDBF step at full width."""
    from ldpcsimulation_tpu_torch.channel import awgn_all_zero, saturate
    from ldpcsimulation_tpu_torch.decoders import NoiseKey, decode_gdbf
    from ldpcsimulation_tpu_torch.decoders import gdbf as gd
    from ldpcsimulation_tpu_torch.decoders.qc_ops import (
        qc_syndrome_bipolar,
        qc_syndrome_sum_per_vn,
    )
    from ldpcsimulation_tpu_torch.kernels.channel import gauss_philox

    cfg = gd.preset("SMNGDBF", GDBF_T, **GDBF_KW)
    code = qc.to_code(device)
    y = saturate(awgn_all_zero(SEED, 0, batch, qc.n, sigma, device),
                 GDBF_YMAX)
    yt = y.t().contiguous()
    ns = float(np.float32(sigma * cfg.noise_scale))
    d = torch.where(torch.signbit(yt), -1, 1).to(torch.int32)
    syn = qc_syndrome_bipolar(qc, d)
    svn = qc_syndrome_sum_per_vn(qc, syn.float())
    pert = gauss_philox(SEED, 0, batch, qc.n, 1, 0.0, ns, device)
    thetas = torch.full_like(yt, cfg.theta)
    mu = torch.ones(batch, dtype=torch.int32, device=device)
    act = torch.ones(batch, dtype=torch.bool, device=device)
    dsum = torch.zeros_like(d)
    nsig = torch.tensor(ns, device=device)

    def metric_and_flip():
        e = d.float() * yt + cfg.alpha * svn + pert
        flip, _ = gd.flip_decisions(cfg, e, thetas, mu, nsig, None)
        return torch.where(act[None, :] & flip, -d, d)

    flip, _ = gd.flip_decisions(cfg, yt, thetas, mu, nsig, None)

    def adapt_and_smooth():
        th = torch.where(act[None, :] & ~flip, thetas * cfg.lam, thetas)
        ds = torch.where(act[None, :], dsum + d, dsum)
        return th, ds

    parts = {
        "noise draw (B4)": timer(
            lambda: gauss_philox(SEED, 0, batch, qc.n, 1, 0.0, ns, device)),
        "syndrome": timer(lambda: qc_syndrome_bipolar(qc, d)),
        "syndrome test (all > 0)": timer(lambda: (syn > 0).all(dim=0)),
        "per-VN syndrome sum": timer(
            lambda: qc_syndrome_sum_per_vn(qc, syn.float())),
        "flip metric + decision": timer(metric_and_flip),
        "adaptation + smoothing": timer(adapt_and_smooth),
        f"decode T={GDBF_T} (one batch)": timer(
            lambda: decode_gdbf(code, y, sigma, cfg, key=NoiseKey(SEED, 0),
                                qc=qc), 2),
    }
    for k, v in parts.items():
        print(f"  {k:30s} {v:9.4f} ms")
    return parts


def phase_gdbf_main(qc, device, batch, timer):
    """The SMNGDBF path at full width through ``simulate``."""
    from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
    from ldpcsimulation_tpu_torch.decoders import decode_gdbf, preset
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build

    code = qc.to_code(device)
    rate = (qc.n - qc.m) / qc.n
    sigma = snr_to_sigma(GDBF_SNR_DB, rate)
    cfg = preset("SMNGDBF", GDBF_T, **GDBF_KW)
    steps = []

    def dec(yq, key):
        res = decode_gdbf(code, yq, sigma, cfg, key=key, qc=qc)
        steps.append(res.steps)
        return res

    def run(frames):
        return simulate(code, dec, GDBF_SNR_DB, stop=StopRule.fixed_frames(
            frames), batch_size=batch, seed=SEED, device=device,
            preprocess=lambda y: saturate(y, GDBF_YMAX))

    run(batch)  # warm-up batch
    torch.cuda.synchronize()
    steps.clear()
    build.LAUNCHES.clear()
    stats = run(4 * batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    rate_bits = stats.total_words * (qc.n - qc.m) / stats.wall_seconds
    print(f"  BER {stats.ber!r} FER {stats.fer!r} avg iterations "
          f"{stats.avg_iterations!r} over {stats.total_words} frames in "
          f"{stats.wall_seconds:.4f} s: {rate_bits:.6g} decoded info bits/s;"
          f" steps per batch {steps}; launches {launches}; smoothing used "
          f"{stats.extra.get('smoothing_used')}")
    check(launches == {"awgn_philox": 4, "gauss_philox": sum(steps)},
          f"SMNGDBF path launches {launches}, steps {steps}")
    got = mc_moments(stats, qc.n)
    for k, (want, want_se) in JAX_SMNGDBF.items():
        val, se = got[k]
        bound = 4 * math.hypot(se, want_se)
        print(f"  {k}: port {val:.6g} (se {se:.3g}), JAX {want:.6g} (se "
              f"{want_se:.3g}), |diff| {abs(val - want):.3g} <= {bound:.3g}")
        check(abs(val - want) <= bound, f"SMNGDBF {k} outside 4 joint s.e.")
    parts = gdbf_breakdown(qc, device, batch, sigma, timer)
    return stats, rate_bits, launches, parts


def phase_gdbf_sweep(device, batch):
    """The sweep CLI's gdbf route, one point each of the uniform-noise and
    stochastic variants."""
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    common = ["gdbf", "--code", CODE, "-T", "100", "--batch", str(batch),
              "--max-frames", str(2 * batch), "--min-errors", "0",
              "--min-word-errors", "0", "--device", str(device)]
    runs = (
        (["--preset", "SMNGDBF", "--uniform-noise", "--snr", "3.25",
          "--theta", "-0.9", "--noise-scale", "0.975", "--lam", "0.988",
          "--alpha", "0.75", "--window", "64", "--ymax", "2.5"],
         ["3.25", None, None, None, str(2 * batch * 1008),
          str(2 * batch), "100", "-0.9", "0.975", "0.988", "0.75", None,
          None, "64", "2.5", CODE]),
        (["--preset", "StochasticNGDBF", "--snr", "3.5", "--nq", "3",
          "--ymax", "2.5"],
         ["3.5", None, None, None, str(2 * batch * 1008), str(2 * batch),
          "100", "-0.9", "1", "3", "2.25", "2.5", CODE]),
    )
    build.LAUNCHES.clear()
    rows = []
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i, (args, want) in enumerate(runs):
            log_path = f"{tmp}/gdbf{i}.log"
            rc = sweep_main(common + args + ["--log", log_path])
            with open(log_path) as f:
                row = f.read().splitlines()
            check(rc == 0 and len(row) == 1, "gdbf sweep wrote one row")
            cols = row[0].split("\t")
            check(len(cols) == len(want) and all(
                w is None or c == w for c, w in zip(cols, want)),
                f"gdbf sweep row {cols}")
            check(0.0 <= float(cols[1]) <= 0.5, f"BER {cols[1]}")
            rows.append(row[0])
            print(f"  row: {row[0]}")
    launches = dict(build.LAUNCHES)
    print(f"  launches {launches}")
    check(launches.get("uniform_philox", 0) > 0, "B3 not launched")
    check(launches.get("awgn_philox", 0) == 4, f"B2 launches {launches}")
    return rows, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ldpcsimulation_tpu_torch.channel import snr_to_sigma
    from ldpcsimulation_tpu_torch.codes import load_named_qc
    from ldpcsimulation_tpu_torch.decoders import decode_minsum_qc
    from ldpcsimulation_tpu_torch.harness import StopRule, simulate
    from ldpcsimulation_tpu_torch.kernels import build
    from ldpcsimulation_tpu_torch.tools.sweep import main as sweep_main

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    path, log, secs = build.build()
    build.library()
    print(f"[2] built {path.name} in {secs:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"    {line.strip()}")

    qc = load_named_qc(CODE)
    sigma = snr_to_sigma(SNR_DB, (qc.n - qc.m) / qc.n)
    print(f"[3] B1 vs plain, {CODE}, B={BATCH}")
    b1_err, b1_times = phase_b1(qc, device, BATCH, sigma, time_ms)
    print("[4] B2 vs plain")
    b2_err, b2_times = phase_b2(qc, device, BATCH, sigma, time_ms)

    print(f"[5] main path: simulate {CODE} {SNR_DB} dB T={T} f16, "
          f"4 x {BATCH} frames")
    code = qc.to_code(device)

    def dec(y, key):
        return decode_minsum_qc(qc, y, T, storage_dtype=torch.float16)

    def run():
        return simulate(code, dec, SNR_DB, stop=StopRule.fixed_frames(
            4 * BATCH), batch_size=BATCH, seed=SEED, device=device)

    run()  # warm-up: allocator and caches
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    stats = run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    rate = stats.total_words * (qc.n - qc.m) / stats.wall_seconds
    print(f"  BER {stats.ber!r} FER {stats.fer!r} over {stats.total_words} "
          f"frames in {stats.wall_seconds:.4f} s: {rate:.6g} decoded info "
          f"bits/s; launches {launches}")
    check(2.2e-2 <= stats.ber <= 2.6e-2, f"BER {stats.ber} outside "
          "[2.2e-2, 2.6e-2]")
    check(launches.get("minsum_cn_scan", 0) > 0, "B1 not launched")
    check(launches.get("awgn_philox", 0) > 0, "B2 not launched")
    check(launches["minsum_cn_scan"] == 4 * T and launches["awgn_philox"] == 4,
          f"unexpected launch counts {launches}")
    parts = breakdown(qc, device, BATCH, sigma, time_ms)

    print("[6] sweep CLI, one point")
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        log_path = f"{tmp}/sweep.log"
        rc = sweep_main([
            "minsum", "--code", CODE, "--snr", "2.0", "-T", "10",
            "--msg-dtype", "f16", "--batch", str(BATCH), "--max-frames",
            str(2 * BATCH), "--log", log_path,
        ])
        with open(log_path) as f:
            row = f.read().splitlines()
    print(f"  row: {row}")
    check(rc == 0 and len(row) == 1, "sweep wrote one row")
    cols = row[0].split("\t")
    check(len(cols) == 6 and cols[0] == "2" and cols[4] == "10"
          and cols[5] == CODE and 2.2e-2 <= float(cols[1]) <= 2.6e-2,
          f"sweep row {cols}")

    n = qc.n
    print(f"[7] B3 vs plain [{n} x {BATCH}]")
    b3_err, b3_times = phase_b3(n, device, BATCH, time_ms)
    print(f"[8] B4 vs plain [{n} x {BATCH}]")
    b4_err, b4_times = phase_b4(n, device, BATCH, sigma, time_ms)
    print("[9] GDBF decode: card vs CPU plain path on injected draws")
    phase_gdbf_equal(qc, device)
    print(f"[10] SMNGDBF path: simulate {CODE} {GDBF_SNR_DB} dB T={GDBF_T},"
          f" 4 x {BATCH} frames")
    g_stats, g_rate, g_launches, g_parts = phase_gdbf_main(
        qc, device, BATCH, time_ms)
    print("[11] sweep CLI, gdbf route")
    _, s_launches = phase_gdbf_sweep(device, BATCH)

    summary = {
        "card": card,
        "ber": stats.ber,
        "decoded_info_bits_per_s": rate,
        "breakdown_ms": parts,
        "smngdbf": {
            "ber": g_stats.ber, "fer": g_stats.fer,
            "avg_iterations": g_stats.avg_iterations,
            "frames": g_stats.total_words,
            "decoded_info_bits_per_s": g_rate,
            "breakdown_ms": g_parts,
        },
    }
    print(json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": [
        {"name": "minsum_cn_scan", "route": "cuda",
         "source": "ldpcsimulation_tpu_torch/csrc/minsum_cn_scan.cu",
         "replaces": "ldpcsimulation_tpu/kernels/minsum_pallas.py:60",
         "launches": launches["minsum_cn_scan"], "max_abs_err": b1_err,
         "ms": b1_times[torch.float16][0],
         "plain_ms": b1_times[torch.float16][1]},
        {"name": "awgn_philox", "route": "cuda",
         "source": "ldpcsimulation_tpu_torch/csrc/awgn_philox.cu",
         "replaces": "ldpcsimulation_tpu/kernels/channel_pallas.py:56",
         "launches": launches["awgn_philox"], "max_abs_err": b2_err,
         "ms": b2_times[0], "plain_ms": b2_times[1]},
        {"name": "uniform_philox", "route": "cuda",
         "source": "ldpcsimulation_tpu_torch/csrc/uniform_philox.cu",
         "replaces": "ldpcsimulation_tpu/kernels/channel_pallas.py:89",
         "launches": s_launches["uniform_philox"], "max_abs_err": b3_err,
         "ms": b3_times[0], "plain_ms": b3_times[1]},
        {"name": "gauss_philox", "route": "cuda",
         "source": "ldpcsimulation_tpu_torch/csrc/uniform_philox.cu",
         "replaces": "ldpcsimulation_tpu/kernels/channel_pallas.py:114",
         "launches": g_launches["gauss_philox"], "max_abs_err": b4_err,
         "ms": b4_times[0], "plain_ms": b4_times[1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
