"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, checks each
against its plain PyTorch twin on the card, and drives the min-sum main path
at full width.

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
  6. the sweep CLI in-process for one point, and its log row.

The last two lines are one JSON object describing the kernels and one
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import torch

CODE = "qc_1008_504"
BATCH = 32768
SNR_DB = 2.0
T = 10
SEED = 2024


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

    def dec(y):
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

    summary = {
        "card": card,
        "ber": stats.ber,
        "decoded_info_bits_per_s": rate,
        "breakdown_ms": parts,
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
