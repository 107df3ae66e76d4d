"""Throughput of the slot mesh over the cards of one host.

Times the mesh's counters step (one slot per card, ``batch`` frames per
slot) for two decoders that read the host inside their decode — QC min-sum
with early termination at 2.0 dB, T=10, f16, and SMNGDBF at 3.25 dB, T=100
(a host read every 4 steps) — on qc_1008_504, for each card count of
``--cards``.  By default one process drives the cards, their slots one
after another (:func:`..parallel.montecarlo.measure_scaling_efficiency`);
before it times a count it checks the mesh: one round of the n-card mesh
must give the counters of n slots on the first card (the same frames, so
the same integers).  ``--ranks`` runs each count as n processes of one
group, one card each (:func:`..parallel.mesh.spawn_ranks`), as the
sweep's ``--distributed`` does on a host with several cards.

    python -m ldpcsimulation_tpu_torch.tools.mesh_scaling [--cards 1,2,4] \\
        [--batch 32768] [--repeats 3] [--ranks]

Prints the card line, one row per (decoder, cards) with its decoded info
bits/s (and, in one process, the efficiency (T_n / n) / T_1), and then
the rows as one JSON object (with ``--ranks``, one object per count, from
rank 0).  Exits 1 when a mesh's counters disagree.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ldpcsimulation_tpu_torch.channel import saturate, snr_to_sigma
from ldpcsimulation_tpu_torch.codes import load_named_qc
from ldpcsimulation_tpu_torch.decoders import (
    decode_gdbf,
    decode_minsum_qc,
    preset,
)
from ldpcsimulation_tpu_torch.parallel.mesh import (
    init_distributed,
    local_cuda_devices,
    make_counters_step,
    make_mesh,
    spawn_ranks,
    world,
)
from ldpcsimulation_tpu_torch.parallel.montecarlo import (
    measure_scaling_efficiency,
)
from ldpcsimulation_tpu_torch.tools.perf_report import card_line

CODE = "qc_1008_504"
SMNGDBF = dict(theta=-0.9, noise_scale=0.975, lam=0.988, alpha=0.75,
               window_size=64)


def decoders(qc):
    """{name: (snr_db, T, decode_fn(y, sigma, key))}; the code's tables
    are copied to each card once."""
    codes = {}

    def code_on(dev):
        if dev not in codes:
            codes[dev] = qc.to_code(dev)
        return codes[dev]

    cfg = preset("SMNGDBF", 100, **SMNGDBF)
    return {
        "minsum": (2.0, 10, lambda y, sigma, key: decode_minsum_qc(
            qc, y, 10, early_termination=True,
            storage_dtype=torch.float16)),
        "smngdbf": (3.25, 100, lambda y, sigma, key: decode_gdbf(
            code_on(y.device), saturate(y, 2.5), sigma, cfg, key=key,
            qc=qc)),
    }


def same_counters(qc, decode_fn, sigma, T, devices, batch) -> bool:
    """One round on a mesh of ``devices`` against the same slots all on
    the first device."""
    code = qc.to_code(devices[0])
    out = []
    for devs in (devices, [devices[0]] * len(devices)):
        step = make_counters_step(code, decode_fn, make_mesh(1, devs),
                                  [sigma], batch, T)
        out.append(step(0))
    return all(np.array_equal(out[0][k], out[1][k]) for k in out[0])


def rank_rows(qc, batch, repeats) -> tuple:
    """One rank of a ``--ranks`` count: (this rank, each decoder's bits/s
    on the default mesh, one card per rank, the same on every rank)."""
    import torch.distributed as dist

    init_distributed()
    try:
        mesh = make_mesh()
        torch.cuda.set_device(mesh.home)
        rows = []
        for name, (snr, T, fn) in decoders(qc).items():
            step = make_counters_step(
                qc.to_code(mesh.home), fn, mesh,
                [snr_to_sigma(snr, (qc.n - qc.m) / qc.n)], batch, T)
            step(0)  # warm-up
            t0 = time.perf_counter()
            for i in range(repeats):
                step(0, i)  # each step ends in its all-reduce and host copy
            dt = (time.perf_counter() - t0) / repeats
            rows.append(dict(decoder=name, cards=mesh.size,
                             ranks=world()[1], batch=batch,
                             bits_per_s=step.batch_global * (qc.n - qc.m)
                             / dt))
        return world()[0], rows
    finally:
        dist.destroy_process_group()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="mesh_scaling")
    p.add_argument("--cards", default="1,2,4",
                   help="card counts to time (default 1,2,4)")
    p.add_argument("--batch", type=int, default=32768,
                   help="frames per slot and round")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--ranks", action="store_true",
                   help="one process per card in place of one process for "
                        "all cards")
    args = p.parse_args(argv)
    counts = [int(c) for c in args.cards.split(",")]
    qc = load_named_qc(CODE)
    if "WORLD_SIZE" in os.environ:  # a rank that --ranks started
        rank, rows = rank_rows(qc, args.batch, args.repeats)
        if rank == 0:
            for r in rows:
                print(f"{r['decoder']}: {r['cards']} cards in {r['ranks']} "
                      f"ranks {r['bits_per_s']:.6g} decoded info bits/s")
            print(json.dumps({"mesh_scaling": rows}), flush=True)
        return 0
    cards = local_cuda_devices()
    print(card_line(cards[0]), flush=True)
    if args.ranks:
        # n ranks on the first n cards: the ranks see those cards only
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        ids = (seen.split(",") if seen else
               [str(i) for i in range(torch.cuda.device_count())])
        try:
            for n in counts:
                os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids[:n])
                rc = spawn_ranks(
                    [sys.executable, "-m",
                     "ldpcsimulation_tpu_torch.tools.mesh_scaling",
                     "--batch", str(args.batch), "--repeats",
                     str(args.repeats)], n)
                if rc:
                    return rc
        finally:
            if seen is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = seen
        return 0
    rows, ok = [], True
    for name, (snr, T, fn) in decoders(qc).items():
        sigma = snr_to_sigma(snr, qc.to_code().rate)
        for n in (n for n in counts if n > 1):
            same = same_counters(qc, fn, sigma, T, cards[:n], args.batch)
            print(f"{name}: {n} cards' counters equal to {n} slots on "
                  f"{cards[0]}: {same}", flush=True)
            ok &= same
        rates = measure_scaling_efficiency(
            qc.to_code(cards[0]), fn, snr, counts,
            batch_per_device=args.batch, max_iterations=T,
            repeats=args.repeats)
        for n, r in rates.items():
            eff = r / n / rates[counts[0]] * counts[0]
            rows.append(dict(decoder=name, cards=n, batch=args.batch,
                             bits_per_s=r, efficiency=eff))
            print(f"{name}: {n} cards {r:.6g} decoded info bits/s, "
                  f"efficiency {eff:.4f}", flush=True)
    print(json.dumps({"mesh_scaling": rows, "counters_equal": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
