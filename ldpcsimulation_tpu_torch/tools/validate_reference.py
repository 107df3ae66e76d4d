"""BER-curve validation against the compiled C reference.

Port of ``ldpcsimulation_tpu.tools.validate_reference``.  Builds the
reference decoders with ``g++`` from a read-only checkout of the C
reference, sweeps an SNR grid with both the reference binary and this
port's ``simulate`` on the SAME parity-check matrix, and prints a
side-by-side markdown table (to stdout, or to ``--out``).

    python -m ldpcsimulation_tpu_torch.tools.validate_reference \
        --reference /path/to/reference [--out validation.md]

Without the checkout it prints a note and returns 1.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from ..channel.awgn import llr_from_channel, snr_to_n0
from ..codes import build_code, load_alist
from ..decoders.bp import decode_bp
from ..decoders.minsum import decode_minsum
from ..harness import StopRule, simulate

__all__ = ["PEG_ALIST", "build_reference", "run_ref", "main"]

PEG_ALIST = "C_implementations/codes/PEGReg504x1008/PEGReg504x1008.alist"


def build_reference(ref_root: str, workdir: str) -> dict:
    """Compile ``decodeMinSum`` and ``decodeBP`` into ``workdir``; returns
    {name: binary path}."""
    src = os.path.join(ref_root, "C_implementations")
    objs = []
    for unit in ("nrutil", "r", "alist"):
        obj = os.path.join(workdir, f"{unit}.o")
        subprocess.run(
            ["g++", "-O2", f"-I{src}/inc", "-c", "-o", obj,
             f"{src}/src/{unit}.cpp"],
            check=True, capture_output=True,
        )
        objs.append(obj)
    bins = {}
    for name in ("decodeMinSum", "decodeBP"):
        out = os.path.join(workdir, name)
        subprocess.run(
            ["g++", "-O2", f"-I{src}/inc", "-o", out, *objs,
             f"{src}/src/{name}.cpp", "-lm"],
            check=True, capture_output=True,
        )
        bins[name] = out
    return bins


def run_ref(binary: str, alist: str, snr: float, iters: int,
            workdir: str, repeats: int = 3) -> float:
    """Mean BER of ``repeats`` runs of a reference binary (its own stopping
    rule and time seed): each appends a log row ``SNR\\tBER\\t...``."""
    log = os.path.join(workdir, "ref.log")
    bers = []
    for _ in range(repeats):
        subprocess.run(
            [binary, alist, "0.5", str(snr), str(iters), log],
            check=True, capture_output=True, timeout=1800,
        )
        with open(log) as f:
            row = f.read().strip().splitlines()[-1].split("\t")
        bers.append(float(row[1]))
        time.sleep(1.1)  # the reference seeds from the clock in seconds
    return float(np.mean(bers))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="validate_reference")
    p.add_argument("--reference", required=True,
                   help="root of a checkout of the C reference")
    p.add_argument("--out", default=None,
                   help="markdown output path (default: stdout)")
    p.add_argument("--frames", type=int, default=4096,
                   help="frames per point on our side")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU runs the "
                        "kernels' plain twins)")
    args = p.parse_args(argv)

    alist = os.path.join(args.reference, PEG_ALIST)
    if not os.path.exists(alist):
        print("reference checkout not found", file=sys.stderr)
        return 1
    code = build_code(load_alist(alist), args.device)
    lines = [
        "# BER validation vs the compiled C reference",
        "",
        "Code: PEGReg504x1008 (the reference's own alist).  Reference BERs",
        "average 3 time-seeded runs of its own stopping rule; framework BERs",
        f"use {args.frames} frames/point.  `ratio` = ours / reference.",
        "",
        "| decoder | Eb/N0 (dB) | reference BER | framework BER | ratio |",
        "|---|---|---|---|---|",
    ]
    batch = min(1024, args.frames)
    with tempfile.TemporaryDirectory() as wd:
        bins = build_reference(args.reference, wd)
        # min-sum T=10 sweep
        for snr in (1.8, 2.0, 2.2, 2.4):
            rb = run_ref(bins["decodeMinSum"], alist, snr, 10, wd)
            st = simulate(
                code, lambda y, key: decode_minsum(code, y, 10),
                snr_db=snr, rate=0.5,
                stop=StopRule.fixed_frames(args.frames), batch_size=batch,
                seed=1000 + int(snr * 10), device=args.device,
            )
            lines.append(
                f"| min-sum T=10 | {snr} | {rb:.4e} | {st.ber:.4e} "
                f"| {st.ber / rb:.2f} |"
            )
            print(lines[-1], file=sys.stderr)
        # BP T=20 sweep
        for snr in (1.4, 1.6, 1.8):
            rb = run_ref(bins["decodeBP"], alist, snr, 20, wd)
            n0 = snr_to_n0(snr, 0.5)
            st = simulate(
                code, lambda llr, key: decode_bp(code, llr, 20),
                snr_db=snr, rate=0.5,
                stop=StopRule.fixed_frames(args.frames), batch_size=batch,
                preprocess=lambda y: llr_from_channel(y, n0),
                seed=2000 + int(snr * 10), device=args.device,
            )
            lines.append(
                f"| BP T=20 | {snr} | {rb:.4e} | {st.ber:.4e} "
                f"| {st.ber / rb:.2f} |"
            )
            print(lines[-1], file=sys.stderr)
    out = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
