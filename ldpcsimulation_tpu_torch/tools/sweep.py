"""Sweep CLI — the min-sum route of ``ldpcsimulation_tpu.tools.sweep``.

One reference-format row per SNR point is appended to the log, with the
JAX CLI's columns (``SNR BER avgIters WER T code``) and the same
``<log>.done`` resume keys, so either CLI resumes the other's sweep.

Example (one H100):
    python -m ldpcsimulation_tpu_torch.tools.sweep minsum \\
        --code qc_1008_504 --snr 2.0 -T 10 --msg-dtype f16 \\
        --batch 32768 --log ms.log

Ported so far: plain min-sum on the named QC codes, flooding schedule.
The other decoders, schedules and drivers exit with an error naming their
ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from ..codes.library import NAMED_CODES, load_named_qc
from ..decoders.minsum_qc import decode_minsum_qc, qc_check_satisfied
from ..harness import (
    StopRule,
    append_row,
    default_min_word_errors,
    fmt,
    minsum_log_row,
    simulate,
)
from ..harness.fixtures import load_codeword_file

__all__ = ["main", "build_parser"]

#: decoders of the JAX CLI that are not ported yet -> their ROADMAP item
_NOT_PORTED = {
    "bp": "A8",
    "offsetminsum": "S4 (quantized min-sum routes)",
    "normalizedminsum": "S4 (quantized min-sum routes)",
    "gdbf": "A11",
    "ddbmp": "A11",
    "ngdbfhw": "A11",
    "nbqspa": "A12",
}
#: the JAX CLI keys a point by SNR and nine decoder parameters; min-sum
#: leaves those unset, and the port writes the same keys
_UNSET_PARAMS = (None,) * 9


def _grid_key(point) -> str:
    """Canonical resume key for one grid point (None -> '-')."""
    return "|".join("-" if v is None else fmt(v) for v in point)


def _mark_done(log: str, key: str) -> None:
    """Record a completed grid point in the '<log>.done' resume sidecar."""
    with open(log + ".done", "a") as f:
        f.write(key + "\n")


def _parse_snr(spec: str) -> List[float]:
    """"a:b:step" inclusive grid, or a single value, or comma list."""
    try:
        if ":" in spec:
            a, b, s = (float(x) for x in spec.split(":"))
            n = int(round((b - a) / s)) + 1
            if n < 1:
                raise SystemExit(
                    f"sweep: error: --snr range {spec!r} is empty "
                    "(end before start with a positive step?)"
                )
            return [round(a + i * s, 10) for i in range(n)]
        if "," in spec:
            return [float(x) for x in spec.split(",")]
        return [float(spec)]
    except ValueError:
        raise SystemExit(
            f"sweep: error: argument --snr: expected 'a:b:step', "
            f"'v1,v2,...' or a single dB value, got {spec!r}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("decoder", choices=["minsum", *sorted(_NOT_PORTED)])
    p.add_argument("--code", required=True, choices=sorted(NAMED_CODES),
                   help="named code (QC codes take the min-sum route)")
    p.add_argument("--schedule", choices=["flooding", "layered"],
                   default="flooding")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet (ROADMAP A13)")
    p.add_argument("--stream", action="store_true",
                   help="not ported yet (ROADMAP A10)")
    p.add_argument("--rate", type=float, help="code rate R (default k/n)")
    p.add_argument("--snr", required=True, help="Eb/N0 grid 'a:b:step' dB")
    p.add_argument("-T", "--iterations", type=int, required=True)
    p.add_argument("--log", required=True, help="append-only result log")
    p.add_argument("--codewords", help="data.enc-style codeword file")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--min-errors", type=int, default=200)
    p.add_argument("--min-word-errors", type=int, default=None)
    p.add_argument("--early-termination", action="store_true")
    p.add_argument(
        "--msg-dtype", choices=["f32", "f16"], default="f32",
        help="message STORAGE dtype (arithmetic stays f32)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; the CPU runs the "
                        "kernels' plain PyTorch twins)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument(
        "--resume", action="store_true",
        help="skip SNR points already recorded in the '<log>.done' "
             "sidecar (or, without one, in the log's SNR column)",
    )
    return p


def _refuse_unported(args) -> None:
    def no(what: str, item: str):
        raise SystemExit(
            f"sweep: error: {what} is not ported yet (ROADMAP {item})"
        )

    if args.decoder in _NOT_PORTED:
        no(f"decoder {args.decoder!r}", _NOT_PORTED[args.decoder])
    if args.schedule == "layered":
        no("--schedule layered", "A9")
    if args.stream:
        no("--stream", "A10")
    if args.distributed:
        no("--distributed", "A13")


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "sweep: error: --device cuda, but no CUDA device is available "
            "(pass --device cpu to run the plain PyTorch path)"
        )
    try:
        qc = load_named_qc(args.code)
    except KeyError:
        raise SystemExit(
            f"sweep: error: {args.code} has no QC structure; min-sum on "
            "slot-array codes is not ported yet (ROADMAP A7)"
        )
    code = qc.to_code(device)
    rate = args.rate if args.rate is not None else code.rate
    codewords = (
        load_codeword_file(args.codewords, n=code.n)
        if args.codewords
        else None
    )
    if codewords is not None:
        # Fail fast if the fixture rows are not codewords of this H.
        probe = torch.as_tensor(np.asarray(codewords[:4], np.int32))
        d = (1 - 2 * probe).t().to(device)  # bit -> ±1, [N, B]
        if not bool(qc_check_satisfied(qc, d).all()):
            raise SystemExit(
                f"sweep: error: {args.codewords}: rows are not codewords "
                f"of this H (column order mismatch?)"
            )
    snrs = _parse_snr(args.snr)
    T = args.iterations
    mwe = (
        args.min_word_errors
        if args.min_word_errors is not None
        else default_min_word_errors(code.n)
    )
    stop = StopRule(
        min_bit_errors=args.min_errors,
        min_word_errors=mwe,
        max_frames=args.max_frames,
    )
    sdt = torch.float16 if args.msg_dtype == "f16" else None

    def dec(y):
        return decode_minsum_qc(
            qc, y, T, early_termination=args.early_termination,
            storage_dtype=sdt,
        )

    # --resume: keys from the '<log>.done' sidecar; a log without one
    # resumes by its SNR column.
    done_keys = set()
    if args.resume:
        try:
            with open(args.log + ".done") as f:
                done_keys.update(line.rstrip("\n") for line in f)
        except FileNotFoundError:
            by_snr = {fmt(s): _grid_key((s,) + _UNSET_PARAMS) for s in snrs}
            try:
                with open(args.log) as f:
                    for line in f:
                        cols = line.split("\t")
                        if cols and cols[0] in by_snr:
                            done_keys.add(by_snr[cols[0]])
            except FileNotFoundError:
                pass

    for rows, snr in enumerate(snrs, 1):
        gkey = _grid_key((snr,) + _UNSET_PARAMS)
        if args.resume and gkey in done_keys:
            print(
                f"[{rows}/{len(snrs)}] SNR={snr} point already logged, "
                "skipping",
                file=sys.stderr,
            )
            continue
        stats = simulate(
            code, dec, snr_db=snr, rate=rate, stop=stop,
            batch_size=args.batch, seed=args.seed, codewords=codewords,
            device=device, verbose=args.verbose,
        )
        append_row(args.log, minsum_log_row(snr, stats, T, args.code))
        _mark_done(args.log, gkey)
        print(
            f"[{rows}/{len(snrs)}] SNR={snr} BER={stats.ber:.4g} "
            f"FER={stats.fer:.4g} frames={stats.total_words} "
            f"({stats.wall_seconds:.1f}s)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
