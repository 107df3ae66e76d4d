"""Sweep CLI — the min-sum, BP, DD-BMP, GDBF, NGDBFhw and non-binary
FFT-QSPA routes of ``ldpcsimulation_tpu.tools.sweep``.

The CLI runs the JAX CLI's cartesian grid (SNR × ymax × nq × alpha × delta
× theta × noise-scale × lam × w × theta0, each list defaulting to one unset
value) and appends one reference-format row per grid point to the log, with
the JAX CLI's columns and the same ``<log>.done`` resume keys, so either CLI
resumes the other's sweep.

Examples (one H100):
    python -m ldpcsimulation_tpu_torch.tools.sweep minsum \\
        --code qc_1008_504 --snr 2.0 -T 10 --msg-dtype f16 \\
        --batch 32768 --log ms.log
    python -m ldpcsimulation_tpu_torch.tools.sweep offsetminsum \\
        --code wifi_1944_972 --snr 1.5:2.5:0.5 -T 10 --ymax 2.0 --nq 8 \\
        --delta 0.15 --batch 32768 --log oms.log
    python -m ldpcsimulation_tpu_torch.tools.sweep minsum --alist H.alist \\
        --snr 2.0 -T 10 --batch 32768 --log h.log
    python -m ldpcsimulation_tpu_torch.tools.sweep gdbf --preset SMNGDBF \\
        --code qc_1008_504 --snr 3.0:3.5:0.25 -T 300 --theta -0.9 \\
        --noise-scale 0.975 --lam 0.988 --alpha 0.75 --window 64 \\
        --ymax 2.5 --batch 32768 --log smngdbf.log
    python -m ldpcsimulation_tpu_torch.tools.sweep bp --code qc_1008_504 \\
        --snr 2.0 -T 20 --early-termination --msg-dtype f16 \\
        --batch 32768 --log bp.log
    python -m ldpcsimulation_tpu_torch.tools.sweep minsum \\
        --code wifi_1944_972 --schedule layered --snr 1.5 -T 10 \\
        --batch 32768 --log layered.log
    python -m ldpcsimulation_tpu_torch.tools.sweep ddbmp \\
        --code reg4_4000_2000 --snr 3.9 -T 100 --ymax 1.6 --nq 8 \\
        --batch 32768 --log ddbmp.log
    python -m ldpcsimulation_tpu_torch.tools.sweep ngdbfhw \\
        --code highrate_2048_384 --snr 4.25 -T 600 --frames 65536 \\
        --batch 32768 --persistent-qpointer --log hw.log
    python -m ldpcsimulation_tpu_torch.tools.sweep bp --code qc_1008_504 \\
        --snr 2.0 -T 20 --early-termination --msg-dtype f16 --stream \\
        --batch 32768 --log bp_stream.log
    python -m ldpcsimulation_tpu_torch.tools.sweep ngdbfhw \\
        --code highrate_2048_384 --snr 4.25 -T 600 --frames 131072 \\
        --batch 32768 --stream --log hw_stream.log
    python -m ldpcsimulation_tpu_torch.tools.sweep nbqspa \\
        --nb-random 6000:4000:3:8 --snr 1.3 -T 20 --early-termination \\
        --msg-dtype f16 --batch 512 --log nb.log

Ported so far: the min-sum family (plain, offset and normalized, the
fixed-point variants on ``quantize_no_zero`` samples), sum-product BP (on
``llr_from_channel`` LLRs), both in the flooding and, on QC codes, the
row-layered schedule (``--schedule layered``; ``--msg-dtype f16`` reaches
flooding BP and layered min-sum, not layered BP), DD-BMP (on
``quantize_no_zero`` samples, Ymax 1.5 and 8 levels unless given), the
GDBF/NGDBF presets and the fixed-point NGDBFhw (a fixed ``--frames`` count,
the 802.3an defaults unless given, with its ``<log>_<snr>_itdist.dat``
completion file), on every named code and on ``--alist`` files.  QC codes
(named, or detected in an alist in natural order) take the QC decoders and
the QC graph operations.  Another binary alist takes, for flooding BP, the
stratified decoder (``codes/stratified.py``) where ``detect_stratified``
finds a structure ("sweep: detected stratified structure ..." on stderr),
as the JAX CLI does: its check update folds in column-group order, so its
rows are the JAX route's.  Min-sum and DD-BMP keep the slot-array decoders
there, where the JAX CLI takes its stratified ones: those give the same
rows bit for bit and run faster on the card (PERF.md).  The rest take the
slot-array decoders.  ``nbqspa`` runs
FFT-QSPA (``harness/montecarlo_nb.py``) on a non-binary alist or a
``--nb-random N:M:DV:Q`` code, with ``--msg-dtype f16`` message storage and
the log row ``SNR SER BER avgIters FER T code``.  ``--stream`` runs the
streaming refill harness (``harness/stream.py``, ``stream_gdbf.py``,
``stream_ngdbfhw.py``; lanes = ``--batch``) for min-sum and BP (with
``--early-termination``), the layered schedules, DD-BMP (QC codes), the
GDBF presets, NGDBFhw (refill every 16 steps) and ``nbqspa`` (refill every
iteration), with the JAX CLI's refusals.  ``--distributed`` runs the whole
operating-point grid on the slot mesh of ``parallel/`` (one slot per CUDA
device of every rank by default, one per rank with ``--device cpu``; under
torchrun the ranks join one process group, and without torchrun a host
with several cards starts one rank per card itself): the routes, rows,
resume keys and refusals of the JAX CLI's ``_run_distributed``.  As in
the JAX CLI, ``gdbf`` and ``ngdbfhw`` on a code without QC structure take
the dense graph operations (``decoders/dense_ops.py``) on every route
wherever ``dense_worthwhile`` holds.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..channel import (
    llr_from_channel,
    quantize_no_zero,
    quantize_round,
    saturate,
    snr_to_n0,
    snr_to_sigma,
)
from ..codes.alist import load_alist
from ..codes.code import build_code
from ..codes.construct import nb_regular
from ..codes.library import NAMED_CODES, load_named_code, load_named_qc
from ..codes.qc_detect import detect_qc
from ..codes.stratified import detect_stratified
from ..decoders.base import syndrome_from_hard
from ..decoders.bp import decode_bp
from ..decoders.bp_layered import decode_bp_layered_qc
from ..decoders.bp_qc import decode_bp_qc
from ..decoders.bp_stratified import decode_bp_stratified
from ..decoders.ddbmp import decode_ddbmp, decode_ddbmp_qc
from ..decoders.dense_ops import (
    DenseGraph,
    dense_worthwhile,
    graphs_by_device,
)
from ..decoders.gdbf import PRESETS, decode_gdbf, preset
from ..decoders.minsum import decode_minsum
from ..decoders.minsum_layered import decode_minsum_layered_qc
from ..decoders.minsum_qc import decode_minsum_qc, qc_check_satisfied
from ..decoders.ngdbf_hw import NGDBFHwConfig, decode_ngdbf_hw
from ..harness import (
    StopRule,
    append_row,
    bp_log_row,
    default_min_word_errors,
    fmt,
    gdbf_log_row,
    minsum_log_row,
    ngdbfhw_log_row,
    simulate,
)
from ..harness.fixtures import load_codeword_file
from ..harness.stream import (
    bp_layered_qc_stream,
    bp_qc_stream,
    bp_stratified_stream,
    bp_stream,
    ddbmp_qc_stream,
    minsum_layered_qc_stream,
    minsum_qc_stream,
    minsum_stream,
    simulate_stream,
)
from ..harness.montecarlo_nb import simulate_nb
from ..harness.stream import simulate_stream_nb
from ..harness.stream_gdbf import simulate_stream_gdbf
from ..harness.stream_ngdbfhw import simulate_stream_ngdbfhw
from ..kernels.bp import CAP_LANES
from ..parallel.mesh import init_distributed, make_mesh, spawn_ranks, world
from ..parallel.montecarlo import simulate_grid
from ..parallel.montecarlo_nb import simulate_nb_distributed

__all__ = ["main", "build_parser"]

#: min-sum decoders -> their variant
_MINSUM = {"minsum": "plain", "offsetminsum": "offset",
           "normalizedminsum": "normalized"}
#: decoders whose stream always stops early (no --early-termination needed)
_ALWAYS_EARLY = ("gdbf", "nbqspa", "ddbmp", "ngdbfhw")
#: the grid's axes, in the order of its points and resume keys
_GRID_FIELDS = ("snr", "ymax", "nq", "alpha", "delta", "theta",
                "noise_scale", "lam", "w", "theta0")


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
    p.add_argument("decoder",
                   choices=[*_MINSUM, "bp", "ddbmp", "gdbf", "ngdbfhw",
                            "nbqspa"])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--code", choices=sorted(NAMED_CODES), help="named code")
    src.add_argument("--alist", help="path to an alist file (binary or NB)")
    src.add_argument("--nb-random", metavar="N:M:DV:Q",
                     help="random GF(Q) regular code, e.g. 96:48:3:64")
    p.add_argument("--schedule", choices=["flooding", "layered"],
                   default="flooding")
    p.add_argument(
        "--distributed", action="store_true",
        help="run the full operating-point grid on the slot mesh "
             "(parallel/): each slot one grid point per round, per-point "
             "stopping; --batch is the batch per slot",
    )
    p.add_argument(
        "--stream", action="store_true",
        help="min-sum/BP (with --early-termination; QC, stratified (BP), "
             "slot-array, or "
             "--schedule layered QC codes), ddbmp (QC codes), gdbf, "
             "ngdbfhw, nbqspa: run "
             "the streaming refill harness (persistent lanes refilled from "
             "a keyed channel pool) instead of the batched loop — the same "
             "per-frame results, no straggler tax.  All-zero codewords; "
             "lanes = --batch.",
    )
    p.add_argument(
        "--pool-bytes", type=int, default=None,
        help="--stream channel-pool byte budget (default 1 GiB): the "
             "rounds per call shrink so the pool fits it "
             "(harness.stream.pool_policy)",
    )
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
    # grid parameters (each list is one axis of the grid)
    p.add_argument("--ymax", type=float, nargs="+", default=[None],
                   help="saturation/quantizer range ±Ymax")
    p.add_argument("--nq", type=float, nargs="+", default=[None],
                   help="quantizer levels (min-sum) or bits (gdbf)")
    p.add_argument("--alpha", type=float, nargs="+", default=[None])
    p.add_argument("--delta", type=float, nargs="+", default=[None])
    p.add_argument("--theta", type=float, nargs="+", default=[None])
    p.add_argument("--noise-scale", type=float, nargs="+", default=[None])
    p.add_argument("--lam", type=float, nargs="+", default=[None])
    # ngdbfhw
    p.add_argument("--w", type=float, nargs="+", default=[None],
                   help="ngdbfhw channel scale w (default 0.185)")
    p.add_argument("--theta0", type=float, nargs="+", default=[None],
                   help="ngdbfhw noise offset theta0 (default -0.525)")
    p.add_argument("--frames", type=int, default=10000,
                   help="fixed frame count for ngdbfhw")
    p.add_argument(
        "--persistent-qpointer", action="store_true",
        help="ngdbfhw: carry the noise-ring pointer across frames, per "
             "batch lane (the reference's pointer outlives a frame)",
    )
    p.add_argument(
        "--itdist-biased", action="store_true",
        help="ngdbfhw: write the *_itdist.dat completion CDF with the "
             "reference's own running-mean estimator, bias included "
             "(default: the unbiased complement CDF)",
    )
    # gdbf family
    p.add_argument("--preset", choices=sorted(PRESETS), default="SMNGDBF")
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--max-phases", type=int, default=None)
    p.add_argument("--uniform-noise", action="store_true",
                   help="variance-matched uniform perturbation noise")
    p.add_argument(
        "--resume", action="store_true",
        help="skip grid points already recorded in the '<log>.done' "
             "sidecar (or, without one, in the log's SNR column for an "
             "SNR-only grid)",
    )
    return p


def _refuse_stream(args, codewords) -> None:
    """The JAX CLI's refusals of ``--stream`` combinations."""
    if not args.stream:
        return
    if args.decoder == "ngdbfhw" and args.persistent_qpointer:
        raise SystemExit(
            "sweep: error: --stream ngdbfhw already chains ring offsets per "
            "frame (injection-time qpointer0); --persistent-qpointer is the "
            "batched-lane semantic"
        )
    if args.decoder not in _ALWAYS_EARLY and not args.early_termination:
        raise SystemExit(
            "sweep: error: --stream requires --early-termination "
            "(fixed-trip decodes have no straggler tax to remove)"
        )
    if codewords is not None:
        raise SystemExit(
            "sweep: error: --stream simulates all-zero codewords"
        )
    if args.distributed:
        raise SystemExit(
            "sweep: error: --stream runs on one device in the CLI; "
            "--distributed is the batched operating-point grid "
            "engine (the library API shards a stream over a mesh: "
            "simulate_stream(mesh=...))"
        )
    if args.schedule == "layered" and args.decoder not in (*_MINSUM, "bp"):
        raise SystemExit(
            "sweep: error: --schedule layered streams min-sum variants and "
            "BP only"
        )


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "sweep: error: --device cuda, but no CUDA device is available "
            "(pass --device cpu to run the plain PyTorch path)"
        )
    code, qc, strat, alist_name = _load_code(args, device)
    if (args.schedule == "layered" and qc is None and not args.distributed
            and args.decoder in (*_MINSUM, "bp")):
        raise SystemExit(
            "sweep: error: --schedule layered requires a "
            "QC-structured --code"
        )
    rate = args.rate if args.rate is not None else code.rate
    codewords = (
        load_codeword_file(args.codewords, n=code.n)
        if args.codewords
        else None
    )
    _refuse_stream(args, codewords)
    if codewords is not None and code.q <= 2:
        # Fail fast if the fixture rows are not codewords of this H.
        probe = torch.as_tensor(np.asarray(codewords[:4], np.int32))
        d = (1 - 2 * probe).t().to(device)  # bit -> ±1, [N, B]
        ok = (qc_check_satisfied(qc, d) if qc is not None
              else (syndrome_from_hard(code, d) > 0).all(dim=0))
        if not bool(ok.all()):
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

    # the bit-flip decoders on a code without QC structure take the dense
    # graph operations where H is small enough (the JAX CLI's rule)
    dense = None
    if (qc is None and args.decoder in ("gdbf", "ngdbfhw")
            and dense_worthwhile(code)):
        dense = DenseGraph.from_code(code, device)

    if args.distributed:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        if cards > 1 and "WORLD_SIZE" not in os.environ:
            return spawn_ranks(
                [sys.executable, "-m", "ldpcsimulation_tpu_torch.tools.sweep",
                 *(sys.argv[1:] if argv is None else argv)], cards)
        return _run_distributed(args, code, qc, dense, alist_name, snrs,
                                rate, stop, T, codewords, device)

    def run_point(snr, decode_fn, preprocess=None, stop_override=None,
                  carry0=None):
        return simulate(
            code, decode_fn, snr_db=snr, rate=rate,
            stop=stop_override or stop, batch_size=args.batch,
            seed=args.seed, preprocess=preprocess, codewords=codewords,
            device=device, verbose=args.verbose, decode_carry0=carry0,
        )

    def run_stream_point(snr, sdec, preprocess=None):
        return simulate_stream(
            code.n, sdec, snr, rate, T, stop=stop, lanes=args.batch,
            refill_every=2, seed=args.seed, preprocess=preprocess,
            pool_bytes=args.pool_bytes, verbose=args.verbose, device=device,
        )

    grid = list(itertools.product(
        snrs, args.ymax, args.nq, args.alpha, args.delta, args.theta,
        args.noise_scale, args.lam, args.w, args.theta0,
    ))
    # --resume: keys from the '<log>.done' sidecar; a log without one
    # resumes by its SNR column, for an SNR-only grid only (a wider grid
    # would drop unexplored parameter points at a logged SNR).
    done_keys = set()
    if args.resume:
        try:
            with open(args.log + ".done") as f:
                done_keys.update(line.rstrip("\n") for line in f)
        except FileNotFoundError:
            if len({point[1:] for point in grid}) == 1:
                by_snr = {fmt(point[0]): _grid_key(point) for point in grid}
                try:
                    with open(args.log) as f:
                        for line in f:
                            cols = line.split("\t")
                            if cols and cols[0] in by_snr:
                                done_keys.add(by_snr[cols[0]])
                except FileNotFoundError:
                    pass
            else:
                print(
                    "sweep: --resume found no sidecar "
                    f"{args.log}.done; multi-parameter grid will re-run "
                    "all points",
                    file=sys.stderr,
                )

    for rows, point in enumerate(grid, 1):
        (snr, ymax, nq, alpha, delta, theta, nscale, lam, _w, _theta0) = point
        gkey = _grid_key(point)
        if args.resume and gkey in done_keys:
            print(
                f"[{rows}/{len(grid)}] SNR={snr} point already logged, "
                "skipping",
                file=sys.stderr,
            )
            continue
        if args.decoder in _MINSUM:
            stats, row = _minsum_point(args, code, qc, alist_name, run_point,
                                       run_stream_point, T, point)
        elif args.decoder == "bp":
            stats, row = _bp_point(args, code, qc, strat, alist_name, rate,
                                   run_point, run_stream_point, T, point)
        elif args.decoder == "ddbmp":
            stats, row = _ddbmp_point(args, code, qc, alist_name, run_point,
                                      run_stream_point, T, point)
        elif args.decoder == "ngdbfhw":
            stats, row = _ngdbfhw_point(args, code, qc, dense, rate,
                                        run_point, T, point, device)
        elif args.decoder == "nbqspa":
            stats, row = _nbqspa_point(args, code, alist_name, rate, T, snr,
                                       stop, device)
        else:
            stats, row = _gdbf_point(args, code, qc, dense, alist_name, rate,
                                     run_point, T, point, stop, device)
        append_row(args.log, row)
        _mark_done(args.log, gkey)
        rates = (f"SER={stats.ser:.4g} BER={stats.ber:.4g}"
                 if args.decoder == "nbqspa"
                 else f"BER={stats.ber:.4g} FER={stats.fer:.4g}")
        print(
            f"[{rows}/{len(grid)}] SNR={snr} {rates} "
            f"frames={stats.total_words} ({stats.wall_seconds:.1f}s)",
            file=sys.stderr,
        )
    return 0


def _load_code(args, device):
    """(code, QC structure or None, stratified structure or None, the log
    rows' code name) of --code, --alist or --nb-random.  A named code takes
    its registered QC structure; a binary alist whose H is QC in natural
    order (rows and columns unpermuted) takes the detected one; any other
    binary alist takes, for flooding BP, the stratified structure where
    ``detect_stratified`` finds one with at most 64 column groups (kernel
    B8's widest table), as the JAX CLI routes BP; past 64 groups BP stays
    on the slot arrays, whose rows B8 takes.  Min-sum and DD-BMP never look
    for one (the slot arrays give their rows bit for bit, faster), nor does
    a decoder under --schedule layered."""
    if args.code:
        try:
            qc = load_named_qc(args.code)
        except KeyError:
            return load_named_code(args.code, device), None, None, args.code
        return qc.to_code(device), qc, None, args.code
    if args.nb_random:
        n, m, dv, q = (int(x) for x in args.nb_random.split(":"))
        code = build_code(nb_regular(n, m, dv, q=q, seed=args.seed), device)
        return code, None, None, f"nb_random_{args.nb_random}"
    alist = load_alist(args.alist)
    code = build_code(alist, device)
    if alist.q > 2:
        return code, None, None, args.alist
    det = detect_qc(alist)
    if (det is not None and (det.col_perm == np.arange(code.n)).all()
            and (det.row_perm == np.arange(code.m)).all()):
        print(
            f"sweep: detected QC structure z={det.qc.z} "
            f"({det.qc.mb}x{det.qc.nb} base) — using roll decoders",
            file=sys.stderr,
        )
        return code, det.qc, None, args.alist
    strat = None
    if args.decoder == "bp" and args.schedule != "layered":
        strat = detect_stratified(alist)
        if strat is not None and strat.kg > max(CAP_LANES):
            print(
                f"sweep: stratified structure ({strat.mb}x{strat.h} strata, "
                f"{strat.kg} column groups) wider than kernel B8's "
                f"{max(CAP_LANES)} slots — using the slot-array BP decoder",
                file=sys.stderr,
            )
            strat = None
        elif strat is not None:
            print(
                f"sweep: detected stratified structure ({strat.mb}x"
                f"{strat.h} strata, {strat.kg} column groups) — using "
                "the stratified BP decoder",
                file=sys.stderr,
            )
    return code, None, strat, args.alist


def _minsum_point(args, code, qc, alist_name, run_point, run_stream_point,
                  T, point):
    """One grid point of a min-sum route: the fixed-point variants decode
    ``quantize_no_zero`` samples (Ymax 2.0 and 8 levels unless given), and
    their rows carry Ymax and alpha or delta, as the JAX CLI's do.  With
    ``--stream``, the stream adapter of the same decoder."""
    (snr, ymax, nq, alpha, delta, *_rest) = point
    variant = _MINSUM[args.decoder]
    pre = None
    if variant != "plain":
        ym = ymax if ymax is not None else 2.0
        nql = nq if nq is not None else 8.0
        pre = lambda y: quantize_no_zero(y, ym, nql)  # noqa: E731
    kw = dict(
        variant=variant,
        alpha=alpha if alpha is not None else 1.0,
        delta=delta if delta is not None else 0.0,
        early_termination=args.early_termination,
        storage_dtype=torch.float16 if args.msg_dtype == "f16" else None,
    )
    if args.stream:
        skw = {k: v for k, v in kw.items() if k != "early_termination"}
        if args.schedule == "layered":
            sdec = minsum_layered_qc_stream(qc, **skw)
        elif qc is not None:
            sdec = minsum_qc_stream(qc, **skw)
        else:
            sdec = minsum_stream(code, **skw)
        stats = run_stream_point(snr, sdec, preprocess=pre)
    else:
        if args.schedule == "layered":
            dec = lambda y, key: decode_minsum_layered_qc(  # noqa: E731
                qc, y, T, **kw)
        elif qc is not None:
            dec = lambda y, key: decode_minsum_qc(  # noqa: E731
                qc, y, T, **kw)
        else:
            dec = lambda y, key: decode_minsum(  # noqa: E731
                code, y, T, **kw)
        stats = run_point(snr, dec, preprocess=pre)
    row = minsum_log_row(
        snr, stats, T, alist_name,
        ymax=ymax if variant != "plain" else None,
        alpha=alpha if variant == "normalized" else None,
        delta=delta if variant == "offset" else None,
    )
    return stats, row


def _bp_point(args, code, qc, strat, alist_name, rate, run_point,
              run_stream_point, T, point):
    """One grid point of the BP route: LLRs ``llr_from_channel(y, N0)``,
    the layered decoder under ``--schedule layered`` (no storage type
    there), else the QC, the stratified or the slot-array flooding decoder;
    with ``--stream``, its stream adapter."""
    snr = point[0]
    n0 = float(snr_to_n0(snr, rate))
    et = args.early_termination
    sdt = torch.float16 if args.msg_dtype == "f16" else None
    if args.stream:
        if args.schedule == "layered":
            sdec = bp_layered_qc_stream(qc)
        elif qc is not None:
            sdec = bp_qc_stream(qc, storage_dtype=sdt)
        elif strat is not None:
            sdec = bp_stratified_stream(strat, storage_dtype=sdt)
        else:
            sdec = bp_stream(code, storage_dtype=sdt)
        stats = run_stream_point(
            snr, sdec, preprocess=lambda y: llr_from_channel(y, n0))
        return stats, bp_log_row(snr, stats, T, alist_name)
    if args.schedule == "layered":
        dec = lambda llr, key: decode_bp_layered_qc(  # noqa: E731
            qc, llr, T, early_termination=et)
    elif qc is not None:
        dec = lambda llr, key: decode_bp_qc(  # noqa: E731
            qc, llr, T, early_termination=et, storage_dtype=sdt)
    elif strat is not None:
        dec = lambda llr, key: decode_bp_stratified(  # noqa: E731
            strat, llr, T, early_termination=et, storage_dtype=sdt)
    else:
        dec = lambda llr, key: decode_bp(  # noqa: E731
            code, llr, T, early_termination=et, storage_dtype=sdt)
    stats = run_point(snr, dec,
                      preprocess=lambda y: llr_from_channel(y, n0))
    return stats, bp_log_row(snr, stats, T, alist_name)


def _ddbmp_point(args, code, qc, alist_name, run_point, run_stream_point, T,
                 point):
    """One grid point of the DD-BMP route: ``quantize_no_zero`` samples
    (Ymax 1.5 and 8 levels unless given); the row carries Ymax.  With
    ``--stream``, the QC stream adapter (QC codes only, as in the JAX
    CLI)."""
    (snr, ymax, nq, *_rest) = point
    ym = ymax if ymax is not None else 1.5
    nql = nq if nq is not None else 8.0
    if args.stream:
        if qc is None:
            raise SystemExit(
                "sweep: error: --stream ddbmp requires a QC code")
        stats = run_stream_point(
            snr, ddbmp_qc_stream(qc),
            preprocess=lambda y: quantize_no_zero(y, ym, nql))
        return stats, minsum_log_row(snr, stats, T, alist_name, ymax=ym)
    if qc is not None:
        dec = lambda yq, key: decode_ddbmp_qc(qc, yq, T)  # noqa: E731
    else:
        dec = lambda yq, key: decode_ddbmp(code, yq, T)  # noqa: E731
    stats = run_point(snr, dec,
                      preprocess=lambda y: quantize_no_zero(y, ym, nql))
    return stats, minsum_log_row(snr, stats, T, alist_name, ymax=ym)


def _gdbf_point(args, code, qc, dense, alist_name, rate, run_point, T, point,
                stop, device):
    """One grid point of the GDBF route: the JAX CLI's defaults (theta
    −0.9, quantizer Ymax 2.25 when only --nq is given), preprocessing
    (saturate, then quantize) and row fields."""
    (snr, ymax, nq, alpha, _delta, theta, nscale, lam, _w, _theta0) = point
    cfg = preset(
        args.preset,
        num_iterations=T,
        theta=theta if theta is not None else -0.9,
        **{
            k: v
            for k, v in dict(
                noise_scale=nscale,
                lam=lam,
                alpha=alpha,
                window_size=args.window,
                max_phases=args.max_phases,
                uniform_noise=args.uniform_noise or None,
            ).items()
            if v is not None
        },
    )

    def pre(y):
        out = y
        if ymax is not None:
            out = saturate(out, ymax)
        if nq is not None:
            out = quantize_round(out, ymax or 2.25, int(nq))
        return out

    sigma = snr_to_sigma(snr, rate)
    if args.stream:
        stats = simulate_stream_gdbf(
            code, cfg, snr, rate=rate, stop=stop, lanes=args.batch,
            # a boundary costs a syndrome and a refill pass: at the
            # family's large caps a coarse cadence pays
            refill_every=8 if T >= 64 else 2, seed=args.seed,
            preprocess=pre, qc=qc, dense=dense, pool_bytes=args.pool_bytes,
            verbose=args.verbose, device=device,
        )
    else:
        stats = run_point(
            snr,
            lambda yq, key: decode_gdbf(code, yq, sigma, cfg, key=key,
                                        qc=qc, dense=dense),
            preprocess=pre,
        )
    row = gdbf_log_row(
        snr, stats, T, cfg.theta, alist_name,
        noise_scale=(cfg.noise_scale
                     if cfg.add_noise or cfg.quantize_probabilities
                     else None),
        nq=int(nq) if nq is not None else None,
        lam=cfg.lam if cfg.threshold_adaptation else None,
        alpha=cfg.alpha if cfg.weight_syndromes else None,
        smoothing_used=(int(stats.extra.get("smoothing_used", 0))
                        if cfg.output_smoothing else None),
        window_size=cfg.window_size if cfg.output_smoothing else None,
        ymax=ymax,
    )
    return stats, row


def _ngdbfhw_point(args, code, qc, dense, rate, run_point, T, point,
                   device):
    """One grid point of the NGDBFhw route: ``--frames`` frames, the
    802.3an defaults where a flag is absent, ``ring_len = max(2648, n +
    600)``, the ring pointer carried across frames with
    ``--persistent-qpointer``, or streamed (refill every 16 steps) with
    ``--stream``; writes the iteration-completion CDF beside the log, the
    swept parameters in its name, as the JAX CLI does."""
    (snr, ymax, _nq, _alpha, _delta, _theta, nscale, _lam, w, theta0) = point
    cfg = NGDBFHwConfig(
        num_iterations=T,
        w=w if w is not None else 0.185,
        ymax=ymax if ymax is not None else 1.625,
        noise_scale=nscale if nscale is not None else 0.95,
        theta0=theta0 if theta0 is not None else -0.525,
        max_phases=args.max_phases or 1,
        ring_len=max(2648, code.n + 600),
    )
    sigma = snr_to_sigma(snr, rate)
    frames = StopRule.fixed_frames(args.frames)
    if args.stream:
        stats = simulate_stream_ngdbfhw(
            code, cfg, snr, rate=rate, stop=frames, lanes=args.batch,
            pool_bytes=args.pool_bytes, refill_every=16, seed=args.seed,
            qc=qc, dense=dense, verbose=args.verbose, device=device)
    elif args.persistent_qpointer:
        def dec(y, key, carry):
            res = decode_ngdbf_hw(code, y, sigma, cfg, key=key, qc=qc,
                                  dense=dense, qpointer0=carry)
            return res, res.qpointer

        stats = run_point(snr, dec, stop_override=frames,
                          carry0=torch.zeros((args.batch,),
                                             dtype=torch.int32,
                                             device=device))
    else:
        stats = run_point(
            snr,
            lambda y, key: decode_ngdbf_hw(code, y, sigma, cfg, key=key,
                                           qc=qc, dense=dense),
            stop_override=frames,
        )
    row = ngdbfhw_log_row(
        snr, stats, T, cfg.theta0, cfg.noise_scale, cfg.w, cfg.ymax,
        cfg.nq, cfg.max_phases, args.seed,
    )
    suffix = "".join(
        f"_{name}{val:g}"
        for name, val in (("theta0", cfg.theta0), ("w", cfg.w),
                          ("noise_scale", cfg.noise_scale),
                          ("ymax", cfg.ymax))
        if len(getattr(args, name)) > 1
    )
    cdf = (stats.iteration_cdf_biased() if args.itdist_biased
           else stats.iteration_cdf())
    with open(f"{args.log}_{snr:g}{suffix}_itdist.dat", "w") as f:
        for idx, v in enumerate(cdf):
            f.write(f"{idx}\t{v:.6g}\n")
    return stats, row


def _nbqspa_point(args, code, alist_name, rate, T, snr, stop, device):
    """One grid point of the NB route: ``simulate_nb`` (or, with
    ``--stream``, ``simulate_stream_nb`` refilling every iteration) with
    ``--msg-dtype`` message storage; the JAX CLI's row ``SNR SER BER
    avgIters FER T code``."""
    sdt = torch.float16 if args.msg_dtype == "f16" else None
    if args.stream:
        stats = simulate_stream_nb(
            code, snr, T, rate=rate, stop=stop, lanes=args.batch,
            refill_every=1, pool_bytes=args.pool_bytes, seed=args.seed,
            storage_dtype=sdt, verbose=args.verbose, device=device)
    else:
        stats = simulate_nb(
            code, snr, T, rate=rate, stop=stop, batch_size=args.batch,
            seed=args.seed, early_termination=args.early_termination,
            storage_dtype=sdt, device=device)
    row = "\t".join(fmt(v) for v in (
        snr, stats.ser, stats.ber, stats.avg_iterations, stats.fer, T))
    return stats, f"{row}\t{alist_name}"


def _run_distributed(args, code, qc, dense, alist_name, snrs, rate, stop,
                     T, codewords, device):
    """``--distributed``: the full operating-point grid on the slot mesh.

    Every slot of the default mesh is an operating-point slot;
    :func:`..parallel.montecarlo.simulate_grid` cycles the unfinished
    points over them (any grid on any slot count) with per-point stopping,
    and each point's scalars reach its decode as f32-rounded floats.  The
    routes, rows, stderr lines, resume keys and refusals are the JAX
    CLI's: flooding BP and min-sum on the slot-array decoders (a
    stratified alist too, as in the JAX CLI), the layered
    ones on QC codes; ``gdbf`` (no --nq axis) and ``ngdbfhw`` (a fixed
    ``--frames`` count, no pointer carry, its itdist files) on the row
    gathers, or the dense products where :func:`main` built ``dense``;
    ``nbqspa`` on an SNR-only grid that divides the slot count.
    The default mesh is one slot per CUDA device of every rank, or, with
    ``--device cpu``, one per rank; under torchrun (``WORLD_SIZE`` set)
    the ranks join one process group first, and rank 0 writes the log
    (:func:`main` starts one rank per card with
    :func:`..parallel.mesh.spawn_ranks` when a host with several cards
    runs the CLI without torchrun).
    """
    if args.schedule == "layered" and (
        qc is None or args.decoder not in ("bp", *_MINSUM)
    ):
        raise SystemExit(
            "sweep: error: --schedule layered with --distributed needs a "
            "QC-structured --code and a bp/min-sum decoder"
        )
    # the full cartesian grid in the single-device route's field order
    # (the same --resume keys)
    grid = list(itertools.product(
        snrs, *(getattr(args, nm) for nm in _GRID_FIELDS[1:])))
    if args.resume:
        done = set()
        try:
            with open(args.log + ".done") as f:
                done.update(line.rstrip("\n") for line in f)
        except FileNotFoundError:
            pass
        grid = [pt for pt in grid if _grid_key(pt) not in done]
        if not grid:
            print("sweep: all points already done", file=sys.stderr)
            return 0

    # under torchrun the ranks join one group for this run, and leave it
    joined = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if joined:
        init_distributed(devices=[device] if device.type == "cpu" else None)
    try:
        return _run_grid(args, code, qc, dense, alist_name, snrs, rate,
                         stop, T, codewords, device, grid)
    finally:
        if joined:
            dist.destroy_process_group()


def _run_grid(args, code, qc, dense, alist_name, snrs, rate, stop, T,
              codewords, device, grid):
    """The routes of ``--distributed`` over the points of ``grid``; rank 0
    writes the rows."""
    cpu = device.type == "cpu"
    rank, size = world()
    writer = rank == 0

    def mesh_of(n_snr):
        return make_mesh(n_snr, [device] * size if cpu else None)

    nd = mesh_of(1).size
    sdt = torch.float16 if args.msg_dtype == "f16" else None
    codes = {device: code}

    def code_at(y):
        """The code's tables on the slot's device (copied once)."""
        if y.device not in codes:
            codes[y.device] = code.to(y.device)
        return codes[y.device]

    dense_on = graphs_by_device(dense, code)  # H on each slot's device

    if args.decoder == "nbqspa":
        # the NB path: an SNR-only grid through its own driver
        if nd % len(snrs):
            raise SystemExit(
                f"sweep: error: --distributed nbqspa needs "
                f"len(snrs)={len(snrs)} to divide the device count ({nd})"
            )
        nb_stats = simulate_nb_distributed(
            code, snrs, mesh_of(len(snrs)), T, rate=rate, stop=stop,
            batch_per_device=args.batch, seed=args.seed,
            early_termination=args.early_termination, storage_dtype=sdt,
        )
        for snr, st in zip(snrs, nb_stats):
            row = "\t".join(
                fmt(v)
                for v in (snr, st.ser, st.ber, st.avg_iterations, st.fer, T)
            ) + f"\t{alist_name}"
            if writer:
                append_row(args.log, row)
                print(f"SNR={snr} SER={st.ser:.4g} BER={st.ber:.4g} "
                      f"frames={st.total_words}", file=sys.stderr)
        return 0

    # per decoder: the grid fields that become per-point scalars (with
    # their defaults), the decode/preprocess closures over the point dict
    # and the row builder.  A multi-valued parameter the decoder cannot
    # take per point is a configuration error.
    multi = {nm: getattr(args, nm) for nm in _GRID_FIELDS[1:]
             if len(getattr(args, nm)) > 1}

    def _reject_unsweepable(sweepable):
        bad = sorted(set(multi) - set(sweepable))
        if bad:
            raise SystemExit(
                f"sweep: error: --distributed {args.decoder} cannot sweep "
                f"{', '.join('--' + b.replace('_', '-') for b in bad)} "
                "per-point (not an operating-point scalar of this decoder)"
            )

    max_it = T
    defaults = {}
    preprocess = None
    et = args.early_termination
    if args.decoder == "bp":
        _reject_unsweepable(())
        param_names = ()

        def dec(y, sigma, key, point):
            llr = llr_from_channel(y, 2.0 * sigma * sigma)
            if args.schedule == "layered":
                return decode_bp_layered_qc(qc, llr, T, early_termination=et)
            return decode_bp(code_at(y), llr, T, early_termination=et,
                             storage_dtype=sdt)

        def row_fn(snr, st, pt):
            return bp_log_row(snr, st, T, alist_name)

    elif args.decoder in _MINSUM:
        variant = _MINSUM[args.decoder]

        def _ms_decode(y, alpha, delta):
            kw = dict(variant=variant, alpha=alpha, delta=delta,
                      early_termination=et, storage_dtype=sdt)
            if args.schedule == "layered":
                return decode_minsum_layered_qc(qc, y, T, **kw)
            return decode_minsum(code_at(y), y, T, **kw)

        if variant == "plain":
            _reject_unsweepable(())
            param_names = ()

            def dec(y, sigma, key, point):
                return _ms_decode(y, 1.0, 0.0)
        else:
            param_names = ("ymax", "nq", "alpha", "delta")
            _reject_unsweepable(param_names)

            def preprocess(y, point):
                return quantize_no_zero(y, point["ymax"], point["nq"])

            def dec(y, sigma, key, point):
                return _ms_decode(y, point["alpha"], point["delta"])

        defaults = dict(ymax=2.0, nq=8.0, alpha=1.0, delta=0.0)

        def row_fn(snr, st, pt):
            return minsum_log_row(
                snr, st, T, alist_name,
                ymax=pt["ymax"] if variant != "plain" else None,
                alpha=pt["alpha"] if variant == "normalized" else None,
                delta=pt["delta"] if variant == "offset" else None,
            )

    elif args.decoder == "gdbf":
        param_names = ("theta", "noise_scale", "lam", "alpha")
        sat_on = args.ymax[0] is not None
        if sat_on:
            param_names = param_names + ("ymax",)
        _reject_unsweepable(param_names)
        if len(args.nq) > 1:
            raise SystemExit(
                "sweep: error: --distributed gdbf cannot sweep --nq "
                "(quantizer bit-width is structural)"
            )
        gd_nq = args.nq[0]
        base_cfg = preset(
            args.preset, num_iterations=T, theta=-0.9,
            **{k: v for k, v in dict(
                window_size=args.window,
                max_phases=args.max_phases,
                uniform_noise=args.uniform_noise or None,
            ).items() if v is not None},
        )
        max_it = T * base_cfg.max_phases

        if sat_on or gd_nq is not None:
            def preprocess(y, point):
                out = y
                if sat_on:
                    out = saturate(out, point["ymax"])
                if gd_nq is not None:
                    out = quantize_round(
                        out, point["ymax"] if sat_on else 2.25, int(gd_nq))
                return out

        def dec(y, sigma, key, point):
            cfg = dataclasses.replace(
                base_cfg, theta=point["theta"],
                noise_scale=point["noise_scale"], lam=point["lam"],
                alpha=point["alpha"],
            )
            return decode_gdbf(code_at(y), y, sigma, cfg, key=key, qc=qc,
                               dense=dense_on(y.device))

        defaults = dict(theta=-0.9, noise_scale=base_cfg.noise_scale,
                        lam=base_cfg.lam, alpha=base_cfg.alpha, ymax=None)

        def row_fn(snr, st, pt):
            c = base_cfg
            return gdbf_log_row(
                snr, st, T, pt["theta"], alist_name,
                noise_scale=(pt["noise_scale"]
                             if c.add_noise or c.quantize_probabilities
                             else None),
                nq=int(gd_nq) if gd_nq is not None else None,
                lam=pt["lam"] if c.threshold_adaptation else None,
                alpha=pt["alpha"] if c.weight_syndromes else None,
                smoothing_used=(int(st.extra.get("smoothing_used", 0))
                                if c.output_smoothing else None),
                window_size=c.window_size if c.output_smoothing else None,
                ymax=pt["ymax"] if sat_on else None,
            )

    elif args.decoder == "ddbmp":
        param_names = ("ymax", "nq")
        _reject_unsweepable(param_names)

        def preprocess(y, point):
            return quantize_no_zero(y, point["ymax"], point["nq"])

        def dec(y, sigma, key, point):
            if qc is not None:
                return decode_ddbmp_qc(qc, y, T)
            return decode_ddbmp(code_at(y), y, T)

        defaults = dict(ymax=1.5, nq=8.0)

        def row_fn(snr, st, pt):
            return minsum_log_row(snr, st, T, alist_name, ymax=pt["ymax"])

    elif args.decoder == "ngdbfhw":
        param_names = ("w", "ymax", "noise_scale", "theta0")
        _reject_unsweepable(param_names)
        # the reference's fixed frame count (NGDBFhw.cpp:193), as the
        # single-device route
        stop = StopRule.fixed_frames(args.frames)
        hw_base = NGDBFHwConfig(
            num_iterations=T,
            max_phases=args.max_phases or 1,
            ring_len=max(2648, code.n + 600),
        )
        max_it = T * hw_base.max_phases

        def dec(y, sigma, key, point):
            cfg = dataclasses.replace(
                hw_base, w=point["w"], ymax=point["ymax"],
                noise_scale=point["noise_scale"], theta0=point["theta0"],
            )
            return decode_ngdbf_hw(code_at(y), y, sigma, cfg, key=key,
                                   qc=qc, dense=dense_on(y.device))

        defaults = dict(w=0.185, ymax=1.625, noise_scale=0.95,
                        theta0=-0.525)

        def row_fn(snr, st, pt):
            return ngdbfhw_log_row(
                snr, st, T, pt["theta0"], pt["noise_scale"], pt["w"],
                pt["ymax"], hw_base.nq, hw_base.max_phases, args.seed,
            )

    else:
        raise SystemExit(
            "sweep: error: --distributed supports bp, min-sum variants, "
            "gdbf, ddbmp, ngdbfhw, and nbqspa"
        )

    # grid tuples -> per-point parameter dicts (defaults fill the Nones)
    points = []
    for pt in grid:
        vals = dict(zip(_GRID_FIELDS, pt))
        point = {"snr": vals["snr"]}
        for nm in param_names:
            v = vals[nm]
            point[nm] = float(defaults[nm] if v is None else v)
        points.append(point)

    stats_list = simulate_grid(
        code, dec, points, mesh_of(nd), max_iterations=max_it, rate=rate,
        stop=stop, batch_per_device=args.batch, seed=args.seed,
        preprocess=preprocess, param_names=param_names,
        codewords=codewords, verbose=args.verbose and writer,
    )
    if not writer:
        return 0
    for pt, point, st in zip(grid, points, stats_list):
        snr = point["snr"]
        append_row(args.log, row_fn(snr, st, point))
        if args.decoder == "ngdbfhw":
            # the iteration-completion CDF (NGDBFhw.cpp:464-469); on a
            # multi-parameter grid the parameters join the file name
            suffix = "".join(
                f"_{nm}{point[nm]:g}" for nm in param_names
                if len(getattr(args, nm)) > 1
            )
            cdf = (st.iteration_cdf_biased() if args.itdist_biased
                   else st.iteration_cdf())
            with open(f"{args.log}_{snr:g}{suffix}_itdist.dat", "w") as f:
                for idx, v in enumerate(cdf):
                    f.write(f"{idx}\t{v:.6g}\n")
        print(
            f"SNR={snr} "
            + " ".join(f"{nm}={point[nm]:g}" for nm in param_names)
            + (" " if param_names else "")
            + f"BER={st.ber:.4g} FER={st.fer:.4g} frames={st.total_words}",
            file=sys.stderr,
        )
        if args.resume:
            _mark_done(args.log, _grid_key(pt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
