"""Example: compare decoder families on one code across an Eb/N0 grid, on
the PyTorch/CUDA port.

Counterpart of ``examples/compare_decoders.py``: the QC (1008,504) code
through min-sum (flooding and layered), sum-product BP (flooding and
layered) and SM-NGDBF at each SNR point, printed as a BER/FER/average-
iteration table.  Runs on the card by default; ``--device cpu`` runs the
kernels' plain PyTorch twins.

    python examples/compare_decoders_torch.py --snr 2.0:3.0:0.5 --frames 4096
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ldpcsimulation_tpu_torch.channel import (
    llr_from_channel,
    saturate,
    snr_to_n0,
    snr_to_sigma,
)
from ldpcsimulation_tpu_torch.codes.library import load_named_qc
from ldpcsimulation_tpu_torch.decoders import (
    decode_bp_layered_qc,
    decode_bp_qc,
    decode_gdbf,
    decode_minsum_layered_qc,
    decode_minsum_qc,
    preset,
)
from ldpcsimulation_tpu_torch.harness import MCStats, StopRule, simulate
from ldpcsimulation_tpu_torch.tools.sweep import _parse_snr

CODE_NAME = "qc_1008_504"
SEED = 7
#: the SM-NGDBF working point of the JAX example
SM_CFG = preset("SMNGDBF", num_iterations=300, theta=-0.9, noise_scale=0.975,
                lam=0.988, alpha=0.75, window_size=64)


def rows(snr: float, frames: int, batch: int, device) -> List[tuple]:
    """``[(name, MCStats)]``, the five rows at ``snr``: ``frames`` frames
    each through ``simulate`` in batches of ``batch`` (seed 7)."""
    device = torch.device(device)
    qc = load_named_qc(CODE_NAME)
    code = qc.to_code(device)
    n0 = snr_to_n0(snr, code.rate)
    sigma = snr_to_sigma(snr, code.rate)
    stop = StopRule.fixed_frames(frames)

    def run(decode_fn, preprocess=None) -> MCStats:
        return simulate(code, decode_fn, snr_db=snr, stop=stop,
                        batch_size=batch, preprocess=preprocess, seed=SEED,
                        device=device)

    def llr(y):
        return llr_from_channel(y, n0)

    return [
        ("min-sum T=10 (flooding)", run(
            lambda y, k: decode_minsum_qc(qc, y, 10, early_termination=True,
                                          storage_dtype=torch.float16))),
        ("min-sum T=10 (layered)", run(
            lambda y, k: decode_minsum_layered_qc(qc, y, 10,
                                                  early_termination=True))),
        ("BP T<=30 (flooding)", run(
            lambda x, k: decode_bp_qc(qc, x, 30, early_termination=True),
            preprocess=llr)),
        ("BP T<=30 (layered)", run(
            lambda x, k: decode_bp_layered_qc(qc, x, 30,
                                              early_termination=True),
            preprocess=llr)),
        ("SM-NGDBF T<=300", run(
            lambda yq, k: decode_gdbf(code, yq, sigma, SM_CFG, key=k, qc=qc),
            preprocess=lambda y: saturate(y, 2.5))),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snr", default="2.0:3.0:0.5")
    p.add_argument("--frames", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain twins)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        raise SystemExit("compare_decoders_torch: error: --device cuda, but "
                         "no CUDA device is available (pass --device cpu)")

    print(f"{'decoder':26s} {'Eb/N0':>6s} {'BER':>10s} {'FER':>10s} "
          f"{'iters':>6s}")
    for snr in _parse_snr(args.snr):
        for name, st in rows(snr, args.frames, args.batch, args.device):
            print(f"{name:26s} {snr:6.2f} {st.ber:10.3e} {st.fer:10.3e} "
                  f"{st.avg_iterations:6.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
