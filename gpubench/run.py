"""Run one cell of the benchmark of ``ldpcsimulation_tpu_torch``.

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the checkout's root.  Prints, as the last line of stdout, one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
(and with ``--trace 1`` ``breakdown``) and ``checks``, the numbers of the
output check beside their limits (also the last lines of stderr).  Exits
with 2, printing no result, on a machine without the CUDA cards the cell
needs.

``--readings SEED,SEED,...`` prints instead, for each seed, the numbers of
the output check for the program and for the control (the reference one
precision step lower in the program's place): the readings that the
configurations' limits are set from.
"""

import time

T_PROC = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default=None,
                   help="comma-separated seeds: print the check's numbers "
                   "for the program and the control on each")
    p.add_argument("--launched-at", type=float, default=None,
                   help=argparse.SUPPRESS)  # a rank's launcher's start
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from gpubench.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 2
    readings = ([int(s) for s in args.readings.split(",")]
                if args.readings else None)
    t0 = args.launched_at if args.launched_at is not None else T_PROC
    return cell.runner.main(cell, args, t0, readings)


if __name__ == "__main__":
    sys.exit(main())
