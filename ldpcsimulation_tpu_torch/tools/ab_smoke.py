"""Run the ``chip_smoke.py`` of other checkouts of this repository (an
older commit unpacked with ``git archive``, say) with this checkout's
kernel timer, so the kernel times of two commits compare in one call.

    python -m ldpcsimulation_tpu_torch.tools.ab_smoke DIR [DIR ...]

Each DIR's ``chip_smoke.py`` runs in a process of its own, from DIR (so it
builds and loads DIR's kernels), with its module-level ``time_ms`` replaced
by this checkout's; its output passes through.  Exits with the first
non-zero exit code, after running every DIR.

    python -m ldpcsimulation_tpu_torch.tools.ab_smoke --phase \
        phase_generic_main --repeat 5 DIR [DIR ...]

runs, in place of the whole script, one phase function of the signature
``phase(device, timer)`` several times in each DIR's process: the host-clock
rates of one path, with their spread inside a process, free of what the other
phases leave behind.  With ``--here`` the phase is this checkout's, run over
each DIR's package and kernels; so ``phase_b1_times`` times kernel B1 at
every caller's form, and the min-sum paths, in turns with an older commit:

    python -m ldpcsimulation_tpu_torch.tools.ab_smoke --here --phase \
        phase_b1_times build/parent . . build/parent
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

TIMER = Path(__file__).resolve().parents[2] / "chip_smoke.py"

_RUN = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("timer_source", {timer!r})
timer_source = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer_source)
sys.path.insert(0, ".")
phase, repeat, here = {phase!r}, {repeat!r}, {here!r}
if here:
    source = timer_source
else:
    import chip_smoke as source
    source.time_ms = timer_source.time_ms
if phase is None:
    sys.exit(source.main())
import torch
for i in range(repeat):
    print(f"-- {{phase}} run {{i}}", flush=True)
    getattr(source, phase)(torch.device("cuda", 0), source.time_ms)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path,
                    help="checkouts holding a chip_smoke.py")
    ap.add_argument("--phase", help="run only this phase(device, timer) "
                    "function of each chip_smoke.py")
    ap.add_argument("--repeat", type=int, default=1,
                    help="times to run --phase in each process")
    ap.add_argument("--here", action="store_true",
                    help="run this checkout's --phase over each DIR's "
                    "package")
    args = ap.parse_args(argv)
    if args.here and args.phase is None:
        ap.error("--here needs --phase")
    code = _RUN.format(timer=str(TIMER), phase=args.phase,
                       repeat=args.repeat, here=args.here)
    rcs = []
    for d in args.dirs:
        print(f"== {d} (timer: {TIMER})", flush=True)
        rcs.append(subprocess.run([sys.executable, "-c", code],
                                  cwd=d).returncode)
        print(f"== {d}: exit {rcs[-1]}", flush=True)
    return next((rc for rc in rcs if rc), 0)


if __name__ == "__main__":
    sys.exit(main())
