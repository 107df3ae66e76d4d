"""One rank of a grid cell on the CPU at a small size, for the tests.

    python cpu_rank.py ROOT WORKLOAD SEED SECONDS BATCH [FAULT]

runs :func:`gpubench.modes.grid.rank_main` on the CPU (gloo) under the
rank environment that ``parallel.mesh.spawn_ranks`` sets, with the cell's
batch and check cut to ``BATCH`` frames.  ``FAULT`` ``no_exchange`` leaves
out the all-reduce between ranks; ``jax_on_rank_1`` puts a module named
``jax`` into rank 1's ``sys.modules``.
"""

import argparse
import os
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    t0 = time.perf_counter()
    root = Path(sys.argv[1])
    sys.path.insert(0, str(root))
    from gpubench.modes import grid
    from gpubench.spec import load_cell

    cell = load_cell(root, sys.argv[2])
    batch = int(sys.argv[5])
    cell.traffic.update(batch=batch, check_frames=batch)
    if len(sys.argv) > 6 and sys.argv[6] == "no_exchange":
        import ldpcsimulation_tpu_torch.parallel.mesh as mesh

        mesh.all_reduce_sum = lambda t: t
    if (len(sys.argv) > 6 and sys.argv[6] == "jax_on_rank_1"
            and os.environ["RANK"] == "1"):
        sys.modules["jax"] = sys
    args = argparse.Namespace(seed=int(sys.argv[3]),
                              seconds=float(sys.argv[4]), trace=0)
    sys.exit(grid.rank_main(cell, args, t0, None, cpu=True))
