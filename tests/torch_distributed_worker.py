"""Worker process of the port's multi-process ``torch.distributed`` test.

Each worker joins a CPU process group through ``init_distributed`` (gloo,
``tcp://localhost:PORT``), builds the global meshes of :func:`run_cases`
over four CPU slots split evenly over the ranks, runs them, and writes its
results as JSON.  The parent test runs :func:`run_cases` in one process
and compares every rank's results with it: the counters are all-reduced,
so every rank holds the same totals, and frames are keyed by (seed, frame
index), so the split of the slots over processes must be invisible.

Usage: python torch_distributed_worker.py PORT NPROC RANK OUT.json
"""

import json
import sys

import numpy as np
import torch

SLOTS = 4


def run_cases(devices) -> dict:
    """The distributed paths on a 4-slot mesh of ``devices``: one counters
    step, one grid step with two operating points, ``simulate_grid`` over
    three points, ``simulate_stream(mesh=)`` and
    ``simulate_stream_ngdbfhw(mesh=)`` (its step count too); and one
    ``simulate_stream`` without a mesh, which stays this rank's own run.
    Results as JSON-ready lists."""
    from ldpcsimulation_tpu_torch.codes import build_code, make_regular_code
    from ldpcsimulation_tpu_torch.codes import peg
    from ldpcsimulation_tpu_torch.codes.qc import qc_peg
    from ldpcsimulation_tpu_torch.decoders import decode_minsum
    from ldpcsimulation_tpu_torch.decoders.ngdbf_hw import NGDBFHwConfig
    from ldpcsimulation_tpu_torch.harness import StopRule
    from ldpcsimulation_tpu_torch.harness.stream import (
        minsum_qc_stream,
        simulate_stream,
    )
    from ldpcsimulation_tpu_torch.harness.stream_ngdbfhw import (
        simulate_stream_ngdbfhw,
    )
    from ldpcsimulation_tpu_torch.parallel.mesh import (
        make_counters_step,
        make_grid_step,
        make_mesh,
    )
    from ldpcsimulation_tpu_torch.parallel.montecarlo import simulate_grid

    def lists(out):
        return {k: np.asarray(v).tolist() for k, v in out.items()}

    code = make_regular_code(96, 48, 3, seed=0)
    out = {}
    mesh = make_mesh(n_snr=1, devices=devices)
    step = make_counters_step(
        code,
        lambda y, sigma, key: decode_minsum(code, y, 10,
                                            early_termination=True),
        mesh, sigmas=[0.75], batch_per_device=16, max_iterations=10,
    )
    out["counters"] = lists(step(7, 1))

    def normalized(y, sigma, key, point):
        return decode_minsum(code, y, 6, variant="normalized",
                             alpha=point["alpha"], early_termination=True)

    gmesh = make_mesh(n_snr=2, devices=devices)
    gstep = make_grid_step(code, normalized, gmesh, batch_per_device=8,
                           max_iterations=6, param_names=("alpha",))
    out["grid"] = lists(gstep(7, [0.6, 0.8], {"alpha": [1.0, 1.25]},
                              [0, 48]))
    stats = simulate_grid(
        code, normalized,
        [{"snr": s, "alpha": a} for s, a in ((2.0, 1.0), (3.0, 1.25),
                                             (4.0, 1.0))],
        gmesh, max_iterations=6,
        stop=StopRule(min_bit_errors=20, min_word_errors=2, max_frames=96),
        batch_per_device=8, seed=3, param_names=("alpha",),
    )
    out["simulate_grid"] = [
        [s.errors, s.word_errors, s.total_words, s.total_iterations,
         s.uncoded_errors, s.iteration_hist.tolist()] for s in stats
    ]
    def totals(st):
        return [st.total_words, st.errors, st.word_errors,
                st.total_iterations, st.satisfied_words, st.uncoded_errors,
                st.iteration_hist.tolist(), st.error_weight_hist.tolist()]

    qcs = qc_peg(8, 4, 3, z=16, seed=0)
    kw = dict(stop=StopRule.fixed_frames(64), rounds_per_call=4,
              refill_every=1, seed=3)
    out["stream"] = totals(simulate_stream(
        qcs.n, minsum_qc_stream(qcs), 2.5, 0.5, 8, lanes=8 * SLOTS,
        mesh=mesh, **kw))
    out["stream_one_device"] = totals(simulate_stream(
        qcs.n, minsum_qc_stream(qcs), 2.5, 0.5, 8, lanes=8, device="cpu",
        **kw))
    # the slots' drains stop at different steps: every rank must report
    # the one shared ring counter
    hw_code = build_code(peg(96, 48, 3, seed=7))
    hw_cfg = NGDBFHwConfig(num_iterations=16, w=0.25, ymax=1.5,
                           noise_scale=0.9, theta0=-0.5, ring_len=200,
                           max_phases=2)
    st = simulate_stream_ngdbfhw(
        hw_code, hw_cfg, 4.0, rate=0.5, stop=StopRule.fixed_frames(96),
        lanes=4 * SLOTS, refill_every=4, rounds_per_call=3, seed=5,
        mesh=mesh)
    out["stream_ngdbfhw"] = totals(st) + [st.extra["steps"]]
    return out


if __name__ == "__main__":
    port, nproc, rank, out_path = sys.argv[1:5]
    nproc, rank = int(nproc), int(rank)
    torch.set_num_threads(1)

    import datetime

    import torch.distributed as dist

    from ldpcsimulation_tpu_torch.parallel.mesh import init_distributed

    devices = ["cpu"] * SLOTS
    kw = dict(init_method=f"tcp://localhost:{port}", rank=rank,
              world_size=nproc, devices=devices,
              timeout=datetime.timedelta(seconds=60))
    init_distributed(**kw)
    init_distributed(**kw)  # idempotent: a no-op on a formed group
    assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc
    result = run_cases(devices)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    print(f"worker {rank} ok", flush=True)
