"""The BP cell (``bp-et20-2.0dB``): the plain sum-product reference against
the program's ``decode_bp_qc`` on the CPU, its control, the check update's
byte count, and the reader that attributes device time to a span by
launch order."""

import pytest
import torch

from gpubench.check import verdict
from gpubench.families import bp as bp_family
from gpubench.metrics import _launch_spans, bp_check_roofline_pct
from gpubench.modes import common
from gpubench.reference import Precision, codes, philox, sigma_of

from .helpers import SEED, run_cpu, small_cell
from .test_gpubench_imports import BENCH, JAX, PROGRAM, top_level_imports

CELL = "bp-et20-2.0dB"
H100 = "NVIDIA H100 80GB HBM3"
MS = 1_000_000  # ns
F16 = Precision()
NEW_FILES = ("reference/bp.py", "families/bp.py", "metrics/_launch_spans.py",
             "metrics/bp_check_roofline_pct.py")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the CPU's ``exp`` and ``log`` take a scalar path
    on the tail of each thread's share of a tensor, so the bits of a
    transcendental depend on how the work is split."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def graph():
    return codes.graph(codes.load_table("qc_1008_504"))


@pytest.fixture(scope="module")
def cfg():
    return small_cell(CELL).config


@pytest.mark.parametrize("snr", [2.0, 1.0])
def test_reference_equals_program(graph, cfg, snr):
    from ldpcsimulation_tpu_torch.channel.awgn import llr_from_channel
    from ldpcsimulation_tpu_torch.codes.library import load_named_qc
    from ldpcsimulation_tpu_torch.decoders.bp_qc import decode_bp_qc

    sigma = sigma_of(snr, 0.5)
    frames = 3000 + torch.arange(256)
    llr, hard, its, sat = bp_family.reference(cfg, graph, SEED, frames,
                                              sigma, F16)
    y = philox.channel(SEED, frames, graph.n, sigma)
    dec = cfg["decoder"]
    got = llr_from_channel(y, bp_family.n0_of(sigma), dec["max_llr"])
    res = decode_bp_qc(load_named_qc("qc_1008_504"), got, dec["iterations"],
                       max_llr=dec["max_llr"], early_termination=True,
                       storage_dtype=torch.float16)
    assert torch.equal(got, llr)
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert not bool(sat.all())  # frames fail: every round runs
    assert len(its.unique()) > 5  # and the others stop at many rounds


def test_control_is_not_correct():
    cell = small_cell(CELL, batch=64)
    graph, sigmas, prec, ctrl = common.setup_reference(cell)
    b = cell.traffic["batch"]
    ref = cell.family.reference(cell.config, graph, SEED,
                                7 * b + torch.arange(b), sigmas[0], prec)
    kept = {7: dict(frame0=7 * b, inp=ref[0], hard=ref[1],
                    iterations=ref[2], satisfied=ref[3])}
    prog, control, _ = common.check_kept(cell, kept, graph, SEED,
                                         lambda _: sigmas[0], prec, "cpu",
                                         control=ctrl)
    assert verdict(prog.numbers(), cell.config["limits"], prog.frames)[0]
    ok, table = verdict(control.numbers(), cell.config["limits"],
                        control.frames)
    assert not ok
    assert table["chan_max_err"]["value"] > table["chan_max_err"]["limit"]
    assert table["frames_differ"]["value"] > table["frames_differ"]["limit"]


def test_sound_run_is_correct():
    got = run_cpu(small_cell(CELL, batch=32))
    assert got["correct"], got
    assert got["checks"]["frames_differ"]["value"] == 0.0
    assert set(got["metrics"]) == {"info_bits_per_s", "batch_ms_p95",
                                   "peak_mem_gib", "setup_s"}


def test_altered_answer_is_not_correct(monkeypatch):
    real = bp_family.Port.batch_decoder

    def broken(self, sigma):
        decode, pre = real(self, sigma)

        def altered(llr, key):
            res = decode(llr, key)
            res.iterations = res.iterations.clone()
            res.iterations[0] += 1
            return res

        return altered, pre

    monkeypatch.setattr(bp_family.Port, "batch_decoder", broken)
    assert run_cpu(small_cell(CELL, batch=32))["correct"] is False


def test_check_update_bytes(graph):
    nbytes = bp_check_roofline_pct.call_bytes(graph.e, 32768, 2)
    assert round(nbytes / 1e6, 1) == 396.4
    assert round(nbytes / 3.35e9, 4) == 0.1183  # ms, the layer's least time
    degrees = (graph.check_edges < graph.e).sum(dim=1).tolist()
    assert sorted(set(degrees)) == [5, 6, 7]
    ops = bp_check_roofline_pct.call_ops(degrees, 32768)
    assert ops / 67e12 < nbytes / 3.35e12 / 4  # the bytes bound it


K = "void k<float>(float)"


def summary_of(host, kernels, batches=1):
    """A sub-window with the host ``host`` [(name, start, end)] and the
    device kernels ``kernels`` [(start, end)] (ns)."""
    return {"window": (0, 100 * MS), "batches": batches, "host": host,
            "device": [(K, s, t, "kernel") for s, t in kernels]
            + [("Memcpy DtoH", 98 * MS, 99 * MS, "copy")]}


def launches(*starts):
    return [("cudaLaunchKernel", s * MS, s * MS + 5000) for s in starts]


SPAN = bp_check_roofline_pct.SPAN
KERNELS = [(10 * MS, 12 * MS), (12 * MS, 15 * MS), (20 * MS, 21 * MS),
           (40 * MS, 44 * MS), (50 * MS, 58 * MS)]


def test_launch_order_attributes_device_time():
    # launches at 1, 3 (inside the first range), 5 (between), 31 and 33
    # (inside the second): the second range's kernels ran well after
    host = ([(SPAN, 2 * MS, 4 * MS), (SPAN, 30 * MS, 34 * MS),
             ("cudaMemcpyAsync", 35 * MS, 36 * MS)]
            + launches(1, 3, 5, 31, 33))
    secs = _launch_spans.per_span(summary_of(host, KERNELS), SPAN)
    assert secs == pytest.approx([3e-3, 12e-3])


def test_counts_that_differ_read_nothing(capsys):
    host = [(SPAN, 2 * MS, 4 * MS)] + launches(1, 3, 5, 31)
    assert _launch_spans.per_span(summary_of(host, KERNELS), SPAN) is None
    assert "4 kernel launches against 5 device kernels" in (
        capsys.readouterr().err)


def ctx_of(summary):
    cell = small_cell(CELL, batch=32768)
    g = codes.graph(codes.load_table("qc_1008_504"))
    return {"summary": summary, "batches": 1, "cell": cell, "graph": g,
            "batch": 32768, "kind": H100, "hand_kernels": ()}


def test_without_the_span_nothing_is_read():
    summary = summary_of(launches(1, 3, 5, 31, 33), KERNELS)
    assert _launch_spans.per_span(summary, SPAN) is None
    assert bp_check_roofline_pct.read(ctx_of(summary)) is None


def test_share_of_the_roofline():
    host = ([(SPAN, 2 * MS, 4 * MS), (SPAN, 30 * MS, 34 * MS)]
            + launches(1, 3, 5, 31, 33))
    ctx = ctx_of(summary_of(host, KERNELS))
    least = bp_check_roofline_pct.call_bytes(ctx["graph"].e, 32768,
                                             2) / 3.35e12
    assert bp_check_roofline_pct.read(ctx) == pytest.approx(
        100 * 2 * least / 15e-3)
    names = [m["name"] for m in ctx["cell"].per_layer]
    assert "bp_check_roofline_pct" in names
    assert "glue_ms_per_batch" not in names
    assert {"kernels_per_batch", "device_idle_pct", "b6_roofline_pct",
            "b2_roofline_pct", "loop_idle_ms_per_batch",
            "decode_idle_ms_per_batch"} <= set(names)


@pytest.mark.parametrize("name", NEW_FILES)
def test_new_files_import_no_jax(name):
    names = top_level_imports(BENCH / name)
    assert not names & JAX
    if name.startswith("reference/"):
        assert PROGRAM not in names
        assert names <= {"__future__", "torch"}
