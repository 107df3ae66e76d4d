"""Min-sum with early termination, and the min-sum reference in blocks of
frames: the plain reference against the program's QC decoder on the CPU,
bit for bit, on tables with pairs of circulants and absent edges."""

import copy

import pytest
import torch

from gpubench.families import minsum as fam
from gpubench.reference import Precision, minsum, philox, sigma_of
from gpubench.spec import load_cell

from .conftest import ROOT
from .test_gpubench_codes import built

SEED = 2 ** 31 + 4099
F16 = Precision()


def mixed_channel(n: int, points) -> torch.Tensor:
    """Samples of ``(Eb/N0, frames)`` groups, each group's frames its own:
    frames clean at the channel (0 rounds), in the waterfall, and beyond
    the decoder's reach (all T rounds, never satisfied)."""
    parts, frame0 = [], 0
    for snr, count in points:
        frames = frame0 + torch.arange(count)
        parts.append(philox.channel(SEED, frames, n, sigma_of(snr, 0.5)))
        frame0 += count
    return torch.cat(parts)


@pytest.mark.parametrize("name, T, points", [
    ("hand_48_24", 20, [(20.0, 40), (4.0, 80), (-3.0, 40)]),
    ("qc_1008_504", 20, [(16.0, 8), (2.0, 40), (-1.0, 8)]),
    ("dvbs2_1_2_qc", 50, [(14.0, 4), (1.6, 16), (0.0, 4)]),
])
def test_early_termination_equals_program(name, T, points):
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import decode_minsum_qc

    _, g, qc = built(name)
    y = mixed_channel(g.n, points)
    hard, its, sat = minsum.decode(g, y, T, F16, early_termination=True)
    res = decode_minsum_qc(qc, y, T, early_termination=True,
                           storage_dtype=torch.float16)
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert bool((its == 0).any())  # satisfied at the channel
    assert bool(((its == T) & ~sat).any())  # never satisfied
    assert bool(((its > 0) & sat).any())  # satisfied in some round


@pytest.mark.parametrize("name, T, points", [
    ("hand_48_24", 20, [(20.0, 40), (4.0, 80), (-3.0, 40)]),
    ("dvbs2_1_2_qc", 10, [(14.0, 4), (1.6, 8)]),
])
def test_fixed_rounds_equals_program(name, T, points):
    """Without early termination every frame runs all T rounds, on tables
    with pairs and absent edges as on qc_1008_504."""
    from ldpcsimulation_tpu_torch.decoders.minsum_qc import decode_minsum_qc

    _, g, qc = built(name)
    y = mixed_channel(g.n, points)
    hard, its, sat = minsum.decode(g, y, T, F16)
    res = decode_minsum_qc(qc, y, T, storage_dtype=torch.float16)
    assert torch.equal(hard.to(torch.int32), res.hard)
    assert torch.equal(its, res.iterations)
    assert torch.equal(sat, res.satisfied)
    assert bool((its == T).all())


@pytest.mark.parametrize("early", [False, True])
def test_blocked_reference_equals_whole(early, monkeypatch):
    """The family's reference in blocks of frames (uneven, the last one
    short) gives the whole batch's outputs, bit for bit."""
    cell = load_cell(ROOT, "minsum-fixed-2.0dB")
    cfg = copy.deepcopy(cell.config)
    cfg["decoder"]["early_termination"] = early
    _, g, _ = built("qc_1008_504")
    frames = 7 * 2 ** 20 + torch.arange(150)
    sigma = sigma_of(2.0, 0.5)
    whole = fam.reference(cfg, g, SEED, frames, sigma, F16)
    monkeypatch.setattr(fam, "_BLOCK_BYTES",
                        64 * fam._EDGE_FRAME_BYTES * g.e)
    assert fam.frames_per_block(g) == 64
    blocked = fam.reference(cfg, g, SEED, frames, sigma, F16)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)
    its = whole[2]
    assert (len(set(its.tolist())) > 1) == early


def test_block_size_from_the_edges():
    """A kept batch of the qc_1008_504 cells (32768 frames) stays one
    block; DVB-S2's 226799 edges split a 16384-frame batch."""
    assert fam.frames_per_block(built("qc_1008_504")[1]) >= 32768
    per = fam.frames_per_block(built("dvbs2_1_2_qc")[1])
    assert 64 <= per < 16384
