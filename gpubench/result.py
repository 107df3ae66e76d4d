"""The run's last line and the guards around it."""

from __future__ import annotations

import subprocess
import sys

import torch

from .check import dumps, print_checks

#: top-level modules that may not be loaded in the process that prints
JAX_NAMES = ("jax", "jaxlib", "flax", "ldpcsimulation_tpu")


def jax_loaded() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


def card_line() -> str:
    """The cards' names and power limits, then their SM clocks as the run
    ends, their application and highest SM clocks (a card held at a lower
    clock runs every kernel slower), temperatures and throttle reasons,
    from ``nvidia-smi``."""
    parts = []
    for query in ("name,power.limit",
                  "clocks.sm,clocks.applications.graphics,clocks.max.sm,"
                  "temperature.gpu,clocks_throttle_reasons.active"):
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={query}",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as exc:
            out = f"nvidia-smi unavailable: {exc}"
        parts.append(" | ".join(out.splitlines()))
    return "card: " + " ; ".join(parts)


def device_info(device, count: int, peak_bytes: int) -> dict:
    """The result's ``device``: the card's name (``cpu`` in a test on the
    CPU), the cards used and the highest peak of memory."""
    dev = torch.device(device)
    gpu = dev.type == "cuda"
    return {"platform": "gpu" if gpu else "cpu",
            "kind": torch.cuda.get_device_name(dev) if gpu else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def emit(result: dict, checks: dict, checked: int,
         elsewhere: tuple = ()) -> int:
    """Print the card line, the checks on stderr and the result as the
    last line of stdout; returns the exit code (1, with nothing printed,
    when JAX or the JAX package is loaded in this process, or in one of
    ``elsewhere``: (where, the modules that process found), one for each
    other process that did measured work, such as the other ranks of a
    cell on several cards)."""
    found = [(w, m) for w, m in (("the process that prints the result",
                                  jax_loaded()), *elsewhere) if m]
    if found:
        print("gpubench: refused: " + "; ".join(
            f"{', '.join(m)} loaded in {w}" for w, m in found),
            file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    result = dict(result)
    result["checks"] = checks  # last
    print_checks(checks, checked)
    print(dumps(result), flush=True)
    return 0
