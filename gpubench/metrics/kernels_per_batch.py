"""Device kernels launched per batch in the traced sub-window: the host
launch path (``harness/montecarlo.py`` and the decoders' Python loops)."""

LAYER = "host launch path"
MOVES = "info_bits_per_s"


def read(ctx):
    if not ctx["batches"]:
        return None
    n = sum(1 for *_, kind in ctx["summary"]["device"] if kind == "kernel")
    return n / ctx["batches"]
