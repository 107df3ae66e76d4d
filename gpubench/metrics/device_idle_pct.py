"""Share of the traced sub-window in which the device ran no kernel and
no copy: the host's hold on the card.  In a cell on several cards, the
highest of the cards'."""

from ..trace import busy_ns

LAYER = "device"
MOVES = "info_bits_per_s"
ACROSS_CARDS = max


def read(ctx):
    w0, w1 = ctx["summary"]["window"]
    if w1 <= w0:
        return None
    return 100.0 * (1.0 - busy_ns(ctx["summary"]) / (w1 - w0))
