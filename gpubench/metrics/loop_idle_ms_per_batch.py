"""Milliseconds per batch (per round, in the grid) in which the card ran
nothing while the innermost program span open was one of the loop's: the
channel's launches, the count, the host copies, the NumPy tally, the grid's
slot set-up, all-reduce, copy and tally (every ``ldpc.`` span but
``ldpc.decode`` and the names under it).  In a cell on several cards, the
highest of the cards'."""

from ._spans import idle_ms_per_batch

LAYER = "harness loop"
MOVES = "info_bits_per_s"
ACROSS_CARDS = max


def read(ctx):
    return idle_ms_per_batch(ctx, decode=False)
