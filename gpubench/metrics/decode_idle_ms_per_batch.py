"""Milliseconds per batch (per round, in the grid) in which the card ran
nothing while the innermost program span open was the decoder's
(``ldpc.decode``, or a name under it such as ``ldpc.decode.exit_check``):
the decoders' Python loops launching kernels and reading their all-done
flag.  In a cell on several cards, the highest of the cards'."""

from ._spans import idle_ms_per_batch

LAYER = "host launch path"
MOVES = "info_bits_per_s"
ACROSS_CARDS = max


def read(ctx):
    return idle_ms_per_batch(ctx, decode=True)
