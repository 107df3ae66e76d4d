"""Monte-Carlo harness: simulation loop, stopping rules, stats, log rows;
the non-binary loop in :mod:`.montecarlo_nb`; the streaming refill harness
in :mod:`.stream` (binary and non-binary), :mod:`.stream_gdbf` and
:mod:`.stream_ngdbfhw`."""

from .fixtures import cycle_indices, load_codeword_file, save_codeword_file
from .logging import (
    append_row,
    bp_log_row,
    fmt,
    gdbf_log_row,
    minsum_log_row,
    ngdbfhw_log_row,
)
from .montecarlo import MCStats, StopRule, default_min_word_errors, simulate
from .montecarlo_nb import NBMCStats, simulate_nb
from .stream import (
    StreamDecoder,
    bp_qc_stream,
    minsum_qc_stream,
    minsum_stream,
    simulate_stream,
)

__all__ = [
    "MCStats",
    "StopRule",
    "default_min_word_errors",
    "simulate",
    "NBMCStats",
    "simulate_nb",
    "StreamDecoder",
    "bp_qc_stream",
    "minsum_qc_stream",
    "minsum_stream",
    "simulate_stream",
    "append_row",
    "bp_log_row",
    "fmt",
    "gdbf_log_row",
    "minsum_log_row",
    "ngdbfhw_log_row",
    "cycle_indices",
    "load_codeword_file",
    "save_codeword_file",
]
