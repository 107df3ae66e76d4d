"""Monte-Carlo harness: simulation loop, stopping rules, stats, log rows;
the streaming refill harness in :mod:`.stream` and :mod:`.stream_gdbf`."""

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

__all__ = [
    "MCStats",
    "StopRule",
    "default_min_word_errors",
    "simulate",
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
