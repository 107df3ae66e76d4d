"""Experiment tools: the sweep CLI (``python -m
ldpcsimulation_tpu_torch.tools.sweep``); replay and tracing (``replay``,
``msg_trace``, ``hw_trace``), error imaging (``errimage``), redecode
statistics (``redecode_stats``), the stochastic flip levels
(``prob_combinations``), the cross-check against the compiled C reference
(``validate_reference``) and the throughput table (``perf_report``) — the
reference's scripts/ and post-processing layer.  Besides: the SASS path
counter behind the kernels' issue bounds (``tools.sass_count``); and
``tools.ab_smoke``, which runs other checkouts' ``chip_smoke.py`` with this
checkout's timer."""

from .errimage import decisions_to_errors, error_count_trace, error_matrix_png
from .redecode_stats import redecode_statistics
from .replay import GDBFTrace, replay_channel, trace_gdbf, write_trace

__all__ = [
    "decisions_to_errors",
    "error_count_trace",
    "error_matrix_png",
    "redecode_statistics",
    "GDBFTrace",
    "replay_channel",
    "trace_gdbf",
    "write_trace",
]
