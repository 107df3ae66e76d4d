"""Error-pattern imaging: matrices of decisions/syndromes -> PNG heatmaps.

A copy of ``ldpcsimulation_tpu.tools.errimage`` (numpy only; matplotlib is
imported where a PNG is rendered).  Reference counterpart: ``C_implementations/src/errtopng.cpp`` (libpng
renderer of error-pattern matrices, plus per-iteration error-count traces
``:28-110``).  Output here goes through matplotlib; the ``.err``-style
per-iteration error-count trace is reproduced as a text file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "error_matrix_png",
    "error_count_trace",
    "decisions_to_errors",
    "shift_scale_matrix",
    "merge_matrices",
    "read_matrix_file",
    "write_matrix_file",
    "compose_error_images",
]


def decisions_to_errors(decisions: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """[T, N] ±1 decision trace + [N] truth -> [T, N] 0/1 error matrix."""
    return (np.asarray(decisions) != np.asarray(truth)[None, :]).astype(
        np.uint8
    )


def error_matrix_png(
    matrix: np.ndarray,
    path: str,
    title: Optional[str] = None,
    scale: int = 1,
) -> None:
    """Render a 0/1 (or integer) matrix as a PNG heatmap.

    Rows = iterations, columns = bit positions (errtopng's layout).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = np.asarray(matrix)
    fig, ax = plt.subplots(
        figsize=(max(4, m.shape[1] / 100), max(2, m.shape[0] / 50))
    )
    ax.imshow(m, aspect="auto", interpolation="nearest", cmap="viridis")
    ax.set_xlabel("bit index")
    ax.set_ylabel("iteration")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100 * scale)
    plt.close(fig)


def error_count_trace(matrix: np.ndarray, path: str) -> None:
    """Per-iteration error counts (the ``.err`` trace,
    errtopng.cpp ``countErrorTrace``)."""
    m = np.asarray(matrix)
    with open(path, "w") as f:
        for it, row in enumerate(m):
            f.write(f"{it}\t{int(row.sum())}\n")


def shift_scale_matrix(
    matrix: np.ndarray, shift: float = -1.0, scale: float = -1.0
) -> np.ndarray:
    """``(x + shift) * scale`` elementwise (errtopng.cpp ``shiftMatrix``).

    The default (−1, −1) is errtopng's hard-coded call: ±1 decision traces
    of the all-zero codeword map to 0 (correct) / 2 (error)."""
    return (np.asarray(matrix, np.float64) + shift) * scale


def merge_matrices(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """Elementwise-accumulate two traces (errtopng.cpp ``mergeMatrices``).

    Overlapping leading rows add; if the second trace is longer (a frame
    that decoded for more iterations), its extra rows are appended
    verbatim.  Matrix1 may be empty (shape [0, N])."""
    m1 = np.asarray(matrix1, np.float64)
    m2 = np.asarray(matrix2, np.float64)
    if m1.size == 0:
        return m2.copy()
    k = min(m1.shape[0], m2.shape[0])
    rows = [m1[:k] + m2[:k]]
    longer = m1 if m1.shape[0] > k else m2
    if longer.shape[0] > k:
        rows.append(longer[k:])
    return np.concatenate(rows, axis=0)


def read_matrix_file(path: str) -> np.ndarray:
    """Whitespace-separated numeric rows (errtopng.cpp ``readMatrix``);
    also accepts this package's ``write_trace`` format (a leading ``d``/
    ``s`` tag per line selects the decision rows)."""
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] in ("d", "s"):
                if toks[0] != "d":
                    continue
                toks = toks[1:]
            rows.append([float(t) for t in toks])
    return np.asarray(rows, np.float64)


def write_matrix_file(path: str, matrix: np.ndarray) -> None:
    """Tab-separated rows (errtopng.cpp ``fprintMatrix``)."""
    with open(path, "w") as f:
        for row in np.asarray(matrix):
            f.write("\t".join(f"{v:g}" for v in row) + "\n")


def compose_error_images(out_prefix: str, traces) -> np.ndarray:
    """errtopng's main(): merge several decision traces into one heatmap.

    For each input trace ([T_i, N] ±1 decisions, or a path readable by
    :func:`read_matrix_file`): apply ``shift_scale_matrix(-1, -1)``,
    record its per-iteration error-count trace, and accumulate into the
    running merge.  Writes ``<out_prefix>.png`` (merged heatmap) and
    ``<out_prefix>.err`` (one tab-separated line of per-iteration counts
    per input trace — errtopng.cpp:36-88).  Returns the merged matrix.
    """
    merged = np.zeros((0, 0), np.float64)
    history = []
    for tr in traces:
        m = read_matrix_file(tr) if isinstance(tr, str) else np.asarray(tr)
        m = shift_scale_matrix(m, -1.0, -1.0)
        history.append(m.sum(axis=1))
        merged = merge_matrices(merged, m)
    error_matrix_png(merged, out_prefix + ".png", title="merged error trace")
    with open(out_prefix + ".err", "w") as f:
        for trace_counts in history:
            f.write("\t".join(f"{v:g}" for v in trace_counts) + "\n")
    return merged
