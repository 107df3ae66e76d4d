"""Codeword fixture I/O (`data.enc`-style files).

Reference format (``C_implementations/codes/*/data.enc``, read at
``decodeBP.cpp:154-176``): ASCII '0'/'1' characters, one codeword per line,
bit i of the line mapping to symbol ``c[i] = '1' ? -1 : +1``.  The reference
cycles the file by rewinding on EOF; :func:`cycle_indices` reproduces that
for batched access.  Invalid characters warn and are treated as '0'
(decodeBP.cpp:170 prints a warning and leaves the previous value; we map to 0
deterministically).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

__all__ = ["load_codeword_file", "save_codeword_file", "cycle_indices"]


def load_codeword_file(path: str, n: Optional[int] = None) -> np.ndarray:
    """Load [L, N] bit matrix from an ASCII codeword file."""
    rows = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            if n is not None and len(line) < n:
                raise ValueError(
                    f"{path}:{lineno + 1}: line has {len(line)} symbols, need {n}"
                )
            width = n if n is not None else len(line)
            bits = np.zeros(width, np.uint8)
            for i in range(width):
                ch = line[i]
                if ch == "1":
                    bits[i] = 1
                elif ch != "0":
                    print(
                        f"Got an invalid symbol at index {i}", file=sys.stderr
                    )
            rows.append(bits)
    if not rows:
        raise ValueError(f"{path}: no codewords")
    return np.stack(rows)


def save_codeword_file(path: str, codewords: np.ndarray) -> None:
    cw = np.asarray(codewords, np.uint8)
    with open(path, "w") as f:
        for row in cw:
            f.write("".join("1" if b else "0" for b in row) + "\n")


def cycle_indices(offset: int, batch: int, length: int) -> np.ndarray:
    """Frame indices for a batch, cycling like the reference's file rewind."""
    return (offset + np.arange(batch)) % length
