"""ldpcsimulation_tpu_torch — the PyTorch/CUDA port of ``ldpcsimulation_tpu``.

The flooding min-sum Monte-Carlo path on quasi-cyclic codes, end to end:
code construction (``codes``), the keyed all-(+1) AWGN channel
(``channel``), the QC min-sum decoder (``decoders``), the Monte-Carlo
statistics and reference-format log rows (``harness``) and the sweep CLI
(``tools.sweep``).  Module names mirror the JAX package, so each
counterpart is found by path.

The hot loops are hand-written CUDA kernels for Hopper (``csrc/``), built
with ``nvcc`` on first use and bound through ``ctypes`` (``kernels``).  On
CPU tensors every kernel wrapper runs its plain PyTorch twin instead; on a
CUDA tensor it launches the kernel or raises.

This package imports ``torch`` and numpy only — never ``jax`` and never
``ldpcsimulation_tpu``.
"""

__version__ = "0.1.0"
