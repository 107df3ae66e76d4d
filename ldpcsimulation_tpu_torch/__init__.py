"""ldpcsimulation_tpu_torch — the PyTorch/CUDA port of ``ldpcsimulation_tpu``.

Everything the JAX package does apart from its TPU lowering choices
(ROADMAP "Left behind"): code construction, the standards' tables, the
GF(2) encoder, the GF(q) codes and the stratified structure of alists
without QC structure (``codes``, ``native``), the keyed AWGN channel and
quantizers (``channel``), the decoders — min-sum, sum-product BP and their
row-layered schedules and stratified forms, DD-BMP, the GDBF/NGDBF
bit-flip family with its graph operations as row gathers or dense
products, the
hardware-model NGDBFhw and SystemC decoders, the non-binary FFT-QSPA and
min-sum/min-max (``decoders``) — the Monte-Carlo harness, its streaming
refill drivers and reference-format log rows (``harness``), multi-device
runs on ``torch.distributed`` (``parallel``), and the sweep CLI with the
experiment tools (``tools``).  Module names mirror the JAX package, so
each counterpart is found by path.

The hot loops are hand-written CUDA kernels for Hopper (``csrc/``), built
with ``nvcc`` on first use and bound through ``ctypes`` (``kernels``).  On
CPU tensors every kernel wrapper runs its plain PyTorch twin instead; on a
CUDA tensor it launches the kernel or raises.

This package imports ``torch`` and numpy only — never ``jax`` and never
``ldpcsimulation_tpu``.
"""

__version__ = "0.1.0"
