"""The benchmark of ``ldpcsimulation_tpu_torch`` on NVIDIA GPUs.

``run.py`` is the entry point; ``BENCHMARK.json`` at the checkout root names
the cells, and each configuration, traffic mix and per-layer metric is a file
of its own here, found by its name (``configs/``, ``traffic/``,
``metrics/``).  ``reference/`` is the plain PyTorch reference that decides
``correct``; it imports nothing of the program.
"""
