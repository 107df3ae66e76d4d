"""Experiment tools: the sweep CLI (``python -m
ldpcsimulation_tpu_torch.tools.sweep``); the SASS path counter behind the
kernels' issue bounds (``tools.sass_count``); and ``tools.ab_smoke``, which
runs other checkouts' ``chip_smoke.py`` with this checkout's timer."""
