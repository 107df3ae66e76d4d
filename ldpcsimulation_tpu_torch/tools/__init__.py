"""Experiment tools: the sweep CLI (``python -m
ldpcsimulation_tpu_torch.tools.sweep``)."""
