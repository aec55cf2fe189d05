"""Diagnostics of the port's kernels, run on a CUDA card, and the
real-weight runbook (``real_weight_day``)."""
