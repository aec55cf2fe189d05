"""Ensemble evaluation (port of ``esmdiff_tpu/eval``): rigid alignment,
sequence alignment, TM-score, the metric suites and the benchmark
analyses behind ``esmdiff-torch-analyze``.  ``plots`` needs matplotlib and
is imported only when a plot is drawn."""

from . import align, analysis, geo, metrics, tmscore  # noqa: F401
