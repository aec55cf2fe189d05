"""Metric logging: CSV sink + rank-0 gating.

Port of ``esmdiff_tpu/utils/logging.py``: a minimal CSV logger; extra
backends (tensorboard, wandb) subscribe via ``add_sink``.  Only rank 0 of
an initialised ``torch.distributed`` group logs.  Profiler traces and the
program's spans are ``utils/tracing.py``'s.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist


def is_main_process() -> bool:
    """Rank 0 when ``torch.distributed`` is initialised, else True."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricLogger:
    def __init__(self, csv_path: str | Path):
        self.csv_path = Path(csv_path)
        self.csv_path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames: list[str] | None = None
        self._sinks: list[Callable[[dict], None]] = []

    def add_sink(self, fn: Callable[[dict], None]):
        self._sinks.append(fn)

    def log(self, metrics: dict):
        if not is_main_process():
            return
        metrics = dict(metrics)
        metrics.setdefault("time", time.time())
        if self._fieldnames is None:
            self._fieldnames = sorted(metrics.keys())
            with open(self.csv_path, "w", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writeheader()
        row = {k: metrics.get(k, "") for k in self._fieldnames}
        with open(self.csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)
        for sink in self._sinks:
            sink(metrics)


def make_sink(backend: str, log_dir: str | Path, run_name: str = "esmdiff",
              config: dict | None = None) -> Callable[[dict], None]:
    """Experiment-tracking sinks for MetricLogger.add_sink.

    Pluggable-logger equivalent of the reference's configs/logger/ backends
    (wandb default, tensorboard, csv, ...; SURVEY.md §5 observability).
    Backends degrade gracefully: a missing package logs a warning once and
    returns a no-op sink.
    """
    if backend == "tensorboard":
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as e:  # package absent in minimal envs
            print(f"[logger] tensorboard unavailable ({e}); sink disabled")
            return lambda m: None
        writer = SummaryWriter(log_dir=str(log_dir))
        if config:
            writer.add_text("config", "\n".join(
                f"{k}: {v}" for k, v in config.items()))

        def tb_sink(metrics: dict):
            step = int(metrics.get("step", 0))
            split = metrics.get("split", "train")
            for k, v in metrics.items():
                if isinstance(v, (int, float)) and k not in (
                        "step", "epoch", "time"):
                    writer.add_scalar(f"{split}/{k}", v, step)
            writer.flush()

        return tb_sink
    if backend == "wandb":
        try:
            import wandb
        except Exception as e:
            print(f"[logger] wandb unavailable ({e}); sink disabled")
            return lambda m: None
        run = wandb.init(project=run_name, dir=str(log_dir), config=config,
                         resume="allow")

        def wandb_sink(metrics: dict):
            step = int(metrics.get("step", 0))
            split = metrics.get("split", "train")
            run.log({f"{split}/{k}": v for k, v in metrics.items()
                     if isinstance(v, (int, float))}, step=step)

        return wandb_sink
    if backend in ("", "none", "csv"):
        return lambda m: None  # CSV is MetricLogger's built-in sink
    raise ValueError(f"unknown logger backend: {backend!r}")

