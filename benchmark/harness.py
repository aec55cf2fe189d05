"""What every cell's run shares: the manifest and its files, the seeds,
the host spans, the traced window and its reading, the checks, and the
result line.

Spans are the benchmark's own: ``Spans.span(name)`` times a call into a
layer on the host clock and, while the profiler runs, marks it as a
``bench.<name>`` range in the trace.  ``Trace`` reads the profiler's
Chrome trace: every kernel, copy and fill on the card, the host call that
launched it (by correlation id) and the benchmark's ranges.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "esmdiff_tpu")
# kernel-name patterns of each kind of device work, first match wins
# (a frozen copy of the port's tools/train_anatomy.py KINDS)
KINDS = (("flash kernel", ("esmdiff_attn", "attention_short",
                           "attention_long", "attention_stream")),
         ("products", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
         ("optimizer", ("multi_tensor", "foreach", "adam")),
         ("copies and casts", ("copy", "memcpy")),
         ("reductions", ("reduce", "softmax", "layer_norm", "norm")),
         ("elementwise", ("elementwise",)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kind(name: str) -> str:
    low = name.lower()
    return next((k for k, pats in KINDS if any(p in low for p in pats)),
                "other")


# -- the manifest and the files it names --------------------------------------

def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    entry = next(c for c in man["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, bench: Path = HERE) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, bench: Path = HERE) -> dict:
    return json.loads((bench / "limits" / f"{cell_name}.json").read_text())


def load_file(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(name: str, bench: Path = HERE):
    return load_file(bench / "runners" / f"{name}.py", f"bench_runner_{name}")


def per_layer(man: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those whose ``workloads``
    list it."""
    return [m for m in man["per_layer"] if cell_name in m["workloads"]]


def end_to_end(man: dict, cell_name: str) -> list[dict]:
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def read_metrics(metrics: list[dict], ctx: dict, bench: Path = HERE) -> dict:
    """Each per-layer metric's reader (``metrics/<name>.py``) on ``ctx``;
    a reader that finds nothing returns None and its metric is left out."""
    out = {}
    for m in metrics:
        mod = load_file(bench / "metrics" / f"{m['name']}.py",
                        "bench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# -- seeds, clock, spans --------------------------------------------------------

def seeds(seed: int, n: int) -> list[int]:
    """``n`` independent 31-bit seeds from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed))
            .generate_state(n, np.uint32) >> np.uint32(1)]


class Spans:
    """Host seconds by span name; each span also a ``bench.<name>`` range
    for the profiler (free while it does not run)."""

    def __init__(self):
        self.seconds = collections.Counter()

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.seconds[name] += time.perf_counter() - t0


class Phases:
    """Host seconds of set-up's phases, each from the end of the last (the
    first from the process's start), with the device synchronised: a line
    for the record, not a metric."""

    def __init__(self, t_start: float, sync):
        self.t, self.sync, self.seconds = t_start, sync, []

    def __call__(self, name: str) -> None:
        self.sync()
        now = time.monotonic()
        self.seconds.append((name, now - self.t))
        self.t = now

    def line(self) -> str:
        return "setup phases: " + ", ".join(
            f"{name} {s:.2f} s" for name, s in self.seconds)


class TrunkHooks:
    """Forward hooks on a module: count its forwards, mark each as the
    ``bench.trunk`` range, and hand each call to ``on_start(args, kwargs)``
    and ``on_call(args, kwargs, output)`` when set."""

    def __init__(self, module):
        import torch

        self.forwards = 0
        self.on_start = self.on_call = None
        self._ranges = []
        self._rf = torch.profiler.record_function
        self.handles = [
            module.register_forward_pre_hook(self._pre, with_kwargs=True),
            module.register_forward_hook(self._post, with_kwargs=True)]

    def _pre(self, module, args, kwargs):
        if self.on_start is not None:
            self.on_start(args, kwargs)
        rf = self._rf("bench.trunk")
        rf.__enter__()
        self._ranges.append(rf)

    def _post(self, module, args, kwargs, output):
        self._ranges.pop().__exit__(None, None, None)
        if self.on_call is not None:
            self.on_call(args, kwargs, output)
        self.forwards += 1

    def remove(self):
        for h in self.handles:
            h.remove()


# -- the traced window ----------------------------------------------------------

class Trace:
    """The device's work in a traced window, read from the profiler."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        launch = {}
        self.ranges = []
        self.kernels = []               # (name, start us, end us, launch us)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = e.get("args", {}).get("correlation")
            if corr is not None and cat not in DEVICE_CATS:
                launch[corr] = e["ts"]      # the host call that launched it
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                self.ranges.append((e["name"][6:], e["ts"],
                                    e["ts"] + e.get("dur", 0)))
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                corr = e.get("args", {}).get("correlation")
                self.kernels.append((e["name"], e["ts"], e["ts"] + e["dur"],
                                     launch.get(corr)))
        self.kernels.sort(key=lambda k: k[1])

    def busy_intervals(self) -> list:
        merged = []
        for _, a, b, _ in self.kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_s(self, pick=lambda name: True) -> float:
        return sum(b - a for n, a, b, _ in self.kernels if pick(n)) * 1e-6

    def launched_in(self, span: str, inside: bool = True) -> float:
        """Device seconds of the work launched inside (or outside) the
        ``span`` ranges, of all the work launched inside any range."""
        ranges = sorted((a, b) for n, a, b in self.ranges if n == span)
        starts = [a for a, _ in ranges]
        total = 0.0
        for _, a, b, t in self.kernels:
            if t is None:
                continue
            i = np.searchsorted(starts, t, side="right") - 1
            hit = i >= 0 and t <= ranges[i][1]
            if hit == inside:
                total += b - a
        return total * 1e-6

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, a, b, _ in self.kernels:
            by[name[:160]] += (b - a) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between the device's busy intervals, each named
        by the innermost benchmark range open on the host when it began."""
        busy = self.busy_intervals()
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])
                if b1[0] > b0[1]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            open_ = [(e - s, name) for name, s, e in self.ranges
                     if s <= a <= e]
            out.append([min(open_)[1] if open_ else "none", (b - a) * 1e-6])
        return out


def traced(fn, sync):
    """Run ``fn`` under the profiler -> (Trace, fn's result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    del prof
    torch.cuda.synchronize()
    return Trace(events, window), result


# -- the run's record -------------------------------------------------------------

def card() -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(numbers: dict, lims: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when every number is at or
    under its limit (a number that could not be read is not correct)."""
    checks, ok = {}, True
    for name, limit in lims.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": None if v is None else float(v),
                        "limit": limit}
    return ok, checks


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)


def result_line(job: dict, result: dict, device: dict) -> dict:
    """The result line of a runner's run: correct when every number is
    within its limit and nothing failed; ``checks`` last."""
    correct, checks = judge(result["numbers"], job["limits"])
    device = dict(device, memory_peak_bytes=result["peak_bytes"])
    if job["trace"]:
        device.update(result.get("trace_device", {}))
    line = {"correct": correct and result["failed"] == 0,
            "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return line
