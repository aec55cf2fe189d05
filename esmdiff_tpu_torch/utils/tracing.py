"""The port's tracer: spans and counters at the system's layer boundaries,
and the ``torch.profiler`` traces that carry them.

Spans.  ``with span(name, **attrs):`` records the name, start and end,
the span it ran inside (``parent``), its request id and ``attrs``.  Spans
are on while ``enable(True)`` holds and while a ``torch.profiler`` runs
(so a profiler's trace carries the program's ranges with no flag set);
otherwise ``span`` checks a module-level flag and the profiler's state
and returns a shared no-op context (no record, no ``record_function``).
On, each span also opens ``torch.profiler.record_function(name)``, so it
shows in the running profiler's trace.  A span opened with no span open
on its thread is a root and takes a new request id; the others take their
parent's.  A root's record also holds the counters' increase while it was
open (``counters``), so the counts of a traced window are the sum over
its roots.  A worker thread adopts its caller's span with
``within(current())``.

Clock.  Times are Unix-epoch nanoseconds: ``time.perf_counter_ns``
anchored to ``time.time_ns`` when the tracer is turned on, the clock of
the Chrome trace that ``torch.profiler`` writes (an event's epoch time is
the trace's ``baseTimeNanoseconds`` + its ``ts`` in microseconds).  So a
span lines up with the card's kernels whether or not a profiler ran.

Counters.  ``count(name, n)`` adds host-side integers, on or off; counts
are made only from values already on the host, never by reading the
device.  The kernels' launches (``flash.launches``,
``small_attention.launches``, ``fused_qkv.launches``,
``fused_ffn.launches``, ``int8_mm.launches``,
``qk_norm_rotary.launches``) are counters too.

``records(since=mark())`` gives the spans and counters as plain data;
``reset()`` clears them.  ``start_profiler``/``stop_profiler`` run a
profiler with the tracer on and write ``trace.json`` and ``spans.json``
(the window's records) side by side: ``esmdiff-torch-sample --profile``
and the trainer's ``profile_steps`` use them.  The module imports torch
only to trace, so that host-only modules (``core/protein.py``) can mark
spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import sys
import threading
import time
from pathlib import Path

_on = False
_NOOP = contextlib.nullcontext()
_anchor = (time.time_ns(), time.perf_counter_ns())
_local = threading.local()
_lock = threading.Lock()
_ids = itertools.count(1)
_requests = itertools.count(1)
_spans: list = []
_counters: dict[str, int] = {}


def now_ns() -> int:
    """The tracer's clock: Unix-epoch nanoseconds (module docstring)."""
    return _anchor[0] + time.perf_counter_ns() - _anchor[1]


def enable(on: bool = True) -> None:
    """Turn spans on or off; turning them on re-anchors the clock."""
    global _on, _anchor
    if on and not _on:
        _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = bool(on)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` runs (none can before torch loads)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


def enabled() -> bool:
    """Whether spans record: turned on, or under a running profiler."""
    return _on or _profiling()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "thread",
                 "start", "end", "counters", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
            self.counters = None
        else:
            self.parent, self.request = None, next(_requests)
            with _lock:
                self.counters = dict(_counters)
        self.thread = threading.get_ident()
        stack.append(self)
        from torch.profiler import record_function

        self.start = now_ns()
        self._rf = record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        self.end = now_ns()
        self._rf = None
        if self.counters is not None:
            with _lock:
                self.counters = {k: v - self.counters.get(k, 0)
                                 for k, v in _counters.items()
                                 if v != self.counters.get(k, 0)}
        stack = _stack()
        if self in stack:
            stack.remove(self)
        _spans.append(self)
        return False

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "thread": self.thread,
                "start_ns": self.start, "end_ns": self.end,
                "attrs": self.attrs, "counters": self.counters}


def span(name: str, **attrs):
    """A context that records ``name`` as a span while the tracer is on
    (``enabled()``), and does nothing while it is off."""
    if _on or _profiling():
        return _Span(name, attrs)
    return _NOOP


def current():
    """The innermost span open on this thread, or None."""
    if not (_on or _profiling()):
        return None
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def _adopted(parent):
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def within(parent):
    """Open spans on this thread as children of ``parent`` (a span of
    another thread, from ``current()``): its request id and parent."""
    if parent is None:
        return _NOOP
    return _adopted(parent)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def mark() -> tuple:
    """A point to read ``records(since=...)`` from."""
    with _lock:
        return len(_spans), dict(_counters)


def records(since: tuple | None = None) -> dict:
    """The spans closed since ``since`` (default: all) and the counters'
    increase since then, as plain data (module docstring)."""
    n, before = since if since is not None else (0, {})
    with _lock:
        counters = {k: v - before.get(k, 0) for k, v in _counters.items()
                    if v != before.get(k, 0)}
    return {"clock": "unix_ns", "spans": [s.record() for s in _spans[n:]],
            "counters": counters}


def reset() -> None:
    """Clear the spans and the counters."""
    with _lock:
        _spans.clear()
        _counters.clear()


# -- profiler traces ---------------------------------------------------------

@dataclasses.dataclass
class Profile:
    """A running ``torch.profiler`` and the tracer's state at its start."""

    prof: "torch.profiler.profile"
    since: tuple
    was_on: bool


def start_profiler(device) -> Profile:
    """A running ``torch.profiler`` of the CPU, and of the card's kernels on
    ``cuda``, with the tracer on; end it with ``stop_profiler``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = _on
    enable(True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return Profile(prof, mark(), was_on)


def stop_profiler(profile: Profile, out_dir: Path) -> Path:
    """End ``profile``, write its Chrome trace to ``out_dir/trace.json`` and
    the tracer's records of its window to ``out_dir/spans.json`` (the same
    clock), and put the tracer back as it was."""
    profile.prof.__exit__(None, None, None)
    found = records(profile.since)
    enable(profile.was_on)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    profile.prof.export_chrome_trace(str(out_dir / "trace.json"))
    (out_dir / "spans.json").write_text(json.dumps(found))
    return out_dir / "trace.json"
