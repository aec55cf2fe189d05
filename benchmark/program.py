"""What the program's own tracer (``esmdiff_tpu_torch/utils/tracing.py``)
gives the per-layer metrics, read one way for all of them.

The tracer's spans record while a ``torch.profiler`` runs, so in a
``--trace 1`` run they cover the traced request or steps (``harness.traced``)
and nothing else: set-up, the warm-up and the measured window run with
them off, as every ``--trace 0`` run does throughout.  The readers take
the records from the tracer itself (``tracing.records()``) after the
traced run.  A program without the tracer (an older commit), or a run
with no profiler, has no records, and every reader here returns None.

Clock.  The tracer stamps spans in Unix-epoch nanoseconds; the trace's
``harness.Trace`` keeps microseconds from a base it does not keep.  Each
benchmark range of the trace (``bench.sample``, ``bench.decode``,
``bench.pdb``, ``bench.step``, ``bench.data``) wraps one program call whose
first act opens a root span and whose last closes it (``PAIRS``), so
the range opens a few microseconds before its span and closes a few
after: each pair bounds the offset between the two clocks from below and
from above, and the offset is the middle of the tightest bounds (the
lower bound alone where they cross).

Idle time: each gap between the card's busy intervals in the traced
window is put down to the innermost program span (of those a reader
considers) open on the host when the gap began: the latest-opened span
that contains its start.  A gap goes to one span or to none, so no gap
counts twice, and gaps before the first and after the last busy interval
go to none.

Counts: a root span's record holds the counters' increase while it was
open, so a counter's count over the traced window is the sum over the
window's roots.
"""

from __future__ import annotations

import bisect
import collections
import heapq

# a benchmark range of the trace -> the program's span that opens first
# inside it
PAIRS = (("sample", "sample.request"), ("decode", "decode"),
         ("pdb", "pdb.write"), ("step", "train.step"), ("data", "train.data"))


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from esmdiff_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def spans(ctx: dict):
    """The program's spans of the traced window on the trace's clock:
    ``[(name, start us, end us, record)]``, or None where there are none
    or nothing pairs them with the trace's ranges."""
    tr, t = ctx.get("trace"), tracer()
    if tr is None or t is None or not tr.ranges:
        return None
    recs = t.records()["spans"]
    low, high = [], []
    for bench, name in PAIRS:
        marks = sorted((a, b) for n, a, b in tr.ranges if n == bench)
        mine = sorted((s["start_ns"], s["end_ns"]) for s in recs
                      if s["name"] == name)
        if marks and len(mine) >= len(marks):
            for (a, b), (s, e) in zip(marks, mine[-len(marks):]):
                low.append(round(a * 1e3) - s)      # whole ns: epoch ns
                high.append(round(b * 1e3) - e)
    if not low:
        return None
    off = max(low)
    if min(high) >= off:
        off = (off + min(high)) // 2
    lo = min(a for _, a, _ in tr.ranges)
    hi = max(b for _, _, b in tr.ranges)
    out = [(s["name"], (s["start_ns"] + off) * 1e-3,
            (s["end_ns"] + off) * 1e-3, s) for s in recs]
    return [x for x in out if lo <= x[1] <= hi] or None


def counter_share(ctx: dict, part: str, whole: str):
    """100 x counter ``part``'s count over ``whole``'s in the traced
    window (the sum over its root spans)."""
    found = spans(ctx)
    if found is None:
        return None
    c = collections.Counter()
    for _, _, _, s in found:
        if s["parent"] is None and s.get("counters"):
            c.update(s["counters"])
    if not c.get(whole):
        return None
    return 100.0 * c.get(part, 0) / c[whole]


def idle_by_span(trace, ranges, considered=lambda name: True):
    """Idle seconds of ``trace``'s gaps by the innermost considered range
    of ``ranges`` ((name, start us, end us, ...)) open when each began
    (module docstring); None keys the rest."""
    ranges = sorted((r[1], r[2], r[0]) for r in ranges if considered(r[0]))
    busy = trace.busy_intervals()
    gaps = sorted((b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])
                  if b1[0] > b0[1])
    out = collections.Counter()
    open_, i = [], 0                 # heap of (-start, end, name)
    for a, b in gaps:
        while i < len(ranges) and ranges[i][0] <= a:
            heapq.heappush(open_, (-ranges[i][0], ranges[i][1],
                                   ranges[i][2]))
            i += 1
        while open_ and open_[0][1] < a:
            heapq.heappop(open_)
        out[open_[0][2] if open_ else None] += (b - a) * 1e-6
    return out


def idle_share(ctx: dict, pick, considered=lambda name: True):
    """100 x the idle seconds put down to the spans whose name ``pick``
    takes, over the traced window's seconds."""
    found = spans(ctx)
    tr = ctx.get("trace")
    if found is None or tr.window_s <= 0:
        return None
    idle = idle_by_span(tr, found, considered)
    return 100.0 * sum(s for n, s in idle.items()
                       if n is not None and pick(n)) / tr.window_s


def launched_share(ctx: dict, span: str):
    """100 x the device seconds of the work launched inside the program's
    ``span`` spans, over all device seconds of the traced window."""
    found = spans(ctx)
    tr = ctx.get("trace")
    if found is None or tr.device_s() <= 0:
        return None
    ranges = sorted((a, b) for n, a, b, _ in found if n == span)
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    inside = 0.0
    for _, a, b, t in tr.kernels:
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= ranges[j][1]:
            inside += b - a
    return 100.0 * inside * 1e-6 / tr.device_s()


def sampling(name: str) -> bool:
    """The sampler loop's spans: ``sample.*``."""
    return name.startswith("sample.")


def decoding(name: str) -> bool:
    """The decoder's and the writer's spans."""
    return name == "decode" or name.startswith("decode.") \
        or name == "pdb.write"


def training(name: str) -> bool:
    """The trainer's spans (the trunk's, inside ``train.forward``, left
    out, so that a gap there is the forward's)."""
    return name.startswith("train.")
