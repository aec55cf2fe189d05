"""The readers of the program's spans and counters (``benchmark/program.py``
and its nine metrics) on synthetic traces whose gaps lie under known
program spans, the spans on the tracer's own clock, and with the
program's records absent (a program without the tracer, or no profiler
run): every reader then reads None."""

import pytest

from benchmark import harness, program

SAMPLING = ("useful_positions.sample", "idle_trunk.sample",
            "idle_sampler.sample", "idle_decode.sample")
TRAINING = ("useful_tokens.train", "idle_data.train", "idle_fwdbwd.train",
            "idle_update.train", "update_share.train")
# the tracer's epoch nanoseconds at the trace's 0 us
OFF_NS = 1_790_000_000_000_000_000


def reader(name):
    return harness.load_file(harness.HERE / "metrics" / f"{name}.py",
                             "test_" + name.replace(".", "_")).read


def events(ranges, kernels):
    """Chrome trace events: the benchmark's ``ranges`` (name, start us,
    end us) as the host's annotations, ``kernels`` (start, end, launch us)
    each launched by a host call of its own."""
    out = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
            "dur": b - a, "args": {}} for n, a, b in ranges]
    for i, (a, b, t) in enumerate(kernels):
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                    "ts": t, "dur": 1, "args": {"correlation": i}})
        out.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a,
                    "dur": b - a, "args": {"correlation": i}})
    return out


class FakeTracer:
    """The program's tracer as the readers see it: ``records()``."""

    def __init__(self, spans):
        self.spans = spans

    def records(self):
        return {"clock": "unix_ns", "spans": self.spans, "counters": {}}


def records(spans, counters):
    """Tracer records of ``spans`` (name, start us, end us, parent name),
    stamped on the tracer's clock; ``counters`` by root name."""
    ids = {name: i for i, (name, *_) in enumerate(spans, 1)}
    return [{"name": n, "id": ids[n], "parent": ids.get(p),
             "request": 1, "thread": 1, "attrs": {},
             "start_ns": int(a * 1000) + OFF_NS,
             "end_ns": int(b * 1000) + OFF_NS,
             "counters": counters.get(n, {}) if p is None else None}
            for n, a, b, p in spans]


@pytest.fixture
def program_tracer(monkeypatch):
    """Install a fake tracer holding the given spans."""
    def install(spans):
        monkeypatch.setattr(program, "tracer", lambda: FakeTracer(spans))
    return install


# a sampling request, decode and write: gaps of 50 us under trunk.forward,
# 10 under sample.draws, 40 under sample.update, 30 + 60 under
# decode.device, 190 under decode.host, 20 under pdb.write and 10 under no
# span; the benchmark's sample range opens and closes with its span, the
# decode range opens 2 us before and closes 2 us after its span
SAMPLE_BENCH = [("bench.sample", 0, 590), ("bench.decode", 598, 902),
                ("bench.pdb", 899, 985)]
SAMPLE_SPANS = [
    ("sample.request", 0, 590, None), ("sample.step", 100, 500,
                                       "sample.request"),
    ("trunk.forward", 110, 300, "sample.step"),
    ("sample.draws", 300, 350, "sample.step"),
    ("sample.update", 350, 480, "sample.step"),
    ("decode", 600, 900, None), ("decode.device", 600, 700, "decode"),
    ("decode.host", 700, 880, "decode"), ("pdb.write", 900, 984, None)]
SAMPLE_BUSY = [(100, 150), (200, 310), (320, 360), (400, 620), (650, 690),
               (750, 760), (950, 960), (980, 985), (995, 998)]


def sample_ctx(program_tracer, **counters):
    trace = harness.Trace(events(SAMPLE_BENCH,
                                 [(a, b, a - 1) for a, b in SAMPLE_BUSY]),
                          window_s=1e-3)
    program_tracer(records(SAMPLE_SPANS, {"sample.request": counters}))
    return {"trace": trace, "window_s": 1.0, "spans": {}}


def test_sampling_idle_by_innermost_span(program_tracer):
    ctx = sample_ctx(program_tracer)
    got = {n: reader(n)(ctx) for n in SAMPLING[1:]}
    assert got["idle_trunk.sample"] == pytest.approx(5.0)
    assert got["idle_sampler.sample"] == pytest.approx(5.0)
    assert got["idle_decode.sample"] == pytest.approx(30.0)
    # the three never count a gap twice: within the device's idle share
    idle = reader("idle_share.sample")(ctx)
    assert sum(got.values()) <= idle
    # the benchmark's own ranges stay where they were
    assert ctx["trace"].ranges == [(n[6:], a, b) for n, a, b in SAMPLE_BENCH]


def test_spans_line_up_with_the_trace_by_the_tightest_pair(program_tracer):
    """Each benchmark range bounds the clocks' offset from below and from
    above; the bounds meet where a range and its span open and close
    together, and spans of an earlier profiled window are left out."""
    stale = records([("sample.request", -9000, -8000, None)], {})
    ctx = sample_ctx(program_tracer)
    program_tracer(stale + records(SAMPLE_SPANS, {}))
    got = program.spans(ctx)
    assert [(n, a, b) for n, a, b, _ in got] == [
        (n, a, b) for n, a, b, _ in SAMPLE_SPANS]
    # alone, the decode pair's bounds lie 2 us either side of the offset
    program_tracer(records(SAMPLE_SPANS[5:], {}))
    decode = program.spans(dict(ctx, trace=harness.Trace(
        events(SAMPLE_BENCH[1:2], []), window_s=1e-3)))
    assert (decode[0][0], decode[0][1]) == ("decode", pytest.approx(600))
    # a range that closes before its span (bounds that cross): the lower
    # bound alone
    program_tracer(records([("decode", 600, 905, None)], {}))
    decode = program.spans(dict(ctx, trace=harness.Trace(
        events(SAMPLE_BENCH[1:2], []), window_s=1e-3)))
    assert decode[0][1] == pytest.approx(598)


def test_useful_positions_from_the_window_counters(program_tracer):
    ctx = sample_ctx(program_tracer, **{"trunk.positions_valid": 300,
                                        "trunk.positions_run": 400})
    assert reader("useful_positions.sample")(ctx) == pytest.approx(75.0)
    assert reader("useful_positions.sample")(
        sample_ctx(program_tracer)) is None


# three training steps' worth in one: gaps of 30 under train.data, 15
# under train.h2d, 15 under train.forward (trunk.forward inside it is the
# forward's), 10 under train.backward, 50 + 15 under train.update and 51
# under train.step alone; two kernels launched inside train.update
TRAIN_BENCH = [("bench.data", 0, 120), ("bench.step", 120, 900)]
TRAIN_SPANS = [
    ("train.data", 0, 100, None), ("train.h2d", 100, 120, None),
    ("train.step", 120, 900, None),
    ("train.forward", 130, 400, "train.step"),
    ("trunk.forward", 140, 390, "train.forward"),
    ("train.backward", 400, 700, "train.step"),
    ("train.update", 700, 890, "train.step")]
TRAIN_KERNELS = [(10, 20, 5), (50, 110, 40), (125, 145, 124),
                 (160, 420, 150), (430, 710, 405), (760, 880, 720),
                 (895, 899, 850), (950, 960, 940)]


def train_ctx(program_tracer, **counters):
    trace = harness.Trace(events(TRAIN_BENCH, TRAIN_KERNELS), window_s=1e-3)
    program_tracer(records(TRAIN_SPANS, {"train.data": counters}))
    return {"trace": trace, "window_s": 1.0, "spans": {}}


def test_training_idle_by_innermost_trainer_span(program_tracer):
    ctx = train_ctx(program_tracer)
    got = {n: reader(n)(ctx) for n in TRAINING[1:4]}
    assert got["idle_data.train"] == pytest.approx(4.5)
    assert got["idle_fwdbwd.train"] == pytest.approx(2.5)
    assert got["idle_update.train"] == pytest.approx(6.5)
    assert sum(got.values()) <= reader("idle_share.train")(ctx)


def test_update_share_counts_what_the_update_launched(program_tracer):
    device_us = sum(b - a for a, b, _ in TRAIN_KERNELS)
    assert reader("update_share.train")(train_ctx(program_tracer)) == \
        pytest.approx(100.0 * (120 + 4) / device_us)


def test_useful_tokens_from_the_window_counters(program_tracer):
    ctx = train_ctx(program_tracer, **{"train.tokens_real": 7390,
                                       "train.tokens_run": 8192})
    assert reader("useful_tokens.train")(ctx) == pytest.approx(
        100.0 * 7390 / 8192)


@pytest.mark.parametrize("name", SAMPLING + TRAINING)
def test_each_reader_is_none_without_the_programs_records(
        name, program_tracer, monkeypatch):
    """A program without the tracer, a run in which no span recorded, or
    no trace: the reader reads None."""
    read = reader(name)
    full = sample_ctx if name.endswith(".sample") else train_ctx
    ctx = full(program_tracer, **{
        "trunk.positions_valid": 1, "trunk.positions_run": 2,
        "train.tokens_real": 1, "train.tokens_run": 2})
    assert read(ctx) is not None
    assert read(dict(ctx, trace=None)) is None
    program_tracer([])
    assert read(ctx) is None
    monkeypatch.setattr(program, "tracer", lambda: None)
    assert read(ctx) is None
