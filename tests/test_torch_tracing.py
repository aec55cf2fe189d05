"""The port's tracer (``utils/tracing.py``) on the CPU: spans off and on,
parents and request ids (across ``EnsembleSampler._parallel``'s
threads), counters, the clock against ``torch.profiler``'s Chrome trace,
the sampler's plan and trunk counters and the trainer's token counters
against hand counts, and ``--profile``'s two files."""

import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from esmdiff_tpu_torch.api.generation import EnsembleSampler, GenerationConfig
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import data as data_mod
from esmdiff_tpu_torch.train import loop
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.utils import tracing

torch.set_num_threads(2)

BPTI = "data/targets/bpti"


@pytest.fixture
def traced():
    """The tracer on for the test; yields the mark to read records from."""
    tracing.enable(True)
    try:
        yield tracing.mark()
    finally:
        tracing.enable(False)


def _chrome(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    """Off, with no profiler running: no record, no ``record_function``."""
    assert not tracing.enabled()
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    since = tracing.mark()
    # one shared no-op context, whatever the name
    assert tracing.span("a", x=1) is tracing.span("b")
    assert tracing.current() is None
    with tracing.span("off.outer"):
        with tracing.span("off.inner"):
            torch.ones(4).sum()
    assert opened == []
    assert tracing.records(since)["spans"] == []


def test_a_running_profiler_turns_spans_on(tmp_path):
    """Under ``torch.profiler`` the spans record and show in its trace
    with the tracer off; once it stops they are off again."""
    assert not tracing.enabled()
    since = tracing.mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        with tracing.span("prof.outer"):
            with tracing.span("prof.inner"):
                torch.ones(4).sum()
    assert not tracing.enabled()
    assert tracing.span("after") is tracing.span("after")
    names = {e.get("name") for e in _chrome(prof, tmp_path)["traceEvents"]}
    assert {"prof.outer", "prof.inner"} <= names
    assert [s["name"] for s in tracing.records(since)["spans"]] == [
        "prof.inner", "prof.outer"]


def test_a_root_holds_the_counts_made_while_it_was_open(traced):
    tracing.count("test.root", 2)
    with tracing.span("root"):
        tracing.count("test.root", 3)
        with tracing.span("child"):
            tracing.count("test.root")
            tracing.count("test.child")
    tracing.count("test.root", 7)
    got = {s["name"]: s for s in tracing.records(traced)["spans"]}
    assert got["root"]["counters"] == {"test.root": 4, "test.child": 1}
    assert got["child"]["counters"] is None


def test_nesting_parents_and_request_ids(traced):
    with tracing.span("root.a", k=1) as a:
        with tracing.span("child") as c:
            with tracing.span("grandchild") as g:
                assert tracing.current() is g
        assert tracing.current() is a
    with tracing.span("root.b") as b:
        pass
    assert tracing.current() is None
    got = {s["name"]: s for s in tracing.records(traced)["spans"]}
    assert got["root.a"]["parent"] is None and got["root.b"]["parent"] is None
    assert got["root.a"]["request"] != got["root.b"]["request"]
    assert got["child"]["parent"] == a.id
    assert got["grandchild"]["parent"] == c.id
    assert {got[n]["request"] for n in ("root.a", "child", "grandchild")} == \
        {a.request}
    assert got["root.a"]["attrs"] == {"k": 1}
    # a parent opens before and closes after its children; records are in
    # closing order
    assert got["root.a"]["start_ns"] <= got["child"]["start_ns"] <= \
        got["grandchild"]["start_ns"] <= got["grandchild"]["end_ns"] <= \
        got["child"]["end_ns"] <= got["root.a"]["end_ns"] <= \
        got["root.b"]["start_ns"]
    assert [s["name"] for s in tracing.records(traced)["spans"]] == [
        "grandchild", "child", "root.a", "root.b"]
    assert b.request > a.request


def test_a_span_closes_on_an_exception(traced):
    with pytest.raises(ValueError):
        with tracing.span("raises"):
            raise ValueError("x")
    assert tracing.current() is None
    assert [s["name"] for s in tracing.records(traced)["spans"]] == ["raises"]


def test_within_adopts_another_threads_span(traced):
    seen = {}
    with tracing.span("main") as m:
        parent = tracing.current()

        def work():
            with tracing.within(parent):
                with tracing.span("worker") as w:
                    seen["w"] = w
            seen["after"] = tracing.current()

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    w = seen["w"]
    assert (w.parent, w.request) == (m.id, m.request)
    assert w.thread != m.thread and seen["after"] is None


def test_counters():
    since = tracing.mark()
    before = tracing.counter("test.things")
    tracing.count("test.things")
    tracing.count("test.things", 4)
    tracing.count("test.other", 0)
    assert tracing.counter("test.things") == before + 5
    assert tracing.records(since)["counters"] == {"test.things": 5}
    assert tracing.counter("test.never") == 0


def test_counters_lose_no_update_across_threads():
    """32 threads, each counting 2,000 times with the interpreter switching
    threads as often as it can: no increment is lost."""
    since = tracing.mark()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tracing.count("test.stress") for _ in range(2000)])
            for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.records(since)["counters"]["test.stress"] == 32 * 2000


def test_clock_is_the_profilers(traced, tmp_path):
    """A span's in-memory start lies within 1 ms of its range's start in
    the Chrome trace (``baseTimeNanoseconds`` + ``ts`` microseconds)."""
    with record_function("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with tracing.span(f"clock.{i}"):
                torch.ones(8).sum()
    trace = _chrome(prof, tmp_path)
    base = trace.get("baseTimeNanoseconds", 0)
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    for s in tracing.records(traced)["spans"]:
        e = ranges[s["name"]]
        assert abs(base + e["ts"] * 1e3 - s["start_ns"]) < 1e6, s["name"]
        assert abs(e["dur"] * 1e3 - (s["end_ns"] - s["start_ns"])) < 1e6


# -- the sampler's and the trainer's counters --------------------------------

def _runtime(mode):
    cfgs = checkpoints.scale_configs("tiny")
    cfgs["trunk_cfg"] = dataclasses.replace(
        cfgs["trunk_cfg"], head_type="structure" if mode == "ddpm" else "esm3",
        dtype="float32")
    return ESM3Runtime.random_init(seed=1, device="cpu", **cfgs)


@pytest.fixture(scope="module")
def ddpm_runtime():
    return _runtime("ddpm")


@pytest.mark.parametrize("residues,samples", [(70, 10), (40, 8)],
                         ids=["surplus_rows", "pack2"])
def test_sampler_counters_by_hand(ddpm_runtime, traced, residues, samples):
    """Plan "single": 10 samples run as two batches of 8 (6 surplus rows)
    at L 96 (72 real positions a row, pack 1); 8 samples of a 40-residue
    chain as one batch at L 64, two rows a device row (pack 2).  Every
    forward runs B x L positions, of which the real rows' n + 2 count."""
    seq = "A" * residues
    steps = 2
    sampler = EnsembleSampler(ddpm_runtime, plan_policy="single")
    n_iters = steps + 1                        # noise removal's argmax
    L = -(-(residues + 2) // 32) * 32
    batches = -(-samples // 8)
    sampler.ddpm_ensemble(seq, samples, num_steps=steps, seed=5)
    got = tracing.records(traced)
    c = got["counters"]
    assert c["plan.rows_asked"] == samples
    assert c["plan.rows_run"] == 8 * batches
    assert c["trunk.forwards"] == batches * n_iters
    assert c["trunk.positions_run"] == batches * n_iters * 8 * L
    assert c["trunk.positions_valid"] == n_iters * samples * (residues + 2)
    packs = [s["attrs"]["pack"] for s in got["spans"]
             if s["name"] == "sample.batch"]
    assert packs == [1 if L == 96 else 2] * batches
    names = [s["name"] for s in got["spans"]]
    assert names.count("sample.step") == batches * n_iters
    assert names.count("trunk.forward") == batches * n_iters
    assert names.count("sample.draws") == batches * steps
    assert names[-1] == "sample.request"


def test_gibbs_counts_its_forwards(traced):
    rt = _runtime("gibbs")
    sampler = EnsembleSampler(rt, plan_policy="single")
    sampler.gibbs_ensemble("MKTAYIAKQRQISFVKSHFSRQ", 8, seed=2,
                           config=GenerationConfig(num_steps=3))
    got = tracing.records(traced)
    c = got["counters"]
    assert c["trunk.forwards"] == 3
    assert c["trunk.positions_valid"] == 3 * 8 * 24
    assert c["trunk.positions_run"] == 3 * 8 * 32
    names = [s["name"] for s in got["spans"]]
    assert [names.count(n) for n in ("sample.step", "sample.draws",
                                     "sample.update", "trunk.forward")] == \
        [3, 3, 3, 3]


def test_spans_across_parallel_threads(ddpm_runtime, traced):
    """Two replicas (one a thread): every span of the request carries its
    id; each part's spans hang under the batch's span."""
    sampler = EnsembleSampler(ddpm_runtime, devices=["cpu", "cpu"])
    sampler.ddpm_ensemble("MKTAYIAKQRQISFVKSHFSRQ", 8, num_steps=1, seed=3)
    spans = tracing.records(traced)["spans"]
    root = next(s for s in spans if s["name"] == "sample.request")
    assert root["parent"] is None
    assert root["attrs"] == {"mode": "ddpm", "residues": 22, "samples": 8}
    assert {s["request"] for s in spans} == {root["request"]}
    batch = next(s for s in spans if s["name"] == "sample.batch")
    workers = [s for s in spans if s["thread"] != root["thread"]]
    assert workers
    by_id = {s["id"]: s for s in spans}
    for s in workers:
        while s["parent"] in by_id and by_id[s["parent"]]["thread"] == \
                s["thread"]:
            s = by_id[s["parent"]]
        assert s["parent"] == batch["id"]
    tops = [s for s in spans if s["name"] == "sample.to_host"]
    assert len(tops) == 2 and len({s["thread"] for s in tops}) == 2


def test_decode_and_writer_spans(ddpm_runtime, traced, tmp_path):
    from esmdiff_tpu_torch.core import protein as protein_io

    sampler = EnsembleSampler(ddpm_runtime)
    toks = np.random.RandomState(0).randint(0, 4096, (3, 20))
    prots = sampler.decode_ensemble("A" * 20, toks, decode_batch=2)
    protein_io.ensemble_to_pdb_file([p.to_protein() for p in prots],
                                    tmp_path / "x.pdb")
    got = tracing.records(traced)
    assert got["counters"]["decode.rows_valid"] == 3
    assert got["counters"]["decode.rows_run"] == 4
    by_id = {s["id"]: s for s in got["spans"]}
    names = [s["name"] for s in got["spans"]]
    assert names.count("decode.device") == names.count("decode.host") == 2
    for s in got["spans"]:
        if s["name"].startswith("decode."):
            assert by_id[s["parent"]]["name"] == "decode"
    assert names[-1] == "pdb.write"


class _Items:
    """A dataset of ready items (``EncodingDataset.load``'s form)."""

    def __init__(self, lengths):
        rng = np.random.RandomState(0)
        self.items = [{"sequence_tokens": rng.randint(4, 24, n),
                       "structure_tokens": rng.randint(0, 4096, n)}
                      for n in lengths]

    def load(self, idx, rng):
        return dict(self.items[idx])


def test_packed_train_step_counts_its_tokens(traced):
    cfg = tconfig.load_config(None, [
        "model.size=tiny", "model.dtype=float32", "data.batch_size=2",
        "data.pack_len=64", "data.max_len=64"])
    lengths = [30, 20, 25, 12, 40, 9]
    split = data_mod.Split(_Items(lengths), np.arange(len(lengths)))
    model, loss_fn = loop.build_task(cfg, "cpu")
    loop.init_task(model, cfg)
    modules = loop.task_modules(model)
    loss_fn, layout = tstate.distribute(modules, loss_fn, "ddp", 2, "cpu")
    opt = tstate.make_optimizer(modules.parameters(), lr=1e-4,
                                weight_decay=0.0, warmup_steps=1,
                                grad_clip=1.0, layout=layout)
    state = tstate.create_train_state(modules, opt, layout)
    since = tracing.mark()
    b = next(data_mod.batches(split, cfg.data, shuffle=True, seed=0))
    batch = loop.to_device(b, "cpu")
    tstate.train_step(state, loss_fn, batch, GeneratorDraws("cpu", seed=0))
    got = tracing.records(since)
    c = got["counters"]
    assert c["train.tokens_real"] == int(batch["mask"].sum())
    assert c["train.tokens_run"] == 2 * 64
    assert c["train.steps"] == 1 and c["trunk.forwards"] == 1
    by_name = {s["name"]: s for s in got["spans"]}
    step = by_name["train.step"]
    for name in ("train.forward", "train.backward", "train.update"):
        assert by_name[name]["parent"] == step["id"]
    assert by_name["trunk.forward"]["parent"] == by_name["train.forward"]["id"]
    assert by_name["train.data"]["parent"] is None
    assert by_name["train.h2d"]["parent"] is None


def test_sample_cli_profile_writes_trace_and_spans(tmp_path):
    """--profile: trace.json holds the program's ranges (sample.request
    among them), spans.json the spans and counters on the same clock; the
    tracer is off again afterwards."""
    out = tmp_path / "prof"
    sample_cli.main(["--input", BPTI, "--output", str(tmp_path / "o"),
                     "--model_scale", "tiny", "--mode", "ddpm",
                     "--num_samples", "2", "--num_steps", "2",
                     "--device", "cpu", "--profile", str(out)])
    assert not tracing.enabled()
    trace = json.loads((out / "trace.json").read_text())
    spans = json.loads((out / "spans.json").read_text())
    ranges = [e for e in trace["traceEvents"]
              if e.get("name") == "sample.request"]
    mine = [s for s in spans["spans"] if s["name"] == "sample.request"]
    assert len(ranges) == len(mine) == 1
    base = trace.get("baseTimeNanoseconds", 0)
    assert abs(base + ranges[0]["ts"] * 1e3 - mine[0]["start_ns"]) < 1e6
    assert spans["counters"]["trunk.forwards"] == 3
    assert {"sample.step", "trunk.forward", "decode", "pdb.write"} <= \
        {e.get("name") for e in trace["traceEvents"]}
