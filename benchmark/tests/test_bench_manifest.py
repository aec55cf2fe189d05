"""``BENCHMARK.json`` against the contract it is checked by, and the
harness as data: every file a cell needs is found by its name, and a cell,
configuration or per-layer metric added as new files in a copy is run
without an edit to any file that is there."""

import json
import math
import re
import shutil

import numpy as np
import pytest

from benchmark import generator, harness, run

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level():
    assert set(MAN) == KEYS
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= len(MAN["command"]) <= 32
    assert isinstance(MAN["run_seconds"], int) and \
        1 <= MAN["run_seconds"] <= 51
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("unit",):
                if key in e:
                    assert UNIT.match(e[key]), e[key]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16


def test_entries_have_only_their_keys():
    shapes = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves", "workloads"}}
    for group, keys in shapes.items():
        for e in MAN[group]:
            extra = {"workloads"} if group == "end_to_end" else set()
            assert keys <= set(e) <= keys | extra, e["name"]
    # the harness picks a cell's per-layer metrics by this list alone
    for m in MAN["per_layer"]:
        assert "workloads" in m and m["workloads"], m["name"]


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_needs():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in harness.end_to_end(MAN, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layers = harness.per_layer(MAN, w["name"])
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])
    configs = {c["name"] for c in MAN["configs"]}
    assert configs == {w["config"] for w in MAN["workloads"]}


def test_each_metric_reader_agrees_with_the_manifest():
    for m in MAN["per_layer"]:
        mod = harness.load_file(harness.HERE / "metrics" / f"{m['name']}.py",
                                "check_" + m["name"].replace(".", "_"))
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
        assert mod.read({"spans": {}, "window_s": 1.0, "trace": None}) \
            is None


def test_each_cell_has_its_files():
    for w in MAN["workloads"]:
        traffic = harness.traffic(w["traffic"])
        assert (harness.HERE / "runners" / f"{traffic['runner']}.py").exists()
        assert harness.limits(w["name"])
        cfg = harness.config(MAN, w["config"])
        assert cfg["name"] == w["config"]
        entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
        assert entry["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("w", [w for w in MAN["workloads"]],
                         ids=lambda w: w["name"])
def test_traffic_is_deterministic_with_one_shape(w):
    traffic = harness.traffic(w["traffic"])
    if traffic["runner"] == "sample":
        def draw(seed):
            return [(r["name"], r["seed"])
                    for r in generator.requests(traffic, seed, 40)]
        assert draw(2 ** 31 + 5) == draw(2 ** 31 + 5)
        assert draw(2 ** 31 + 5) != draw(7)
        buckets = {math.ceil((len(r["sequence"]) + 2) / 32)
                   for s in (1, 2 ** 31 + 5, 99)
                   for r in generator.requests(traffic, s, 40)}
        assert len(buckets) == 1
        # every seed sends the same spread of lengths
        means = [np.mean([len(r["sequence"]) for r in
                          generator.requests(traffic, s, traffic["strata"])])
                 for s in range(20)]
        assert np.ptp(means) < 0.1 * np.mean(means)
    else:
        a = generator.training_chains(traffic, 11)
        b = generator.training_chains(traffic, 11)
        assert all((x[1] == y[1]).all() for x, y in zip(a, b))
        assert max(len(x[1]) for x in a) <= traffic["max_len"]
        assert traffic["pack_len"] >= traffic["max_len"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, traffic, limits, metric reader and manifest
    entries in a copy: the harness finds and reads all of them."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads(json.dumps(MAN))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "esmdiff-1.4b.json").read_text())
    cfg["name"] = "new-model"
    (bench / "configs" / "new-model.json").write_text(json.dumps(cfg))
    traffic = harness.traffic("ddpm.L128")
    traffic["residues"] = [127, 254]
    (bench / "traffic" / "ddpm.L256.json").write_text(json.dumps(traffic))
    (bench / "limits" / "new.ddpm.L256.json").write_text(
        json.dumps({"logits_kl": 1.0}))
    (bench / "metrics" / "new_metric.sample.py").write_text(
        'UNIT = "ms"\nLAYER = "sampler loop"\nMOVES = "conf_per_s"\n\n\n'
        'def read(ctx):\n    return 2.0 * ctx["window_s"]\n')
    man["configs"].append({"name": "new-model", "source": "https://x.org",
                           "file": "benchmark/configs/new-model.json",
                           "reduced": [], "why": "a new one"})
    man["workloads"].append({"name": "new.ddpm.L256", "config": "new-model",
                             "traffic": "ddpm.L256", "chips": 4,
                             "why": "a new cell"})
    man["end_to_end"][0]["workloads"].append("new.ddpm.L256")
    man["per_layer"].append({"name": "new_metric.sample", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "sampler loop", "moves": "conf_per_s",
                             "workloads": ["new.ddpm.L256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    before = {p: p.read_bytes() for p in harness.HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}

    args = run.parse(["--workload", "new.ddpm.L256", "--seed", "3",
                      "--seconds", "1"])
    job = run.job_for(args, root=root, bench=bench)
    assert job["config"]["name"] == "new-model"
    assert job["traffic"]["residues"] == [127, 254]
    assert job["limits"] == {"logits_kl": 1.0}
    assert [m["name"] for m in job["per_layer"]] == ["new_metric.sample"]
    got = harness.read_metrics(job["per_layer"], {"window_s": 1.5}, bench)
    assert got == {"new_metric.sample": {"value": 3.0, "unit": "ms"}}
    assert run.launch_command(["--workload", "x"], 4)[-4:] == [
        "-m", "benchmark.run", "--workload", "x"]
    after = {p: p.read_bytes() for p in harness.HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
