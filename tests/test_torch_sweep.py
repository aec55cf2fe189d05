"""``esmdiff-torch-sweep`` against the JAX package's sweep, on the CPU
(the port of tests/test_cli_surfaces.py's sweep tests): the same draws and
trial order for one seed, trial by trial; member failures and non-finite
val losses survived; successive halving's rungs and promotions; and a real
``--search sha`` run through the port's trainer whose promoted trial
resumes from its own checkpoint."""

import json
import math
import random
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from esmdiff_tpu.cli import sweep as jsweep
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu_torch.cli import sweep as tsweep
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SPACE = {"optim.lr": {"type": "loguniform", "low": 1e-7, "high": 1e-2},
         "optim.weight_decay": {"type": "uniform", "low": 0.0, "high": 0.1},
         "data.batch_size": {"type": "choice", "values": [2, 4, 8]},
         "optim.warmup_steps": {"type": "int", "low": 0, "high": 5}}


def test_sample_value_draws_equal_jax():
    for seed in range(4):
        jr, tr = random.Random(seed), random.Random(seed)
        for _ in range(20):
            for spec in SPACE.values():
                assert tsweep.sample_value(tr, spec) == \
                    jsweep.sample_value(jr, spec)
    with pytest.raises(ValueError, match="unknown space type"):
        tsweep.sample_value(random.Random(0), {"type": "nope"})


def _fake_train(seen):
    """A trainer whose val loss is the lr's log-distance from 1e-5, less
    0.2 an epoch when resumed; it writes a checkpoint index to resume
    from.  Trial 0's first call fails, a 0.01 weight decay gives nan."""

    def train(cfg, device=None):
        resumed = bool(cfg.trainer.resume)
        seen.append({"lr": cfg.optim.lr, "epochs": cfg.trainer.max_epochs,
                     "resume": cfg.trainer.resume,
                     "batch_size": cfg.data.batch_size})
        if len(seen) == 1:
            raise RuntimeError("boom (injected trial failure)")
        loss = abs(math.log10(cfg.optim.lr) - math.log10(1e-5)) \
            - (0.2 * cfg.trainer.max_epochs if resumed else 0.0)
        if cfg.optim.weight_decay < 0.01:
            loss = float("nan")
        ck = Path(cfg.trainer.ckpt_dir) / "ckpt"
        ck.mkdir(parents=True, exist_ok=True)
        (ck / "index.json").write_text(json.dumps(
            [{"path": str(ck / "best"), "metric": loss}]))
        return {"best_val_loss": loss, "steps": cfg.trainer.max_epochs,
                "wall_s": 0.0, "ckpt_dir": str(ck)}

    return train


@pytest.mark.parametrize("search", ["random", "sha"])
def test_sweeps_equal_jax_trial_by_trial(tmp_path, monkeypatch, search):
    """Both packages' sweeps with the same fake trainer and seed: the same
    trials, params, rungs, resumes, errors (a failed member, a non-finite
    val loss) and best trial; results.json and best.json equal."""
    space = tmp_path / "space.yaml"
    space.write_text(yaml.safe_dump({"space": SPACE}))
    runs = {}
    for name, sweep, loop in (("jax", jsweep, jloop), ("port", tsweep, tloop)):
        seen = []
        train = _fake_train(seen)
        monkeypatch.setattr(loop, "train",
                            train if name == "port"
                            else lambda cfg, t=train: t(cfg))
        out = tmp_path / name
        argv = ["--config", str(ROOT / "configs/mdlm_smoke.yaml"),
                "--space", str(space), "--n_trials", "6", "--search",
                search, "--eta", "2", "--max_epochs", "4", "--seed", "3",
                "--output", str(out), "data.path=/nonexistent-unused"]
        if name == "port":
            argv.insert(0, "--device=cpu")
        sweep.main(argv)
        runs[name] = (seen, json.loads((out / "results.json").read_text()),
                      json.loads((out / "best.json").read_text()))
    (jseen, jres, jbest), (tseen, tres, tbest) = runs["jax"], runs["port"]

    def strip(rows):  # the output directories differ by name only
        return json.loads(json.dumps(rows).replace(str(tmp_path / "jax"),
                                                   "OUT").replace(
            str(tmp_path / "port"), "OUT"))

    assert strip(tseen) == strip(jseen)
    assert tres == jres and tbest == jbest
    assert tres[0]["val_loss"] is None and "boom" in tres[0]["error"]
    if any(r["params"]["optim.weight_decay"] < 0.01 for r in tres):
        assert any("non-finite" in r.get("error", "") for r in tres)
    if search == "sha":
        assert sorted({r["rung"] for r in tres}) == [0, 1, 2]
        assert sum(1 for s in tseen if s["resume"]) >= 2


def test_real_sha_sweep_resumes_the_promoted_trial(tmp_path):
    """--search sha through the port's trainer (tiny trunk, 2 trials over
    optim.lr, eta 2, min_epochs 1): rung 0 trains both one epoch, the
    better is promoted and resumes from its own best checkpoint with its
    step count continued; best.json names it."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.RandomState(0)
    for i in range(24):
        L = rng.randint(20, 40)
        np.savez(corpus / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32))
    space = tmp_path / "space.yaml"
    space.write_text(yaml.safe_dump({"space": {"optim.lr": {
        "type": "loguniform", "low": 1e-4, "high": 1e-2}}}))
    out = tmp_path / "sweep"
    results = tsweep.main([
        "--device", "cpu", "--config", str(ROOT / "configs/mdlm_smoke.yaml"),
        "--space", str(space), "--n_trials", "2", "--search", "sha",
        "--eta", "2", "--min_epochs", "1", "--max_epochs", "2",
        "--output", str(out), f"data.path={corpus}",
        "trainer.print_config=false", "model.param_dtype=bfloat16"])
    rung0 = [r for r in results if r["rung"] == 0]
    rung1 = [r for r in results if r["rung"] == 1]
    assert len(rung0) == 2 and len(rung1) == 1
    assert all(math.isfinite(r["val_loss"]) for r in results)
    winner = min(rung0, key=lambda r: r["val_loss"])
    assert rung1[0]["trial"] == winner["trial"]
    # resumed from its rung-0 checkpoint: the step count continues
    assert rung1[0]["steps"] == 2 * winner["steps"]
    best = json.loads((out / "best.json").read_text())
    assert best["trial"] == min(results, key=lambda r: r["val_loss"])["trial"]
    config = yaml.safe_load((out / f"trial_{winner['trial']}" / "rung_1"
                             / "config.yaml").read_text())
    assert "rung_0" in config["trainer"]["resume"]
    assert config["model"]["param_dtype"] == "bfloat16"
