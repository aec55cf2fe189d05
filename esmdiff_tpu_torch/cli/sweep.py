"""Hyperparameter sweep: random search or successive halving over dotted
config overrides (``esmdiff-torch-sweep``).

Port of ``esmdiff_tpu/cli/sweep.py``: the same flags, the same draws for
one ``--seed`` (``random.Random``, as JAX), the same ``results.json`` and
``best.json``.  Trials run in this process through the port's ``train``
on ``--device`` (the card unless ``--device cpu``); the device's cached
memory is released between trials.  The equivalent of the reference's
Optuna TPE sweeper
(configs/hparams_search/optuna.yaml:16-40 + get_metric_value,
slm/train.py:123-128): runs training trials with sampled hyperparameters,
survives member failures (reference task_wrapper semantics,
slm/utils/utils.py:65-93), and reports the best trial on val/loss.

``--search sha`` (successive halving) is the adaptive mode: all trials get a
small epoch budget first, then only the top 1/eta by val/loss are promoted
and resumed (from their own checkpoints) with an eta-times larger budget,
repeating until one rung remains.  Bad configurations are stopped after the
first rung instead of consuming a full training budget — the role Optuna's
TPE+pruning plays in the reference on a fixed trial budget.

Space spec (yaml):
  space:
    optim.lr: {type: loguniform, low: 1e-6, high: 1e-3}
    data.batch_size: {type: choice, values: [8, 16, 32]}
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import random
from pathlib import Path

import torch
import yaml

from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.train import loop as train_loop
from esmdiff_tpu_torch.train.config import load_config


def sample_value(rng: random.Random, spec: dict):
    t = spec["type"]
    if t == "loguniform":
        lo, hi = math.log(float(spec["low"])), math.log(float(spec["high"]))
        return float(math.exp(rng.uniform(lo, hi)))
    if t == "uniform":
        return float(rng.uniform(float(spec["low"]), float(spec["high"])))
    if t == "choice":
        return rng.choice(spec["values"])
    if t == "int":
        return rng.randint(int(spec["low"]), int(spec["high"]))
    raise ValueError(f"unknown space type: {t}")


def _run_trial(base_config, overrides, ckpt_dir, max_epochs, resume=None,
               device=None):
    """One training run; returns {val_loss|None, steps, error?}.  Non-finite
    val loss is recorded as no-signal (it would otherwise win min() and emit
    non-standard JSON Infinity)."""
    overrides = list(overrides) + [f"trainer.ckpt_dir={ckpt_dir}"]
    if max_epochs is not None:
        overrides.append(f"trainer.max_epochs={max_epochs}")
    if resume:
        overrides.append(f"trainer.resume={resume}")
    cfg = load_config(base_config, overrides)
    # train() itself persists the composed config.yaml beside the run
    try:
        res = train_loop.train(cfg, device=device)
        val = res["best_val_loss"]
        if not math.isfinite(val):
            return {"val_loss": None, "steps": res["steps"],
                    "error": f"non-finite val loss ({val})"}
        return {"val_loss": val, "steps": res["steps"]}
    except Exception as e:  # survive member failures (task_wrapper)
        return {"val_loss": None, "error": str(e)}
    finally:
        gc.collect()
        if device is not None and device.type == "cuda":
            torch.cuda.empty_cache()


def _best_ckpt(ckpt_dir) -> str | None:
    index = Path(ckpt_dir) / "ckpt" / "index.json"
    if not index.exists():
        return None
    entries = json.loads(index.read_text())
    return entries[0]["path"] if entries else None


def run_random(args, trials, out_dir):
    results = []
    for trial, sampled in enumerate(trials):
        overrides = list(args.overrides) + [
            f"{k}={v}" for k, v in sampled.items()]
        print(f"[sweep] trial {trial}: {sampled}")
        r = _run_trial(args.config, overrides, out_dir / f"trial_{trial}",
                       args.max_epochs, device=args.device)
        if r.get("error"):
            print(f"[sweep] trial {trial}: {r['error']}")
        results.append({"trial": trial, "params": sampled, **r})
        (out_dir / "results.json").write_text(json.dumps(results, indent=2))
    return results


def run_sha(args, trials, out_dir):
    """Synchronous successive halving: rung k trains survivors for a total
    budget of min_epochs * eta^k epochs (resuming rung k-1 checkpoints),
    then promotes the top ceil(n/eta) by val/loss."""
    eta = args.eta
    cap = args.max_epochs if args.max_epochs is not None else 10
    results = []
    active = [{"trial": i, "params": p, "ckpt": None, "epochs": 0}
              for i, p in enumerate(trials)]
    rung = 0
    while active:
        total_epochs = min(cap, args.min_epochs * eta ** rung)
        add_epochs = total_epochs - active[0]["epochs"]
        scored = []
        for t in active:
            ckpt_dir = out_dir / f"trial_{t['trial']}" / f"rung_{rung}"
            overrides = list(args.overrides) + [
                f"{k}={v}" for k, v in t["params"].items()]
            print(f"[sweep] rung {rung} trial {t['trial']}: "
                  f"+{add_epochs} epochs (total {total_epochs}) "
                  f"{t['params']}")
            r = _run_trial(args.config, overrides, ckpt_dir, add_epochs,
                           resume=t["ckpt"], device=args.device)
            if r.get("error"):
                print(f"[sweep] rung {rung} trial {t['trial']}: "
                      f"{r['error']}")
            row = {"trial": t["trial"], "rung": rung,
                   "epochs_total": total_epochs, "params": t["params"], **r}
            results.append(row)
            (out_dir / "results.json").write_text(
                json.dumps(results, indent=2))
            if r.get("val_loss") is not None:
                scored.append((r["val_loss"], t, ckpt_dir))
        if not scored:
            print("[sweep] no surviving trials")
            break
        scored.sort(key=lambda x: x[0])
        if len(active) == 1 or total_epochs >= cap:
            break
        n_keep = max(1, math.ceil(len(scored) / eta))
        promoted = []
        for val, t, ckpt_dir in scored[:n_keep]:
            promoted.append({**t, "ckpt": _best_ckpt(ckpt_dir),
                             "epochs": total_epochs})
        dropped = [t["trial"] for _, t, _ in scored[n_keep:]]
        print(f"[sweep] rung {rung}: promoted "
              f"{[t['trial'] for t in promoted]}, stopped {dropped}")
        active = promoted
        rung += 1
    return results


def main(argv=None) -> list:
    """Run the sweep; returns the results (one row a trial, or a trial and
    rung with ``--search sha``)."""
    p = argparse.ArgumentParser(
        description="Hyperparameter search (random or successive halving; "
                    "PyTorch port).")
    p.add_argument("--config", type=str, default=None,
                   help="Base experiment yaml.")
    p.add_argument("--space", type=str, required=True,
                   help="Yaml with a 'space:' mapping of dotted keys.")
    p.add_argument("--search", type=str, default="random",
                   choices=["random", "sha"],
                   help="'sha' = successive halving: small budgets first, "
                        "promote the top 1/eta per rung.")
    p.add_argument("--n_trials", type=int, default=10)
    p.add_argument("--eta", type=int, default=2,
                   help="sha promotion factor (keep top 1/eta per rung).")
    p.add_argument("--min_epochs", type=int, default=1,
                   help="sha rung-0 epoch budget.")
    p.add_argument("--max_epochs", type=int, default=None,
                   help="Per-trial budget cap; None = the config's "
                        "trainer.max_epochs (random) / 10 (sha).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=str, default="output/sweep")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the trials; 'cpu' runs them on the "
                        "host.")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)

    space = yaml.safe_load(Path(args.space).read_text())["space"]
    rng = random.Random(args.seed)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    trials = [{k: sample_value(rng, v) for k, v in space.items()}
              for _ in range(args.n_trials)]

    if args.search == "sha":
        results = run_sha(args, trials, out_dir)
    else:
        results = run_random(args, trials, out_dir)

    ok = [r for r in results if r.get("val_loss") is not None]
    if ok:
        best = min(ok, key=lambda r: r["val_loss"])
        print(f"[sweep] best: trial {best['trial']} "
              f"val/loss {best['val_loss']:.4f} params {best['params']}")
        (out_dir / "best.json").write_text(json.dumps(best, indent=2))
    return results


if __name__ == "__main__":
    main()
