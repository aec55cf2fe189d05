"""Host syncs of sampling and training with the tracer off and on.

    python -m esmdiff_tpu_torch.tools.sync_count [--scale tiny --device cpu]

Under ``torch.cuda.set_sync_debug_mode("warn")`` it runs one request of
each sampling shape the benchmark's cells send (ddpm at 110 and at 45
residues, gibbs at 110: 100 samples, plan "single", the VQ decode and the
PDB writer) and three packed MDLM training steps (batch 16 x 512), random
weights at the published widths, with the tracer (``utils/tracing.py``)
off and on in turns, twice each, every run after a warm-up, and prints
one JSON line: the sync warnings of each run, and the lines whose counts
differed between runs.  The tracer reads only host values, so it must
add none.  On the CPU (``--device cpu``)
there is nothing to count; the run checks the path.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import tempfile
import warnings
from pathlib import Path

import numpy as np
import torch

from esmdiff_tpu_torch.api.generation import EnsembleSampler, GenerationConfig
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
from esmdiff_tpu_torch.train import data as data_mod
from esmdiff_tpu_torch.train import loop
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.train.config import TrainConfig
from esmdiff_tpu_torch.utils import tracing

RESIDUES = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVKVKALPDAQ"
REQUESTS = (("ddpm", 110, 25), ("ddpm", 45, 25), ("gibbs", 110, 16))


def syncs(fn) -> collections.Counter:
    """The sync warnings ``fn()`` gives, by the line that raised each
    (none off a CUDA device)."""
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
    return collections.Counter(f"{w.filename}:{w.lineno}" for w in seen
                               if "synchroniz" in str(w.message))


def off_and_on(fn, repeats: int = 2) -> dict:
    """fn's sync warnings with the tracer off and on, in turns, each run
    after a warm-up: the counts of each side's runs, and the lines whose
    counts differed between any two runs."""
    runs = {"off": [], "on": []}
    for on in (False, True) * repeats:
        tracing.enable(on)
        try:
            fn()
            runs["on" if on else "off"].append(syncs(fn))
        finally:
            tracing.enable(False)
    every = [c for side in runs.values() for c in side]
    lines = set().union(*every)
    return {**{side: [sum(c.values()) for c in cs]
               for side, cs in runs.items()},
            "differ": {line: [c[line] for c in every] for line in lines
                       if len({c[line] for c in every}) > 1}}


def sampling(scale: str, device: str, samples: int, out: Path) -> dict:
    result = {}
    for mode in ("ddpm", "gibbs"):
        cfgs = checkpoints.scale_configs(scale)
        cfgs["trunk_cfg"] = dataclasses.replace(
            cfgs["trunk_cfg"],
            head_type="structure" if mode == "ddpm" else "esm3")
        rt = ESM3Runtime.random_init(seed=0, device=device, **cfgs)
        sampler = EnsembleSampler(rt, plan_policy="single")
        for kind, n, steps in REQUESTS:
            if kind != mode:
                continue
            seq = (RESIDUES * 2)[:n]

            def request():
                if mode == "ddpm":
                    toks = sampler.ddpm_ensemble(seq, samples,
                                                 num_steps=steps, seed=1)
                else:
                    toks = sampler.gibbs_ensemble(
                        seq, samples, seed=1,
                        config=GenerationConfig(num_steps=steps))
                prots = sampler.decode_ensemble(seq, toks)
                protein_io.ensemble_to_pdb_file(
                    [p.to_protein() for p in prots], out / "r.pdb")

            result[f"{mode}.{n}"] = off_and_on(request)
        del sampler, rt
    return result


class _Chains:
    """Random chains in ``EncodingDataset.load``'s form."""

    def __init__(self, n: int, max_len: int, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.items = [{"sequence_tokens": rng.randint(4, 24, L),
                       "structure_tokens": rng.randint(0, 4096, L)}
                      for L in rng.randint(40, max_len, n)]

    def load(self, idx, rng):
        return dict(self.items[idx])


def training(scale: str, device: str, batch: int, pack: int) -> dict:
    cfg = TrainConfig()
    cfg.model.size = scale
    if scale == "tiny":
        cfg.model.dtype = "float32"
    cfg.data.batch_size, cfg.data.pack_len = batch, pack
    cfg.data.max_len = pack
    model, loss_fn = loop.build_task(cfg, device)
    loop.init_task(model, cfg)
    modules = loop.task_modules(model)
    loss_fn, layout = tstate.distribute(modules, loss_fn, "ddp", batch,
                                        device)
    opt = tstate.make_optimizer(modules.parameters(), lr=1e-5,
                                weight_decay=0.0, warmup_steps=10,
                                grad_clip=1.0, layout=layout)
    state = tstate.create_train_state(modules, opt, layout)
    chains = _Chains(8 * batch, pack)
    split = data_mod.Split(chains, np.arange(len(chains.items)))
    feed = (b for epoch in itertools.count() for b in data_mod.batches(
        split, cfg.data, shuffle=True, seed=epoch))
    draws = GeneratorDraws(device, seed=0)

    def steps():
        for _ in range(3):
            b = loop.to_device(next(feed), device)
            tstate.train_step(state, loss_fn, b, draws)

    return {"train.3_steps": off_and_on(steps)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", choices=("full", "tiny"), default="full")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    small = args.scale == "tiny"
    with tempfile.TemporaryDirectory(prefix="sync_count_") as out:
        result = sampling(args.scale, args.device, 8 if small else 100,
                          Path(out))
    result.update(training(args.scale, args.device, 2 if small else 16,
                           64 if small else 512))
    if torch.cuda.is_available():
        result["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
