"""Multi-process dryrun: real ``torch.distributed`` ranks.

Port of ``esmdiff_tpu/parallel/multihost.py``.  The production multihost
path (``trainer.multihost``: torchrun across nodes, one process per card)
is exercised on one host: N processes form one group and run the same
workload as the JAX package's: 2 ``zero2`` train steps of the tiny MDLM
on a seeded global batch of 16 rows (each rank keeping its rows), a
checkpoint written across the process boundary (the one-device layout,
the optimizer state consolidated on rank 0), a restore of it into a
fresh state on every rank, then 1 more step.  The losses must equal a
single-process run of the identical workload: the process topology is a
layout choice, not a math change.

    torchrun --nproc_per_node 2 -m esmdiff_tpu_torch.parallel.multihost \\
        --out /tmp/mh.json --ckpt_dir /tmp/mh_ckpt --device cpu
    python -m esmdiff_tpu_torch.parallel.multihost --out ... --ckpt_dir ...

``run_workload``'s ``params`` (a state dict of the tiny MDLM) and
``draws`` (a list of ``RecordedDraws`` records, one a step) replace the
seeded init and the seeded draws, as the parity tests carry JAX's over.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

GLOBAL_BATCH, LENGTH = 16, 16


def workload_batch() -> dict:
    """The JAX workload's global batch (its 8-device run: 2 rows a
    device)."""
    rng = np.random.RandomState(0)
    return {
        "structure_tokens": rng.randint(0, 4096, (GLOBAL_BATCH, LENGTH))
        .astype(np.int32),
        "sequence_tokens": np.full((GLOBAL_BATCH, LENGTH), 5, np.int32),
        "mask": np.ones((GLOBAL_BATCH, LENGTH), np.float32),
    }


def run_workload(out_file: str, ckpt_dir: str, device="cpu",
                 params: Optional[str] = None,
                 draws: Optional[str] = None) -> list[float]:
    """The shared workload; returns its three losses (rank 0 writes them
    to ``out_file`` with the world size)."""
    from esmdiff_tpu_torch.core import constants as C
    from esmdiff_tpu_torch.diffusion.mdlm import (MDLM, GeneratorDraws,
                                                  RecordedDraws)
    from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise
    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.nn.layers import TimestepEmbedder, init_params
    from esmdiff_tpu_torch.parallel import mesh as pmesh
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.loop import mdlm_modules, to_device
    from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager
    from esmdiff_tpu_torch.utils.logging import is_main_process

    dev = torch.device(device)

    def build():
        with torch.device(dev):
            mdlm = MDLM(ESM3(esm3_tiny(
                dtype="float32", head_type="structure",
                n_structure_heads=C.STRUCTURE_VOCAB_SIZE)),
                TimestepEmbedder(64, dtype=torch.float32),
                noise=LogLinearNoise())
        modules = mdlm_modules(mdlm)
        if params:
            modules.load_state_dict(torch.load(params, weights_only=True))
        else:
            init_params(modules, torch.Generator(dev).manual_seed(0))
        loss, layout = tstate.distribute(
            modules, lambda b, d, training=True, shard=None: mdlm.loss(
                b, d, training=training, shard=shard),
            "zero2", GLOBAL_BATCH, dev, blocks=mdlm.net.transformer.blocks)
        state = tstate.create_train_state(modules, tstate.make_optimizer(
            modules.parameters(), lr=1e-4, grad_clip=1.0, layout=layout),
            layout)
        return state, loss, layout

    records = (torch.load(draws, weights_only=False) if draws else None)
    generator = GeneratorDraws(dev, seed=1)

    def step_draws(i):
        return (RecordedDraws(records=records[i], device=dev)
                if records is not None else generator)

    state, loss_fn, layout = build()
    batch = to_device(pmesh.shard_batch(workload_batch(), layout.shard), dev)
    losses = []
    for i in range(2):
        losses.append(tstate.train_step(state, loss_fn, batch,
                                        step_draws(i))["loss"].item())
    # the checkpoint across the process boundary: every rank gathers, rank
    # 0 writes (save returns once it has); every rank restores it into a
    # fresh state
    ckpt = CheckpointManager(Path(ckpt_dir).absolute(),
                             writer=is_main_process())
    ckpt.save(state, step=state.step, metric=losses[-1])
    restored, loss_fn, _ = build()
    ckpt.restore(Path(ckpt_dir).absolute() / f"step_{state.step}", restored)
    assert restored.step == 2
    losses.append(tstate.train_step(restored, loss_fn, batch,
                                    step_draws(2))["loss"].item())
    if is_main_process():
        Path(out_file).write_text(json.dumps({
            "losses": losses, "n_processes": pmesh.world()}))
    return losses


def main(argv=None):
    p = argparse.ArgumentParser(description="Multi-process dryrun worker.")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from esmdiff_tpu_torch.device import resolve_device
    from esmdiff_tpu_torch.parallel import mesh as pmesh

    dev = resolve_device(pmesh.local_device(args.device))
    opened = pmesh.init_from_env(dev)
    try:
        if opened:
            print(f"[multihost] process {pmesh.rank()}/{pmesh.world()} on "
                  f"{dev}")
        return run_workload(args.out, args.ckpt_dir, dev)
    finally:
        pmesh.close(opened)


if __name__ == "__main__":
    main()
