"""Rank processes for the port's multi-process tests (no tests here).

``run_ranks`` starts ``world`` processes of this file, each one rank of a
gloo group opened through ``init_method="file://..."`` under the test's
temporary directory (so that parallel test workers never share a port),
runs the jobs of a JSON spec in order and writes what each returns to
``rank<r>.pt``.  A rank that fails, or a group that outlives the timeout,
fails the test: every process is killed.  The ranks import the port only,
never JAX.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spawn(argv: list, world: int, timeout: float = 240) -> list:
    """Run ``argv`` as ``world`` processes with torchrun's rank variables
    (a single process without them when ``world`` is 0); returns their
    logs.  A process that fails raises; at the timeout every process is
    killed and it raises."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    for v in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(v, None)
    ranks = [{}] if world == 0 else [
        {"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
         "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}
        for r in range(world)]
    procs = []
    try:
        for extra in ranks:
            procs.append(subprocess.Popen(
                argv, env={**env, **extra}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log}")
    return logs


def run_ranks(tmp_path, world: int, jobs: list, timeout: float = 240,
              tag: str = "ranks") -> list:
    """Run ``jobs`` on ``world`` ranks; returns each rank's results (a
    dict of job name -> value), in rank order."""
    import torch

    work = Path(tmp_path) / tag
    work.mkdir(parents=True, exist_ok=True)
    spec = {"init": f"file://{work / 'pg_init'}", "jobs": jobs,
            "out": str(work)}
    (work / "spec.json").write_text(json.dumps(spec))
    spawn([sys.executable, __file__, str(work / "spec.json")], world,
          timeout)
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- the jobs -----------------------------------------------------------------

def tiny_mdlm(params_path=None, **trunk):
    """The tiny float32 MDLM of the parity tests (the structure head),
    with the state dict at ``params_path`` when given."""
    import torch

    from esmdiff_tpu_torch.core import constants as C
    from esmdiff_tpu_torch.diffusion.mdlm import MDLM
    from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise
    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
    from esmdiff_tpu_torch.train.loop import mdlm_modules

    kw = dict(dtype="float32", head_type="structure",
              n_structure_heads=C.STRUCTURE_VOCAB_SIZE)
    kw.update(trunk)
    mdlm = MDLM(ESM3(esm3_tiny(**kw)), TimestepEmbedder(64,
                                                         dtype=torch.float32),
                noise=LogLinearNoise())
    if params_path:
        mdlm_modules(mdlm).load_state_dict(
            torch.load(params_path, weights_only=True), strict=True)
    return mdlm


def steps_job(job):
    """``job["steps"]`` train steps of the tiny MDLM under
    ``job["strategy"]`` on the global batch ``job["batch"]`` (.npz), the
    draws of each step replayed from ``job["records"]``; returns the
    losses, grad norms, the number of modules split by tensor parallelism
    and (rank 0) the final parameters; with
    ``job["ckpt"]``, the state saved there after the steps; with
    ``job["resume"]``, restored from ``job["resume_step"]`` first; with
    ``job["param_dtype"]``, the parameters held in it (``cast_params``);
    ``job["microbatches"]``: the pp strategies' M."""
    import numpy as np
    import torch

    from esmdiff_tpu_torch.diffusion.mdlm import RecordedDraws
    from esmdiff_tpu_torch.parallel import mesh as pmesh
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.loop import (cast_params, mdlm_modules,
                                              to_device)
    from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager
    from esmdiff_tpu_torch.utils.logging import is_main_process

    mdlm = tiny_mdlm(job["params"])
    modules = mdlm_modules(mdlm)
    if job.get("param_dtype"):
        cast_params(modules, getattr(torch, job["param_dtype"]))
    batch = dict(np.load(job["batch"]))
    S = job.get("max_segments")

    def loss_fn(b, d, training=True, shard=None):
        if S:
            return mdlm.loss_packed(b, d, max_segments=S, training=training,
                                    shard=shard)
        return mdlm.loss(b, d, training=training, shard=shard)

    B = len(next(iter(batch.values())))
    step_loss, layout = tstate.distribute(
        modules, loss_fn, job["strategy"], B, "cpu",
        blocks=mdlm.net.transformer.blocks,
        microbatches=job.get("microbatches", 0))
    state = tstate.create_train_state(modules, tstate.make_optimizer(
        modules.parameters(), layout=layout, **job["optim"]), layout)
    records = torch.load(job["records"], weights_only=False)
    if job.get("resume"):
        CheckpointManager(job["resume"], writer=False).restore(
            job["resume_step"], state)
        records = records[state.step:]
    local = to_device(pmesh.shard_batch(batch, layout.shard), "cpu")
    out = {"loss": [], "grad_norm": [], "rows": (
        (layout.shard.lo, layout.shard.hi) if layout.shard else None)}
    for rec in records[:job["steps"]]:
        m = tstate.train_step(state, step_loss, local,
                              RecordedDraws(records=rec))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    if job.get("ckpt"):
        CheckpointManager(job["ckpt"], writer=is_main_process()).save(
            state, step=state.step, metric=0.0)
    full = tstate.full_model_state(state)
    if is_main_process():
        out["params"] = {k: v.detach().cpu().clone() for k, v in full.items()}
    out["tp_modules"] = sum(getattr(m, "tp", None) is not None
                            for m in modules.modules())
    return out


def multihost_job(job):
    """``parallel.multihost.run_workload`` in this rank, with the state
    dict ``job["params"]`` and the draws ``job["draws"]``."""
    from esmdiff_tpu_torch.parallel import multihost

    return multihost.run_workload(job["out"], job["ckpt_dir"], "cpu",
                                  params=job["params"], draws=job["draws"])


def train_cli_job(job):
    """``esmdiff-torch-train`` in this rank with ``job["argv"]``."""
    from esmdiff_tpu_torch.cli import train as train_cli

    return train_cli.main(job["argv"])


def ring_job(job):
    """``ring_attention`` on this rank's slice of the global q, k, v of
    ``job["inputs"]``, with and without its ``lengths``; and the error of
    slicing a length one short of a multiple of the ring."""
    import torch

    from esmdiff_tpu_torch.parallel import ring

    x = torch.load(job["inputs"], weights_only=True)
    q, k, v = (ring.shard_sequence(x[n]) for n in "qkv")
    try:
        ring.shard_sequence(x["q"][:, :-1])
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"out": ring.ring_attention(q, k, v, x.get("lengths")),
            "full": ring.ring_attention(q, k, v), "raised": raised}


def tp_forward_job(job):
    """The tiny trunk of ``job["inputs"]`` with its projections split over
    every rank (``parallel/tp.py``): its structure logits on tokens and
    coordinates (geometric attention too) and the whole gradient of a
    probe of them, gathered."""
    import torch
    import torch.distributed as dist

    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.parallel import tp as ptp

    x = torch.load(job["inputs"], weights_only=True)
    trunk = ESM3(esm3_tiny(dtype="float32", head_type="structure",
                           remat=False))
    trunk.load_state_dict(x["params"])
    group = ptp.TPGroup(dist.group.WORLD)
    n_split = ptp.shard_modules(trunk, group)
    out = trunk(structure_tokens=x["structure_tokens"],
                sequence_tokens=x["sequence_tokens"],
                structure_coords=x["coords"], lengths=x["lengths"])
    (out.structure_logits * x["probe"]).sum().backward()
    return {"n_split": n_split, "logits": out.structure_logits.detach(),
            "grads": {n: ptp.gather_full(p.grad, ptp.tp_spec(p), group)
                      for n, p in trunk.named_parameters()}}


def pp_forward_job(job):
    """The trunk of ``job["inputs"]`` as the pipeline stages of
    ``job["strategy"]`` over the ranks (every data row runs the whole
    batch): the last stage's structure logits, and the gradients of the
    mean cross-entropy of the inputs' labels joined on each row's stage
    0; each rank's blocks."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh

    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.parallel import pp as ppp

    x = torch.load(job["inputs"], weights_only=True)
    trunk = ESM3(esm3_tiny(**job["trunk"]))
    trunk.load_state_dict(x["params"])
    n_stage = ppp.parse_pp_strategy(job["strategy"])[1]
    dmesh = init_device_mesh("cpu", (dist.get_world_size() // n_stage,
                                     n_stage),
                             mesh_dim_names=(ppp.DATA_AXIS, ppp.STAGE_AXIS))
    pipe = ppp.Pipeline(trunk.cfg, n_stage,
                        dmesh.get_local_rank(ppp.STAGE_AXIS),
                        job["microbatches"], dmesh.get_group(ppp.STAGE_AXIS))
    modules = pipe.prune(nn.ModuleDict({"net": trunk}))
    out = trunk(structure_tokens=x["structure_tokens"],
                sequence_tokens=x["sequence_tokens"], lengths=x["lengths"])
    loss = None
    if pipe.last:
        logits = out.structure_logits.float()
        loss = F.cross_entropy(logits.flatten(0, 1), x["labels"].flatten())
    pipe.backward(loss)
    return {"logits": None if out is None else
            out.structure_logits.detach(), "blocks": pipe.blocks,
            "grads": pipe.gather_state({
                n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in modules.named_parameters()})}


def ar_steps_job(job):
    """``len(job["batches"])`` train steps of the CLM or JLM of
    ``job["overrides"]`` (the train config's) under ``job["strategy"]``,
    from the state dict ``job["params"]``, one global batch (.npz) a step:
    the metrics of each step, (rank 0) the final parameters and the
    number of modules split by tensor parallelism."""
    import numpy as np
    import torch

    from esmdiff_tpu_torch.parallel import mesh as pmesh
    from esmdiff_tpu_torch.train import config as tconfig
    from esmdiff_tpu_torch.train import loop as tloop
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.utils.logging import is_main_process

    cfg = tconfig.load_config(None, job["overrides"])
    model, loss_fn = tloop.build_task(cfg, "cpu", emb_dim=job["emb_dim"])
    model.load_state_dict(torch.load(job["params"], weights_only=True))
    batches = [dict(np.load(b)) for b in job["batches"]]
    B = len(next(iter(batches[0].values())))
    step_loss, layout = tstate.distribute(
        model, loss_fn, job["strategy"], B, "cpu",
        blocks=tloop.fsdp_units(model))
    state = tstate.create_train_state(model, tstate.make_optimizer(
        model.parameters(), layout=layout, **job["optim"]), layout)
    out = {"metrics": []}
    for b in batches:
        m = tstate.train_step(state, step_loss, tloop.to_device(
            pmesh.shard_batch(b, layout.shard), "cpu"), None)
        out["metrics"].append({k: v.item() for k, v in m.items()})
    full = tstate.full_model_state(state)
    if is_main_process():
        out["params"] = {k: v.detach().cpu().clone() for k, v in full.items()}
    out["tp_modules"] = sum(getattr(m, "tp", None) is not None
                            for m in model.modules())
    return out


def vqvae_job(job):
    """``train_vqvae(data_parallel=True)`` on the arrays of
    ``job["corpus"]`` with the starting state dict ``job["params"]``."""
    import numpy as np
    import torch

    from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
    from esmdiff_tpu_torch.train import vqvae as tvq

    z = np.load(job["corpus"])
    res = tvq.train_vqvae(
        EncoderConfig(**job["enc"]), DecoderConfig(**job["dec"]), z["coords"],
        z["lengths"], steps=job["steps"], batch=job["batch"],
        restart_every=job["restart_every"], seed=0,
        val_idx=z["val_idx"], data_parallel=True, device="cpu", log=None,
        params=torch.load(job["params"], weights_only=True),
        augment=tvq.VQAugmentConfig() if job.get("augment") else None)
    return {"losses": res.losses, "n_live_codes": res.n_live_codes,
            "params": {k: v.detach().cpu().clone()
                       for k, v in res.params.items()}}


JOBS = {"steps": steps_job, "train_cli": train_cli_job, "ring": ring_job,
        "vqvae": vqvae_job, "tp_forward": tp_forward_job,
        "multihost": multihost_job, "pp_forward": pp_forward_job,
        "ar_steps": ar_steps_job}


def main(spec_path):
    import torch

    from esmdiff_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    opened = pmesh.init_from_env("cpu", init_method=spec["init"])
    assert opened
    out = {}
    try:
        for job in spec["jobs"]:
            out[job["name"]] = JOBS[job["kind"]](job)
    finally:
        pmesh.close(opened)
    torch.save(out, Path(spec["out"]) / f"rank{os.environ['RANK']}.pt")


if __name__ == "__main__":
    main(sys.argv[1])
