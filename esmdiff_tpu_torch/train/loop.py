"""Training loop on the port: the MDLM, CLM and JLM tasks.

Port of ``esmdiff_tpu/train/loop.py``: build the task's model from the
config (``build_task``: the MDLM of the fine-tune, or the CLM/JLM heads on
the dump's per-residue ESM3 embeddings), train epochs with validation
every ``val_every_n_epochs``, keep the best checkpoints by validation loss
(``utils/checkpoint.py``), stop early, log metrics to CSV, resume, and the
debug modes (``fast_dev_run``, ``overfit_batches``, ``limit_batches``,
``check_nans``, ``profile_steps``: the tracer on for those steps,
``trace.json`` and ``spans.json`` under ``<ckpt_dir>/profile``).  The
run's composed ``config.yaml`` is written beside it, from which
``convert/checkpoints.py`` rebuilds the model; a CLM/JLM run's
``params.pt`` holds the net's own state dict (``load_ar_params`` loads
it).

One process per card (the card unless the caller asks for the CPU):
under torchrun the group opens from its environment
(``parallel/mesh.py``) and ``trainer.strategy`` lays the model out over it
(``train/state.py::distribute``); every rank builds the same global batch
and the same draws and keeps its rows, so N ranks give the numbers of
one (the CLM and JLM losses too: a rank's cross-entropies over the
global batch's count of labels).  Rank 0 logs and writes the
checkpoints, in the one-device layout; the val loss is summed over the
ranks.  The pp strategies run the MDLM's trunk as pipeline stages
(``parallel/pp.py``) after JAX's checks (``pp.check_training``).
``trainer.multihost`` is the same launch across nodes and raises without
torchrun's environment.  ``model.pretrained_ckpt`` fills the trunk from a
reference PyTorch file after the seeded init (``init_params``);
``model.param_dtype=bfloat16`` holds the MDLM's parameters, gradients and
AdamW moments in bfloat16; ``model.remat_policy`` picks what the trunk's
remat keeps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from esmdiff_tpu_torch.convert import torch_ckpt
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import resolve_device, torch_dtype
from esmdiff_tpu_torch.diffusion.mdlm import MDLM, GeneratorDraws, MDLMConfig
from esmdiff_tpu_torch.diffusion.noise import get_noise
from esmdiff_tpu_torch.models import clm as clm_mod
from esmdiff_tpu_torch.models import jlm as jlm_mod
from esmdiff_tpu_torch.models.clm import CLM, CLMConfig
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config, esm3_tiny
from esmdiff_tpu_torch.models.jlm import JLM, JLMConfig
from esmdiff_tpu_torch.nn.layers import LayerNorm, TimestepEmbedder
from esmdiff_tpu_torch.nn.layers import init_params as init_module_params
from esmdiff_tpu_torch.parallel import mesh as pmesh
from esmdiff_tpu_torch.parallel import pp as ppp
from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager
from esmdiff_tpu_torch.utils.logging import (MetricLogger, is_main_process,
                                             make_sink)
from esmdiff_tpu_torch.utils import tracing

from . import data as data_mod
from . import state as tstate
from .config import TrainConfig, save_config


def trunk_config(cfg: TrainConfig) -> ESM3Config:
    """The trunk geometry of ``model.size`` (tiny | custom | full), with the
    structure head, as the JAX trainer builds it."""
    m = cfg.model
    torch_dtype(m.param_dtype)  # float32 | bfloat16, else KeyError
    kw = dict(dtype=m.dtype, head_type="structure",
              n_structure_heads=m.n_structure_heads,
              n_sequence_heads=m.n_sequence_heads, remat=m.remat,
              remat_policy=m.remat_policy)
    if m.size == "tiny":
        return esm3_tiny(**kw)
    if m.size == "custom":
        # explicit dims, 0 = the ESM3 default
        base = ESM3Config()
        return ESM3Config(d_model=m.d_model or base.d_model,
                          n_heads=m.n_heads or base.n_heads,
                          n_layers=m.n_layers or base.n_layers,
                          v_heads=m.v_heads or base.v_heads, **kw)
    return ESM3Config(**kw)


def build_mdlm(cfg: TrainConfig, device=None) -> MDLM:
    """The MDLM (trunk, sigma embedder, noise, config) with uninitialised
    float32 parameters on ``device`` (see ``init_params``; ``train`` casts
    them to ``model.param_dtype``)."""
    m = cfg.model
    trunk_cfg = trunk_config(cfg)
    with torch.device(resolve_device(device)):
        net = ESM3(trunk_cfg)
        se = TimestepEmbedder(trunk_cfg.d_model, dtype=trunk_cfg.torch_dtype)
    mdlm_cfg = MDLMConfig(
        time_conditioning=m.time_conditioning,
        change_of_variables=m.change_of_variables,
        importance_sampling=m.importance_sampling,
        antithetic_sampling=m.antithetic_sampling,
        noise_removal=m.noise_removal,
        structure_only=m.structure_only,
        sequence_prediction=m.sequence_prediction,
        condition_dropout=m.condition_dropout,
        condition_mask_rate=m.condition_mask_rate,
        coupled_condition_mask=m.coupled_condition_mask,
        sampling_eps=m.sampling_eps,
        T=m.T,
    )
    return MDLM(net, se, noise=get_noise(m.noise), cfg=mdlm_cfg)


def build_clm(cfg: TrainConfig, device=None,
              cond_dim: int = C.ESM3_D_MODEL) -> CLM:
    """The CLM net of ``model.clm`` (the reference's clm experiment), with
    uninitialised float32 parameters on ``device``; ``cond_dim`` is the
    width of the embeddings it is fed (flax infers it from them)."""
    m = cfg.model.clm
    with torch.device(resolve_device(device)):
        return CLM(CLMConfig(
            d_model=m.d_model, d_ff=m.d_ff, n_layers=m.n_layers,
            n_heads=m.n_heads, decoder_only=m.decoder_only,
            dec_add_input_emb=m.dec_add_input_emb, dtype=m.dtype,
            cond_dim=cond_dim))


def build_jlm(cfg: TrainConfig, device=None,
              cond_dim: int = C.ESM3_D_MODEL) -> JLM:
    """The JLM net of ``model.jlm`` (the reference's jlm experiment), as
    ``build_clm`` builds the CLM."""
    m = cfg.model.jlm
    with torch.device(resolve_device(device)):
        return JLM(JLMConfig(
            n_embd=m.n_embd, n_layers=m.n_layers, n_heads=m.n_heads,
            n_positions=m.n_positions, sep_strategy=m.sep_strategy,
            seq_loss_weight=m.seq_loss_weight,
            struct_embed_dim=m.struct_embed_dim, dtype=m.dtype,
            cond_dim=cond_dim))


def mdlm_modules(mdlm: MDLM) -> nn.ModuleDict:
    """The trainable modules, named as the JAX params tree
    (``net.*``, ``sigma_embedder.*``)."""
    return nn.ModuleDict({"net": mdlm.net,
                          "sigma_embedder": mdlm.sigma_embedder})


def init_params(mdlm: MDLM, cfg: TrainConfig) -> None:
    """Random weights from ``cfg.seed`` (flax's initialisers' scales; not
    JAX's bits), on the modules' device; then, with
    ``model.pretrained_ckpt``, the weights of that file
    (``load_pretrained``)."""
    dev = next(mdlm.net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    init_module_params(mdlm.net, gen)
    init_module_params(mdlm.sigma_embedder, gen)
    if cfg.model.pretrained_ckpt:
        load_pretrained(mdlm, cfg.model.pretrained_ckpt)


def load_pretrained(mdlm: MDLM, path: str) -> dict:
    """Fill the MDLM's trunk, and its sigma embedder when the file has
    one, from a reference PyTorch file, strictly
    (``convert/torch_ckpt.py::convert_mdlm``): a stock ESM3 file fills all
    but the new output heads, which keep their init.  (The JAX package
    converts the trunk alone, with ``strict=False``, and a stock file's
    4096-way head raises there on its shape.)"""
    report = torch_ckpt.convert_mdlm(
        mdlm.net, mdlm.sigma_embedder, torch_ckpt.load_torch_state_dict(path))
    sigma = ("from the file" if report["sigma"]
             else "seeded (none in the file)")
    print(f"[init] pretrained trunk from {path}: {report['converted']} "
          f"tensors; kept their init: "
          f"{len(report['no_source'])} (the new output heads) "
          f"{report['no_source'][:2]}; sigma embedder {sigma}")
    return report


def _clm_loss(model: CLM):
    """CLM objective: next-structure-token CE given the per-residue ESM3
    embeddings (reference model.py:289-313); labels -100 where
    mask <= 0.5.  Of a shard's rows: the sum of their cross-entropies over
    the global batch's count of labels (its part of JAX's global mean)."""

    def loss_fn(batch, draws=None, training=True, shard=None):
        mask = batch["mask"]
        labels = torch.where(mask > 0.5, batch["structure_tokens"], -100)
        out = model(inputs_embeds=batch["embeddings"], labels=labels,
                    attention_mask=mask,
                    count=None if shard is None else shard.sum)
        return out["loss"], {"nll": out["loss"]}

    return loss_fn


def _jlm_loss(model: JLM):
    """JLM objective: shift-by-one CE over both segments of the joint
    (sequence, structure) stream (reference model.py:247-287); of a
    shard's rows, over the global batch's counts, as ``_clm_loss``."""

    def loss_fn(batch, draws=None, training=True, shard=None):
        mask = batch["mask"]
        seq_labels = torch.where(mask > 0.5, batch["sequence_tokens"], -100)
        str_labels = torch.where(mask > 0.5, batch["structure_tokens"], -100)
        out = model(sequence_embeddings=batch["embeddings"],
                    structure_tokens=batch["structure_tokens"],
                    labels=torch.cat([seq_labels, str_labels], dim=1),
                    mask=mask, count=None if shard is None else shard.sum)
        return out["loss"], {"seq_nll": out["sequence_nll"],
                             "str_nll": out["structure_nll"],
                             "seq_acc": out["sequence_acc"],
                             "str_acc": out["structure_acc"]}

    return loss_fn


def build_task(cfg: TrainConfig, device=None,
               emb_dim: Optional[int] = None):
    """task_name -> (model, loss_fn(batch, draws, training=True,
    shard=None)).

    The model is the MDLM (``mdlm``), or the CLM/JLM net fed embeddings of
    width ``emb_dim`` (default ESM3's), with uninitialised float32
    parameters (``init_task``).  The batch is a dict of device tensors; a
    packed MDLM batch (``data.pack_len`` > 0) carries ``segment_ids`` and
    takes ``MDLM.loss_packed``; ``shard`` names its rows of the global
    batch (``MDLM.loss``).  The AR losses draw nothing."""
    task = cfg.task_name
    D = emb_dim if emb_dim is not None else C.ESM3_D_MODEL
    if task == "mdlm":
        mdlm = build_mdlm(cfg, device)
        S = data_mod.resolve_pack_segments(cfg.data)

        def mdlm_loss(batch, draws, training=True, shard=None):
            if "segment_ids" in batch:
                return mdlm.loss_packed(batch, draws, max_segments=S,
                                        training=training, shard=shard)
            return mdlm.loss(batch, draws, training=training, shard=shard)

        return mdlm, mdlm_loss
    if task == "clm":
        model = build_clm(cfg, device, cond_dim=D)
        return model, _clm_loss(model)
    if task == "jlm":
        model = build_jlm(cfg, device, cond_dim=D)
        return model, _jlm_loss(model)
    raise ValueError(f"unknown task_name: {task!r} (mdlm | clm | jlm)")


def fsdp_units(model) -> list:
    """The blocks ``fsdp`` makes units of: the trunk's, or the AR net's
    encoder and decoder blocks."""
    if isinstance(model, MDLM):
        return list(model.net.transformer.blocks)
    if isinstance(model, CLM):
        return [*getattr(model, "enc_blocks", ()), *model.dec_blocks]
    return list(model.blocks)


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Hold ``module``'s parameters in ``dtype``, but the LayerNorms',
    which stay float32 (flax's LayerNorm takes no ``param_dtype``)."""
    for m in module.modules():
        if isinstance(m, LayerNorm):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def task_modules(model) -> nn.Module:
    """The trainable modules of ``build_task``'s model: ``mdlm_modules``
    of an MDLM, the AR net itself."""
    return mdlm_modules(model) if isinstance(model, MDLM) else model


def init_task(model, cfg: TrainConfig) -> None:
    """Random weights from ``cfg.seed`` (``init_params`` for the MDLM, the
    AR nets' own initialisers), then the MDLM's ``model.param_dtype``."""
    if isinstance(model, MDLM):
        init_params(model, cfg)
        cast_params(mdlm_modules(model), torch_dtype(cfg.model.param_dtype))
        return
    dev = next(model.parameters()).device
    init = (clm_mod.init_params if isinstance(model, CLM)
            else jlm_mod.init_params)
    init(model, torch.Generator(device=dev).manual_seed(int(cfg.seed)))


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token, id and position arrays as int64,
    the rest float32.  A ``train.h2d`` span."""
    out = {}
    with tracing.span("train.h2d"):
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            t = t.long() if np.issubdtype(v.dtype, np.integer) else t.float()
            out[k] = t.to(device, non_blocking=True)
    return out


def train(cfg: TrainConfig, device=None) -> dict:
    """Train ``cfg`` on ``device``; under torchrun (or an open process
    group) this rank's part of ``trainer.strategy``'s layout."""
    if cfg.trainer.multihost and not (pmesh.in_torchrun()
                                      or torch.distributed.is_initialized()):
        raise RuntimeError(
            "trainer.multihost needs torchrun's environment (RANK, "
            "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): launch "
            "with torchrun --nnodes N --nproc_per_node M -m "
            "esmdiff_tpu_torch.cli.train ...")
    tstate.check_strategy(cfg.trainer.strategy)
    dev = resolve_device(pmesh.local_device(device))
    opened = pmesh.init_from_env(dev)
    try:
        return _train(cfg, dev)
    finally:
        pmesh.close(opened)


def _train(cfg: TrainConfig, dev: torch.device) -> dict:
    t0 = time.time()
    main = is_main_process()
    say = print if main else (lambda *a, **k: None)
    run_dir = Path(cfg.trainer.ckpt_dir)
    if main:
        run_dir.mkdir(parents=True, exist_ok=True)
        # the composed config beside the run: checkpoints are
        # self-describing
        save_config(cfg, run_dir / "config.yaml")
    if torch.distributed.is_initialized():
        say(f"[dist] rank {pmesh.rank()}/{pmesh.world()} on {dev}, "
            f"strategy={cfg.trainer.strategy}")
    if cfg.task_name in ("clm", "jlm"):
        # the AR heads consume the dump's per-residue ESM3 embeddings
        cfg.data.with_embeddings = True
        if cfg.data.pack_len > 0:
            raise ValueError("data.pack_len (sequence-packed training) is "
                             "MDLM-only; the AR heads use bucketed padding")

    dataset = data_mod.EncodingDataset(cfg.data, training=True)
    train_split, val_split = data_mod.train_val_split(dataset, cfg.data)
    say(f"[data] {len(train_split.indices)} train / "
        f"{len(val_split.indices)} val chains from {cfg.data.path}")
    if len(val_split.indices) == 0:
        say("[data] WARNING: empty val split — val/loss will be nan and "
            "checkpoint selection has no signal (corpus too small for "
            "the 0.95/0.05 split)")

    emb_dim = None
    if cfg.data.with_embeddings:
        probe = dataset.load(0, np.random.RandomState(0))
        if "embeddings" not in probe:
            raise ValueError(
                f"task {cfg.task_name!r} needs embeddings in the encoding "
                f"dump — regenerate with cli/dump.py --with_embeddings")
        emb_dim = int(probe["embeddings"].shape[-1])
    microbatches = 0
    if ppp.parse_pp_strategy(cfg.trainer.strategy) is not None:
        # GPipe stages of the trunk (parallel/pp.py): JAX's checks
        microbatches = ppp.check_training(
            cfg.task_name, cfg.data.pack_len, cfg.data.batch_size,
            cfg.trainer.strategy, cfg.trainer.pp_microbatches)

    task_model, loss_fn = build_task(cfg, dev, emb_dim=emb_dim)
    init_task(task_model, cfg)
    model = task_modules(task_model)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[model] task={cfg.task_name} {n_params/1e6:.1f}M params on {dev}")
    loss_fn, layout = tstate.distribute(
        model, loss_fn, cfg.trainer.strategy, cfg.data.batch_size, dev,
        blocks=fsdp_units(task_model),
        microbatches=microbatches)
    if layout.pipeline is not None:
        p = layout.pipeline
        say(f"[mesh] 2-D dp{layout.data_world} x pp{p.n_stage} "
            f"({p.n_microbatches} microbatches), rank {pmesh.rank()} holds "
            f"blocks {p.blocks}")
    optimizer = tstate.make_optimizer(
        model.parameters(), lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, grad_clip=cfg.optim.grad_clip,
        layout=layout)
    state = tstate.create_train_state(model, optimizer, layout)

    ckpt = CheckpointManager(run_dir / "ckpt",
                             save_top_k=cfg.trainer.save_top_k, writer=main)
    logger = MetricLogger(run_dir / "metrics.csv")
    if main and cfg.trainer.logger not in ("", "csv", "none"):
        logger.add_sink(make_sink(
            cfg.trainer.logger, run_dir / "tb", run_name=cfg.trainer.run_name,
            config={"n_params": int(n_params),
                    **dataclasses.asdict(cfg.trainer)}))
    draws = GeneratorDraws(dev, seed=cfg.seed)

    if cfg.trainer.resume:
        state = ckpt.restore(cfg.trainer.resume, state)
        say(f"[resume] from {cfg.trainer.resume} at step {state.step}")

    best_val = float("inf")
    epochs_no_improve = 0
    local_step = 0  # steps executed in THIS process (state.step may resume)
    stop = False
    profiler = None
    with contextlib.ExitStack() as scope:
        if cfg.trainer.check_nans:
            # raise at the first NaN an op's backward produces
            scope.enter_context(torch.autograd.set_detect_anomaly(
                True, check_nan=True))
        overfit_cache: Optional[list] = None
        for epoch in range(cfg.trainer.max_epochs):
            if stop:
                break
            # ---- train epoch ----
            if cfg.trainer.overfit_batches > 0:
                if overfit_cache is None:
                    overfit_cache = []
                    for b in data_mod.batches(train_split, cfg.data,
                                              shuffle=True, seed=cfg.seed):
                        overfit_cache.append(b)
                        if len(overfit_cache) >= cfg.trainer.overfit_batches:
                            break
                epoch_batches = overfit_cache
            else:
                epoch_batches = data_mod.batches(
                    train_split, cfg.data, shuffle=True,
                    seed=cfg.seed + epoch)

            n_seen = 0
            n_total = max(1, len(train_split.indices) // cfg.data.batch_size)
            limit = max(1, int(n_total * cfg.trainer.limit_batches))
            for batch in epoch_batches:
                if n_seen >= limit:
                    break
                batch = to_device(pmesh.shard_batch(batch, layout.shard),
                                  dev)
                # profiler window: local steps [1, profile_steps] (local
                # step 0 pays the first-use costs)
                if cfg.trainer.profile_steps > 0 and local_step == 1 \
                        and main:
                    profiler = tracing.start_profiler(dev)
                metrics = tstate.train_step(state, loss_fn, batch, draws)
                if profiler is not None and \
                        local_step >= cfg.trainer.profile_steps:
                    _stop(profiler, run_dir, local_step)
                    profiler = None
                local_step += 1
                n_seen += 1
                if state.step % cfg.trainer.log_every_n_steps == 0 or \
                        cfg.trainer.fast_dev_run:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=state.step, epoch=epoch, split="train")
                    logger.log(m)
                    say(f"[train] step {state.step} epoch {epoch} "
                        f"loss {m['loss']:.4f}")
                if cfg.trainer.fast_dev_run:
                    break

            # ---- validation ----
            if epoch % cfg.trainer.val_every_n_epochs == 0:
                losses = []
                for batch in data_mod.batches(val_split, cfg.data,
                                              shuffle=False, seed=0,
                                              drop_last=False):
                    out = tstate.eval_step(
                        lambda b, d: loss_fn(b, d, training=False),
                        to_device(pmesh.shard_batch(batch, layout.shard),
                                  dev), draws, layout)
                    losses.append(float(out["loss"]))
                    if cfg.trainer.fast_dev_run:
                        break
                val_loss = float(np.mean(losses)) if losses else float("nan")
                logger.log({"step": state.step, "epoch": epoch,
                            "split": "val", "loss": val_loss})
                say(f"[val] epoch {epoch} loss {val_loss:.4f}")
                if val_loss < best_val:
                    best_val = val_loss
                    epochs_no_improve = 0
                    ckpt.save(state, step=state.step, metric=val_loss)
                else:
                    epochs_no_improve += 1
                    if epochs_no_improve >= \
                            cfg.trainer.early_stopping_patience:
                        say(f"[early-stop] no val improvement for "
                            f"{epochs_no_improve} epochs")
                        stop = True
            if cfg.trainer.fast_dev_run:
                break
        if profiler is not None:  # the run ended inside the trace window
            _stop(profiler, run_dir, local_step)
    wall = time.time() - t0
    say(f"[done] best val/loss {best_val:.4f} in {wall:.1f}s "
        f"({state.step} steps)")
    return {"best_val_loss": best_val, "steps": state.step,
            "wall_s": wall, "ckpt_dir": str(run_dir / "ckpt")}


def _stop(profiler, run_dir: Path, local_step: int) -> None:
    out = tracing.stop_profiler(profiler, run_dir / "profile").parent
    print(f"[profile] trace of local steps 1..{local_step} -> {out}")
