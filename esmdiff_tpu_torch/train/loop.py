"""MDLM fine-tuning loop on the port.

Port of ``esmdiff_tpu/train/loop.py``: build the model from the config,
train epochs with validation every ``val_every_n_epochs``, keep the best
checkpoints by validation loss (``utils/checkpoint.py``), stop early, log
metrics to CSV, resume, and the debug modes (``fast_dev_run``,
``overfit_batches``, ``limit_batches``, ``check_nans``, ``profile_steps``).
The run's composed ``config.yaml`` is written beside it, from which
``convert/checkpoints.py`` rebuilds the model.

One device (the card unless the caller asks for the CPU).  ``build_clm``
and ``build_jlm`` build the AR nets of a config (the sampling CLI's
``--config``).  ``model.pretrained_ckpt`` fills the trunk from a
reference PyTorch file after the seeded init (``init_params``).  Not
ported yet, and raising: training the CLM/JLM tasks, multi-device
strategies and multihost, and ``model.param_dtype`` other than float32.
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
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.diffusion.mdlm import MDLM, GeneratorDraws, MDLMConfig
from esmdiff_tpu_torch.diffusion.noise import get_noise
from esmdiff_tpu_torch.models.clm import CLM, CLMConfig
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config, esm3_tiny
from esmdiff_tpu_torch.models.jlm import JLM, JLMConfig
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder, init_params as \
    init_module_params
from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager
from esmdiff_tpu_torch.utils.logging import MetricLogger, make_sink

from . import data as data_mod
from . import state as tstate
from .config import TrainConfig, save_config


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def trunk_config(cfg: TrainConfig) -> ESM3Config:
    """The trunk geometry of ``model.size`` (tiny | custom | full), with the
    structure head, as the JAX trainer builds it."""
    m = cfg.model
    if m.param_dtype != "float32":
        _not_ported(f"model.param_dtype={m.param_dtype!r} (float32 master "
                    "weights only)")
    kw = dict(dtype=m.dtype, head_type="structure",
              n_structure_heads=m.n_structure_heads,
              n_sequence_heads=m.n_sequence_heads, remat=m.remat)
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
    float32 parameters on ``device`` (see ``init_params``)."""
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


def build_task(cfg: TrainConfig, device=None):
    """task_name -> (mdlm, loss_fn(batch, draws, training=True)).  The
    batch is a dict of device tensors; a packed batch (``data.pack_len``
    > 0) carries ``segment_ids`` and takes ``MDLM.loss_packed``."""
    if cfg.task_name in ("clm", "jlm"):
        _not_ported(f"task_name={cfg.task_name!r} (the AR heads)")
    if cfg.task_name != "mdlm":
        raise ValueError(f"unknown task_name: {cfg.task_name!r} "
                         "(mdlm | clm | jlm)")
    mdlm = build_mdlm(cfg, device)
    S = data_mod.resolve_pack_segments(cfg.data)

    def mdlm_loss(batch, draws, training=True):
        if "segment_ids" in batch:
            return mdlm.loss_packed(batch, draws, max_segments=S,
                                    training=training)
        return mdlm.loss(batch, draws, training=training)

    return mdlm, mdlm_loss


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token, id and position arrays as int64,
    the rest float32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.long() if np.issubdtype(v.dtype, np.integer) else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


def train(cfg: TrainConfig, device=None) -> dict:
    t0 = time.time()
    dev = resolve_device(device)
    run_dir = Path(cfg.trainer.ckpt_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    # the composed config beside the run: checkpoints are self-describing
    save_config(cfg, run_dir / "config.yaml")
    if cfg.trainer.multihost:
        _not_ported("trainer.multihost")
    tstate.check_strategy(cfg.trainer.strategy)

    dataset = data_mod.EncodingDataset(cfg.data, training=True)
    train_split, val_split = data_mod.train_val_split(dataset, cfg.data)
    print(f"[data] {len(train_split.indices)} train / "
          f"{len(val_split.indices)} val chains from {cfg.data.path}")
    if len(val_split.indices) == 0:
        print("[data] WARNING: empty val split — val/loss will be nan and "
              "checkpoint selection has no signal (corpus too small for "
              "the 0.95/0.05 split)")

    mdlm, loss_fn = build_task(cfg, dev)
    init_params(mdlm, cfg)
    model = mdlm_modules(mdlm)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] task={cfg.task_name} {n_params/1e6:.1f}M params on {dev}")
    optimizer = tstate.make_optimizer(
        model.parameters(), lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, grad_clip=cfg.optim.grad_clip)
    state = tstate.create_train_state(model, optimizer)

    ckpt = CheckpointManager(run_dir / "ckpt",
                             save_top_k=cfg.trainer.save_top_k)
    logger = MetricLogger(run_dir / "metrics.csv")
    if cfg.trainer.logger not in ("", "csv", "none"):
        logger.add_sink(make_sink(
            cfg.trainer.logger, run_dir / "tb", run_name=cfg.trainer.run_name,
            config={"n_params": int(n_params),
                    **dataclasses.asdict(cfg.trainer)}))
    draws = GeneratorDraws(dev, seed=cfg.seed)

    if cfg.trainer.resume:
        state = ckpt.restore(cfg.trainer.resume, state)
        print(f"[resume] from {cfg.trainer.resume} at step {state.step}")

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
                batch = to_device(batch, dev)
                # profiler window: local steps [1, profile_steps] (local
                # step 0 pays the first-use costs)
                if cfg.trainer.profile_steps > 0 and local_step == 1:
                    profiler = _start_profiler(dev)
                metrics = tstate.train_step(state, loss_fn, batch, draws)
                if profiler is not None and \
                        local_step >= cfg.trainer.profile_steps:
                    _stop_profiler(profiler, run_dir / "profile", local_step)
                    profiler = None
                local_step += 1
                n_seen += 1
                if state.step % cfg.trainer.log_every_n_steps == 0 or \
                        cfg.trainer.fast_dev_run:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=state.step, epoch=epoch, split="train")
                    logger.log(m)
                    print(f"[train] step {state.step} epoch {epoch} "
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
                        to_device(batch, dev), draws)
                    losses.append(float(out["loss"]))
                    if cfg.trainer.fast_dev_run:
                        break
                val_loss = float(np.mean(losses)) if losses else float("nan")
                logger.log({"step": state.step, "epoch": epoch,
                            "split": "val", "loss": val_loss})
                print(f"[val] epoch {epoch} loss {val_loss:.4f}")
                if val_loss < best_val:
                    best_val = val_loss
                    epochs_no_improve = 0
                    ckpt.save(state, step=state.step, metric=val_loss)
                else:
                    epochs_no_improve += 1
                    if epochs_no_improve >= \
                            cfg.trainer.early_stopping_patience:
                        print(f"[early-stop] no val improvement for "
                              f"{epochs_no_improve} epochs")
                        stop = True
            if cfg.trainer.fast_dev_run:
                break
        if profiler is not None:  # the run ended inside the trace window
            _stop_profiler(profiler, run_dir / "profile", local_step)
    wall = time.time() - t0
    print(f"[done] best val/loss {best_val:.4f} in {wall:.1f}s "
          f"({state.step} steps)")
    return {"best_val_loss": best_val, "steps": state.step,
            "wall_s": wall, "ckpt_dir": str(run_dir / "ckpt")}


def _start_profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, out_dir: Path, local_step: int) -> None:
    prof.__exit__(None, None, None)
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    print(f"[profile] trace of local steps 1..{local_step} -> {out_dir}")
