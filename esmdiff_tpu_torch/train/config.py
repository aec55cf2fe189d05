"""Training configuration: dataclasses + YAML overrides.

The port's own copy of ``esmdiff_tpu/train/config.py`` (the port imports
nothing of the JAX package): the same dataclasses, fields and defaults, so
a ``config.yaml`` written beside a run by either package loads in the
other.  ``load_config`` composes defaults <- experiment yaml <- dotted CLI
overrides.  One field is the port's own: ``model.remat_policy`` (JAX sets
it on the trunk's config only); ``save_config`` leaves it out at its
default, so such a run's ``config.yaml`` still loads in the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import yaml

from .data import DataConfig


@dataclasses.dataclass
class CLMModelConfig:
    """CLM net geometry (reference configs/experiment/clm.yaml:36-44)."""

    d_model: int = 1280
    d_ff: int = 2048
    n_layers: int = 12
    n_heads: int = 16
    decoder_only: bool = False
    dec_add_input_emb: bool = True   # clm.yaml:39
    dtype: str = "bfloat16"


@dataclasses.dataclass
class JLMModelConfig:
    """JLM net geometry (reference configs/experiment/jlm.yaml:33-42)."""

    n_embd: int = 1280
    n_layers: int = 48
    n_heads: int = 16
    n_positions: int = 2048
    sep_strategy: str = "position"   # jlm.yaml:42
    seq_loss_weight: float = 1.0
    struct_embed_dim: int = 1280     # VQ-decoder embedding width
    dtype: str = "bfloat16"


@dataclasses.dataclass
class ModelConfig:
    # trunk
    size: str = "full"            # full | tiny | custom
    # custom trunk geometry (size="custom"; 0 = ESM3 default) — the
    # mid-scale quality-campaign regime between tiny tests and the 1.4B full
    d_model: int = 0
    n_heads: int = 0
    n_layers: int = 0
    v_heads: int = 0
    # reference torch file filling the trunk (train/loop.load_pretrained)
    pretrained_ckpt: Optional[str] = None
    n_structure_heads: int = 4101
    n_sequence_heads: int = 0
    dtype: str = "bfloat16"
    # float32 = reference parity (fp32 master weights, bf16 compute);
    # bfloat16 = bf16 trunk, sigma embedder and heads, with bf16 gradients
    # and AdamW moments (the MDLM task; the AR nets keep float32, as in JAX)
    param_dtype: str = "float32"
    # rematerialise blocks n_layers_geom.. in the backward
    # (torch.utils.checkpoint); remat_policy "nothing" recomputes whole
    # blocks, "dots" keeps the products' outputs (JAX's dots_saveable)
    remat: bool = True
    remat_policy: str = "nothing"
    # mdlm flags (configs/experiment/mdlm.yaml:30-52)
    noise: str = "loglinear"
    time_conditioning: bool = True
    sampling_eps: float = 1e-3
    noise_removal: bool = True
    T: int = 0
    change_of_variables: bool = False
    importance_sampling: bool = False
    antithetic_sampling: bool = True
    sequence_prediction: bool = False
    condition_dropout: float = 0.0
    condition_mask_rate: float = 0.0
    coupled_condition_mask: bool = False
    structure_only: bool = False
    # AR heads (selected by TrainConfig.task_name = clm | jlm)
    clm: CLMModelConfig = dataclasses.field(default_factory=CLMModelConfig)
    jlm: JLMModelConfig = dataclasses.field(default_factory=JLMModelConfig)


@dataclasses.dataclass
class OptimConfig:
    lr: float = 1e-5              # mdlm.yaml:30
    weight_decay: float = 0.01
    warmup_steps: int = 0
    grad_clip: Optional[float] = None


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 100         # mdlm.yaml:61-63
    log_every_n_steps: int = 10
    val_every_n_epochs: int = 1
    early_stopping_patience: int = 100
    ckpt_dir: str = "output/ckpt"
    save_top_k: int = 1
    resume: Optional[str] = None
    # debug modes (reference configs/debug/*)
    fast_dev_run: bool = False    # 1 train + 1 val step (debug/fdr.yaml)
    overfit_batches: int = 0      # repeat N batches (debug/overfit.yaml)
    limit_batches: float = 1.0    # fraction of batches (debug/limit.yaml)
    check_nans: bool = False      # torch.autograd.set_detect_anomaly
    # Lightning profiler analogue (reference configs/debug/profiler.yaml):
    # >0 = capture a torch.profiler trace of that many train steps to
    # <ckpt_dir>/profile, with the tracer on: trace.json (a Chrome trace
    # with the program's spans) and spans.json (the spans and counters)
    profile_steps: int = 0
    # multi-host launch: torchrun across nodes (raises without its
    # environment)
    multihost: bool = False
    # sharding strategy over torchrun's ranks (reference
    # configs/trainer/: ddp.yaml = ddp, deepspeed.yaml stage 2 = zero2;
    # fsdp, dpNxtpM, tpM, dpNxppS, ppS).  With no process group every
    # strategy but tpM and ppS (M, S > 1) is the one-device step.
    strategy: str = "zero2"
    # GPipe microbatch count for the pp strategies (0 = the smallest
    # divisor of the per-data-slice batch >= the stage count)
    pp_microbatches: int = 0
    # experiment-tracking backend: csv (built-in) | tensorboard | wandb
    # (reference configs/logger/, train.yaml:10)
    logger: str = "csv"
    run_name: str = "esmdiff"
    print_config: bool = True     # config tree at startup (rich_utils analogue)


@dataclasses.dataclass
class TrainConfig:
    task_name: str = "mdlm"
    seed: int = 42
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)


@dataclasses.dataclass
class InferenceConfig:
    """AR-sampling knobs (reference configs/predict.yaml:26-31)."""

    input: Optional[str] = None      # dir of target .pdb files
    output: str = "output/inference"
    batch_size: int = 32
    n_samples: int = 100
    temperature: float = 1.0         # reference sample_hf.py:292-296
    top_p: float = 0.95


@dataclasses.dataclass
class PredictConfig:
    """Root prediction config (reference configs/predict.yaml).

    ``train_config`` points at the experiment yaml used for training so the
    AR net is rebuilt with the trained geometry (the reference re-instantiates
    from the run's .hydra config, checkpoint_utils.py:48-59).
    """

    task_name: str = "predict"
    seed: int = 0
    ckpt_path: Optional[str] = None
    train_config: Optional[str] = None
    model_type: Optional[str] = None  # clm | jlm; inferred from ckpt if None
    inference: InferenceConfig = dataclasses.field(
        default_factory=InferenceConfig)


def load_predict_config(yaml_path: str,
                        overrides: Optional[list[str]] = None
                        ) -> PredictConfig:
    """defaults <- predict yaml <- 'a.b=c' CLI overrides."""
    cfg = PredictConfig()
    with open(yaml_path) as f:
        _apply(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        _set_dotted(cfg, k, v)
    return cfg


def is_predict_config(yaml_path: str) -> bool:
    """A yaml with an ``inference`` block is a predict config, not a
    training experiment (reference keeps them as separate Hydra roots)."""
    with open(yaml_path) as f:
        d = yaml.safe_load(f) or {}
    return "inference" in d or d.get("task_name") == "predict"


def _apply(obj: Any, updates: dict):
    for k, v in updates.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {k} on {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply(cur, v)
        else:
            setattr(obj, k, v)


def _set_dotted(cfg: TrainConfig, dotted: str, value: str):
    keys = dotted.split(".")
    obj = cfg
    for k in keys[:-1]:
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {dotted}")
        obj = getattr(obj, k)
    if not hasattr(obj, keys[-1]):
        raise KeyError(f"unknown config key: {dotted}")
    cur = getattr(obj, keys[-1])
    if isinstance(cur, bool):
        value = value.lower() in ("1", "true", "yes")
    elif isinstance(cur, int):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    elif cur is None:
        value = yaml.safe_load(value)
    setattr(obj, keys[-1], value)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[list[str]] = None) -> TrainConfig:
    """defaults <- yaml experiment file <- 'a.b=c' CLI overrides."""
    cfg = TrainConfig()
    if yaml_path:
        with open(yaml_path) as f:
            _apply(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        _set_dotted(cfg, k, v)
    return cfg


# the port's own fields: (section, name) -> default, left out of a saved
# config.yaml at that default
PORT_ONLY = {("model", "remat_policy"): "nothing"}


def save_config(cfg: TrainConfig, path: str | Path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    tree = dataclasses.asdict(cfg)
    for (section, name), default in PORT_ONLY.items():
        if tree[section][name] == default:
            del tree[section][name]
    Path(path).write_text(yaml.safe_dump(tree))
