"""Checkpoint loading for the port's inference runtimes.

Port of ``esmdiff_tpu/convert/checkpoints.py``.  ``load_runtime`` builds
an ``ESM3Runtime`` from

  1. a training run of the port (``train/loop.py``) or of the JAX
     package (its orbax ``CheckpointManager`` steps, read by
     ``convert/orbax.py`` where tensorstore is installed): the run, its
     checkpoint directory (the best entry in ``index.json``) or one
     ``step_N`` directory, with the run's ``config.yaml`` two levels up,
     from which the trunk and the sigma embedder are rebuilt.  The
     parameters are loaded as saved (float32; a JAX state's
     ``params["net"]`` and ``["sigma_embedder"]`` through
     ``load_flax_params``), as the JAX runtime holds its params; each
     module casts its matmul weights at use;
  2. a reference PyTorch file (``.pt``/``.ckpt``; any layout of
     ``convert/torch_ckpt.py``): the ESM3 trunk at the geometry the file
     encodes (``infer_trunk_config``: width, depth, head type, 4096
     structure rows being the stock multi-track heads, for gibbs and eb,
     4101 the ESMDiff fine-tune, for ddpm), filled strictly; the head
     count and dtype, which no shape gives, are those of the geometry of
     the file's width (``file_configs``: ESM3-open-small or the tiny test
     width).  An ESMDiff release's ``sigma_embedder.*`` is converted when
     the file carries it (the JAX package drops it and samples ddpm with
     a seed-0 time embedding), else the embedder is seed 0.  The weights
     are held as ``ESM3Runtime.random_init`` holds them: matmul weights in
     the compute dtype (``cast_matmul_weights``), and with
     ``quant="int8"`` the trunk quantized from the file's float32 values
     first.

The VQ-VAE encoder and decoder are those of ``vqvae_ckpt`` (a
``save_vqvae`` directory: ``esmdiff-torch-train-vqvae``'s export, or
``vqvae_from_reference``'s conversion of ESM3's VQ files), or else random
weights from seed 0, as in JAX.

``save_vqvae``/``load_vqvae`` keep the JAX layout's ``vqvae.json``
(``encoder_cfg``, ``decoder_cfg``) beside ``params.pt`` (the port's
``utils/checkpoint.py``) in place of orbax's ``params/``; ``load_vqvae``
also reads the JAX package's directories (``params/`` in orbax, the
decoder's stacked layers unstacked).

``load_ar_params`` fills a CLM or JLM from a CLM/JLM training run of the
port (the run, its checkpoint directory or a ``step_N`` directory:
``params.pt`` holds the net's state dict, loaded strictly; the optimizer
state is ignored) or of the JAX package (an orbax directory of bare
params or of a TrainState, or such a run: ``load_flax_params``,
strictly), or from an HF torch checkpoint (``convert/ar_rules.py``),
strictly: unlike the JAX package's, which converts with the CLM rules for
12 layers unless told otherwise and keeps the random value of every leaf
it cannot fill, it takes the rules and the depth from the model it fills
and raises on any leaf left unfilled.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Mapping, Optional

import torch

from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.convert import load_flax_params
from esmdiff_tpu_torch.convert import orbax
from esmdiff_tpu_torch.convert.ar_rules import clm_rules, jlm_rules
from esmdiff_tpu_torch.convert.torch_ckpt import (
    convert_mdlm, convert_vqvae_decoder, convert_vqvae_encoder,
    infer_trunk_config, load_torch_state_dict, trunk_width, unwrap_net)
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.clm import CLM
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config, esm3_tiny
from esmdiff_tpu_torch.models.jlm import JLM
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder,
                                            StructureTokenEncoder)
from esmdiff_tpu_torch.nn.layers import (TimestepEmbedder,
                                         cast_matmul_weights, init_params)
from esmdiff_tpu_torch.train.config import load_config
from esmdiff_tpu_torch.train.loop import build_mdlm, mdlm_modules
from esmdiff_tpu_torch.train.vqvae import VQVAE, sub_state_dict
from esmdiff_tpu_torch.utils.checkpoint import (PARAMS, load_params,
                                                save_params)

VQVAE_JSON = "vqvae.json"
# DecoderConfig fields of the JAX package that mean nothing here
_JAX_ONLY_DECODER_FIELDS = ("scan_layers",)


def scale_configs(model_scale: str = "full") -> dict:
    """The ``trunk_cfg``, ``encoder_cfg`` and ``decoder_cfg`` of a
    ``--model_scale``: "full" = the reference geometry (ESM3-open-small,
    the VQ-VAE at JAX's defaults), "tiny" = the test widths the CLIs
    build (float32)."""
    if model_scale == "full":
        return {"trunk_cfg": ESM3Config(), "encoder_cfg": EncoderConfig(),
                "decoder_cfg": DecoderConfig()}
    if model_scale != "tiny":
        raise ValueError(f"model_scale must be 'full' or 'tiny', got "
                         f"{model_scale!r}")
    return {"trunk_cfg": esm3_tiny(dtype="float32"),
            "encoder_cfg": EncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                         n_layers=2, d_out=16, knn=8),
            "decoder_cfg": DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                         dtype="float32")}


def file_configs(state_dict) -> dict:
    """``scale_configs`` of the geometry whose width a reference trunk
    state dict has (no shape gives the head count; without ``vqvae_ckpt``
    the seed-0 VQ-VAE follows the same geometry), its ``trunk_cfg`` read
    from the file (``infer_trunk_config``).  Raises ValueError on a width
    neither geometry has."""
    width = trunk_width(state_dict)
    for scale in ("full", "tiny"):
        cfgs = scale_configs(scale)
        if cfgs["trunk_cfg"].d_model == width:
            cfgs["trunk_cfg"] = infer_trunk_config(state_dict,
                                                   cfgs["trunk_cfg"])
            return cfgs
    raise ValueError(f"a trunk of width {width}: neither the reference "
                     f"geometry nor the tiny one, so its head count is "
                     f"unknown")


def _run_step_dir(path: str | Path) -> tuple[Path, Path]:
    """(step directory, run directory) of a checkpoint path: a run
    directory or its checkpoint directory (``index.json``'s best entry),
    or a ``step_N`` directory holding ``params.pt`` (the port's) or an
    orbax checkpoint (the JAX package's).  Raises FileNotFoundError on
    anything else."""
    path = Path(path)
    if not (path / "index.json").exists() and \
            (path / "ckpt" / "index.json").exists():
        path = path / "ckpt"           # a run directory
    if (path / "index.json").exists():
        index = json.loads((path / "index.json").read_text())
        if not index:
            raise FileNotFoundError(f"{path}/index.json lists no checkpoint")
        # the entry's directory name under this checkpoint directory, so a
        # moved run still loads
        return path / Path(index[0]["path"]).name, path.parent
    if (path / PARAMS).exists() or orbax.is_orbax_dir(path):
        return path, path.parent.parent
    raise FileNotFoundError(
        f"{path}: neither a checkpoint of the port's trainer ({PARAMS}, "
        f"index.json) nor an orbax checkpoint of the JAX package "
        f"({orbax.METADATA})")


def _load_step(module: torch.nn.Module, step_dir: Path) -> str:
    """Fill ``module`` strictly from a step directory: the port's
    ``params.pt``, or the ``params`` (of a TrainState, else the bare tree)
    of an orbax checkpoint of the JAX package.  Returns which."""
    if orbax.is_orbax_dir(step_dir):
        load_flax_params(module, orbax.params_of(orbax.read_tree(step_dir)))
        return "the JAX package's orbax checkpoint"
    load_state_dict_strict(module, load_params(step_dir), step_dir)
    return "the port's run"


def save_vqvae(out_dir, encoder_cfg: EncoderConfig, encoder_params: Mapping,
               decoder_cfg: DecoderConfig, decoder_params: Mapping) -> None:
    """Persist a (trained) VQ-VAE pair: ``params.pt`` (``encoder.*``,
    ``decoder.*``, as held) + ``vqvae.json`` (the geometry)."""
    out = Path(out_dir).absolute()
    out.mkdir(parents=True, exist_ok=True)
    save_params(out, {**{f"encoder.{k}": v for k, v in encoder_params.items()},
                      **{f"decoder.{k}": v for k, v in decoder_params.items()}})
    (out / VQVAE_JSON).write_text(json.dumps({
        "encoder_cfg": dataclasses.asdict(encoder_cfg),
        "decoder_cfg": dataclasses.asdict(decoder_cfg),
    }, indent=2))


def read_vqvae_json(path) -> tuple[EncoderConfig, DecoderConfig]:
    """The geometry of a ``vqvae.json`` (the port's or the JAX package's,
    whose ``scan_layers`` is dropped)."""
    meta = json.loads(Path(path).read_text())
    dec = {k: v for k, v in meta["decoder_cfg"].items()
           if k not in _JAX_ONLY_DECODER_FIELDS}
    return EncoderConfig(**meta["encoder_cfg"]), DecoderConfig(**dec)


def load_vqvae(ckpt_dir):
    """-> (encoder_cfg, encoder_params, decoder_cfg, decoder_params), the
    params as state dicts of CPU tensors, as saved (a JAX package's orbax
    ``params/``: carried into the port's modules, float32)."""
    path = Path(ckpt_dir).absolute()
    enc_cfg, dec_cfg = read_vqvae_json(path / VQVAE_JSON)
    if not (path / PARAMS).exists() and (path / "params").is_dir():
        tree = orbax.read_tree(path / "params")
        return (enc_cfg, load_flax_params(StructureTokenEncoder(enc_cfg),
                                          tree["encoder"]).state_dict(),
                dec_cfg, load_flax_params(StructureTokenDecoder(dec_cfg),
                                          tree["decoder"]).state_dict())
    params = load_params(path)
    return (enc_cfg, sub_state_dict(params, "encoder."), dec_cfg,
            sub_state_dict(params, "decoder."))


def vqvae_modules(vqvae_ckpt, device=None):
    """(encoder, decoder) holding ``vqvae_ckpt``'s parameters on
    ``device``, float32 as saved (each module casts at use)."""
    enc_cfg, enc_params, dec_cfg, dec_params = load_vqvae(vqvae_ckpt)
    with torch.device(resolve_device(device)):
        encoder = StructureTokenEncoder(enc_cfg)
        decoder = StructureTokenDecoder(dec_cfg)
    encoder.load_state_dict(enc_params, strict=True)
    decoder.load_state_dict(dec_params, strict=True)
    return encoder, decoder


def vqvae_from_flax(enc_cfg: EncoderConfig, dec_cfg: DecoderConfig,
                    tree: Mapping, device="cpu") -> VQVAE:
    """The port's ``train.vqvae.VQVAE`` holding a JAX ``VQVAE`` param tree
    (nested dicts of numpy arrays), loaded strictly, float32."""
    with torch.device(device):
        model = VQVAE(enc_cfg, dec_cfg)
    return load_flax_params(model, tree)


def load_runtime(ckpt_path: str | Path, vqvae_ckpt: Optional[str] = None,
                 device=None, quant: str = "none") -> ESM3Runtime:
    """An ``ESM3Runtime`` from a training run of the port or a reference
    PyTorch file, paired with ``vqvae_ckpt`` when given; see the module
    docstring.  quant: "int8" = W8A8 trunk projections."""
    path = Path(ckpt_path)
    if path.is_file():
        return _load_runtime_from_torch(path, vqvae_ckpt, device, quant)
    if not path.exists():
        raise FileNotFoundError(f"no checkpoint at {path}")
    runtime = _load_runtime_from_run(path, vqvae_ckpt, device)
    return runtime if quant == "none" else runtime.quantize(quant)


def _load_runtime_from_run(path: Path, vqvae_ckpt, device) -> ESM3Runtime:
    step_dir, run_dir = _run_step_dir(path)
    cfg_file = run_dir / "config.yaml"
    if not cfg_file.exists():
        raise FileNotFoundError(
            f"config.yaml not found beside checkpoint: {cfg_file}")
    cfg = load_config(str(cfg_file))
    dev = resolve_device(device)
    mdlm = build_mdlm(cfg, dev)
    _load_step(mdlm_modules(mdlm), step_dir)
    if vqvae_ckpt:
        # every module has saved weights: no random init to throw away
        encoder, decoder = vqvae_modules(vqvae_ckpt, dev)
        print(f"[load_runtime] trained VQ-VAE from {vqvae_ckpt}; restored "
              f"the trunk and sigma embedder from {step_dir}")
        return ESM3Runtime(mdlm.net, decoder, mdlm.sigma_embedder,
                           device=dev, encoder=encoder)
    vq = scale_configs("tiny" if cfg.model.size == "tiny" else "full")
    runtime = ESM3Runtime.random_init(
        trunk_cfg=mdlm.net.cfg, device=dev, encoder_cfg=vq["encoder_cfg"],
        decoder_cfg=vq["decoder_cfg"])
    runtime.trunk = mdlm.net.eval()
    runtime.sigma_embedder = mdlm.sigma_embedder.eval()
    print(f"[load_runtime] restored the trunk and sigma embedder from "
          f"{step_dir}")
    return runtime


@torch.no_grad()
def _load_runtime_from_torch(path: Path, vqvae_ckpt, device,
                             quant: str) -> ESM3Runtime:
    """The runtime of a reference trunk file (see the module docstring)."""
    dev = resolve_device(device)
    t0 = time.time()
    sd = load_torch_state_dict(str(path))
    cfgs = file_configs(sd)
    cfg = dataclasses.replace(cfgs["trunk_cfg"], quant="none")
    with torch.device(dev):
        trunk = ESM3(cfg).eval()      # float32 parameters, filled below
        sigma = TimestepEmbedder(cfg.d_model, dtype=cfg.torch_dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_params(sigma, gen)           # kept when the file has none
    report = convert_mdlm(trunk, sigma, sd)
    sigma_from = ("the file" if report["sigma"] else
                  "seed 0 (the file has no sigma_embedder.*)")
    if vqvae_ckpt:
        encoder, decoder = vqvae_modules(vqvae_ckpt, dev)
        vq_from = str(vqvae_ckpt)
    else:
        with torch.device(dev):
            decoder = StructureTokenDecoder(cfgs["decoder_cfg"])
            encoder = StructureTokenEncoder(cfgs["encoder_cfg"])
        for m in (decoder, encoder):
            init_params(m, gen)
        encoder.codebook.normal_(0.0, 1.0, generator=gen)
        vq_from = "seed 0"
    for m in (sigma, decoder, encoder):
        cast_matmul_weights(m)
    runtime = ESM3Runtime(trunk, decoder, sigma, device=dev, encoder=encoder)
    if quant == "none":
        cast_matmul_weights(runtime.trunk)
    else:  # from the file's float32 values
        runtime = runtime.quantize(quant)
    print(f"[load_runtime] {path}: trunk ({cfg.head_type} heads, "
          f"{report['converted']} tensors, quant {quant}), sigma embedder "
          f"from {sigma_from}, VQ-VAE from {vq_from}; "
          f"{time.time() - t0:.1f} s")
    return runtime


@torch.no_grad()
def vqvae_from_reference(encoder_pt: str | Path, decoder_pt: str | Path,
                         out_dir: str | Path,
                         encoder_cfg: Optional[EncoderConfig] = None,
                         decoder_cfg: Optional[DecoderConfig] = None,
                         seed: int = 0) -> Path:
    """Convert ESM3's VQ encoder and decoder files
    (``esm3_structure_{encoder,decoder}_v0``) and write them as a
    ``save_vqvae`` directory (``--vqvae_ckpt``), float32.  The decoder's
    no-source ``pae_q``/``pae_k`` keep a seed-``seed`` init, as the report
    says.  Default geometry: the reference's (JAX's defaults)."""
    enc_cfg = encoder_cfg or EncoderConfig()
    dec_cfg = decoder_cfg or DecoderConfig()
    encoder = StructureTokenEncoder(enc_cfg)
    decoder = StructureTokenDecoder(dec_cfg)
    gen = torch.Generator().manual_seed(seed)
    for name in ("pae_q", "pae_k"):
        if hasattr(decoder, name):
            init_params(getattr(decoder, name), gen)
    convert_vqvae_encoder(encoder, load_torch_state_dict(str(encoder_pt)))
    report = convert_vqvae_decoder(decoder,
                                   load_torch_state_dict(str(decoder_pt)))
    save_vqvae(out_dir, enc_cfg, encoder.state_dict(), dec_cfg,
               decoder.state_dict())
    print(f"[vqvae_from_reference] {encoder_pt} + {decoder_pt} -> {out_dir} "
          f"(no source, seed {seed}: {report['no_source']})")
    return Path(out_dir)


@torch.no_grad()
def convert_ar(model: CLM | JLM, state_dict: Mapping) -> CLM | JLM:
    """Fill ``model`` (a floating-point CLM or JLM) from an HF state dict
    (``CustomedT5``/``CustomedGPT2`` keys), keeping each parameter's dtype
    and device.  The rules (CLM or JLM) and the depth are the model's.
    Raises KeyError when a parameter of the model has no rule
    ("unmapped") or its HF key is not in the state dict ("missing"),
    ValueError on a shape mismatch."""
    if isinstance(model, CLM):
        model_type, rules = "clm", clm_rules(model.cfg.n_layers)
    elif isinstance(model, JLM):
        model_type, rules = "jlm", jlm_rules(model.cfg.n_layers)
    else:
        raise TypeError(f"convert_ar fills a CLM or a JLM, not "
                        f"{type(model).__name__}")
    own = model.state_dict()
    unmapped = sorted(k for k in own if k not in rules)
    missing = sorted(rules[k][0] for k in own
                     if k in rules and rules[k][0] not in state_dict)
    if unmapped or missing:
        raise KeyError(
            f"the checkpoint does not fill the port's {model_type} "
            f"({model.cfg.n_layers} layers): {len(missing)} missing "
            f"{missing[:8]}, {len(unmapped)} unmapped {unmapped[:8]}")
    converted = {}
    for name, t in own.items():
        key, transform = rules[name]
        value = transform(torch.as_tensor(state_dict[key]))
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{name} <- {key}: checkpoint shape "
                             f"{tuple(value.shape)} vs port {tuple(t.shape)}")
        converted[name] = value.to(dtype=t.dtype, device=t.device)
    model.load_state_dict(converted, strict=True)
    return model


def load_state_dict_strict(model: torch.nn.Module, state_dict: Mapping,
                          where) -> None:
    """``model.load_state_dict(state_dict)`` after checking that the keys
    and shapes are the model's; raises ValueError naming the keys that are
    missing, unexpected or of another shape."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state_dict)
    extra = sorted(k for k in state_dict if k not in own)
    shapes = sorted(f"{k} {tuple(state_dict[k].shape)} vs "
                    f"{tuple(own[k].shape)}" for k in own
                    if k in state_dict
                    and state_dict[k].shape != own[k].shape)
    if missing or extra or shapes:
        raise ValueError(
            f"{where} does not fit the {type(model).__name__} the config "
            f"builds: {len(missing)} missing {missing[:8]}, {len(extra)} "
            f"unexpected {extra[:8]}, {len(shapes)} of another shape "
            f"{shapes[:8]}")
    model.load_state_dict(state_dict, strict=True)


def load_ar_params(ckpt_path: str | Path, model: CLM | JLM) -> CLM | JLM:
    """Fill ``model`` from a CLM/JLM run of the port or of the JAX package
    (a run, checkpoint or ``step_N`` directory, or an orbax directory of
    bare params: ``_load_step``, strictly), or from an HF torch checkpoint
    (``.pt``/``.ckpt``: a bare state dict, DeepSpeed's ``module`` or
    Lightning's ``state_dict``, ``net.``-prefixed keys unwrapped) through
    ``convert_ar``."""
    path = Path(ckpt_path)
    if path.is_dir():
        step_dir, _ = _run_step_dir(path)
        source = _load_step(model, step_dir)
        print(f"[load_ar_params] {type(model).__name__} from {source} "
              f"{step_dir} ({len(model.state_dict())} tensors)")
        return model
    convert_ar(model, unwrap_net(load_torch_state_dict(str(path))))
    print(f"[load_ar_params] converted {type(model).__name__} from {path} "
          f"({len(model.state_dict())} tensors)")
    return model
