"""Checkpoint loading for the port's inference runtimes.

Port of the training-run half of ``esmdiff_tpu/convert/checkpoints.py``:
``load_runtime`` restores an ``ESM3Runtime`` from one of the port's own
training runs (``train/loop.py``): the checkpoint directory (its best
entry in ``index.json``) or one ``step_N`` directory, with the run's
``config.yaml`` beside it, from which the trunk and the sigma embedder are
rebuilt.  The parameters are loaded as saved (float32), as the JAX runtime
holds its params; each module casts its matmul weights at use.  The VQ-VAE
encoder and decoder are those of ``vqvae_ckpt`` (a ``save_vqvae``
directory, e.g. ``esmdiff-torch-train-vqvae``'s export), loaded the same
way, or else random weights (seed 0), as in JAX.

``save_vqvae``/``load_vqvae`` keep the JAX layout's ``vqvae.json``
(``encoder_cfg``, ``decoder_cfg``) beside ``params.pt`` (the port's
``utils/checkpoint.py``) in place of orbax's ``params/``.

``load_ar_params`` fills a CLM or JLM from an HF torch checkpoint
(``convert/ar_rules.py``), strictly: unlike the JAX package's, which
converts with the CLM rules for 12 layers unless told otherwise and keeps
the random value of every leaf it cannot fill, it takes the rules and the
depth from the model it fills and raises on any leaf left unfilled.

Not ported yet, and raising: the JAX package's orbax run, VQ-VAE and AR
directories, and a PyTorch ESM3 trunk file (``torch_to_jax``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping, Optional

import torch

from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.convert import load_flax_params
from esmdiff_tpu_torch.convert.ar_rules import (clm_rules, jlm_rules,
                                                load_torch_state_dict,
                                                strip_prefix)
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.clm import CLM
from esmdiff_tpu_torch.models.jlm import JLM
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder,
                                            StructureTokenEncoder)
from esmdiff_tpu_torch.train.config import load_config
from esmdiff_tpu_torch.train.loop import build_mdlm, mdlm_modules
from esmdiff_tpu_torch.train.vqvae import VQVAE, sub_state_dict
from esmdiff_tpu_torch.utils.checkpoint import (PARAMS, load_params,
                                                save_params)

VQVAE_JSON = "vqvae.json"
# DecoderConfig fields of the JAX package that mean nothing here
_JAX_ONLY_DECODER_FIELDS = ("scan_layers",)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def _run_step_dir(path: str | Path) -> tuple[Path, Path]:
    """(step directory, run directory) of a checkpoint path: a checkpoint
    directory (its ``index.json``'s best entry) or a ``step_N`` directory
    holding ``params.pt``."""
    path = Path(path)
    if (path / "index.json").exists():
        index = json.loads((path / "index.json").read_text())
        if not index:
            raise FileNotFoundError(f"{path}/index.json lists no checkpoint")
        # the entry's directory name under this checkpoint directory, so a
        # moved run still loads
        return path / Path(index[0]["path"]).name, path.parent
    if (path / PARAMS).exists():
        return path, path.parent.parent
    if path.is_dir():
        _not_ported(f"loading {path}: not a checkpoint of the port's trainer "
                    "(orbax checkpoints of the JAX package)")
    _not_ported(f"loading {path}: converting a PyTorch ESM3 trunk "
                "checkpoint (torch_to_jax)")


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
    params as state dicts of CPU tensors, as saved."""
    path = Path(ckpt_dir).absolute()
    if not (path / PARAMS).exists() and (path / "params").is_dir():
        _not_ported(f"loading {path}: an orbax VQ-VAE checkpoint of the JAX "
                    "package")
    enc_cfg, dec_cfg = read_vqvae_json(path / VQVAE_JSON)
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
                 device=None) -> ESM3Runtime:
    """An ``ESM3Runtime`` whose trunk and sigma embedder hold the saved
    parameters of a training run of the port, and whose encoder and
    decoder those of ``vqvae_ckpt`` when given; see the module
    docstring."""
    step_dir, run_dir = _run_step_dir(ckpt_path)
    cfg_file = run_dir / "config.yaml"
    if not cfg_file.exists():
        raise FileNotFoundError(
            f"config.yaml not found beside checkpoint: {cfg_file}")
    cfg = load_config(str(cfg_file))
    dev = resolve_device(device)
    mdlm = build_mdlm(cfg, dev)
    mdlm_modules(mdlm).load_state_dict(load_params(step_dir), strict=True)
    if vqvae_ckpt:
        # every module has saved weights: no random init to throw away
        encoder, decoder = vqvae_modules(vqvae_ckpt, dev)
        print(f"[load_runtime] trained VQ-VAE from {vqvae_ckpt}; restored "
              f"the trunk and sigma embedder from {step_dir}")
        return ESM3Runtime(mdlm.net, decoder, mdlm.sigma_embedder,
                           device=dev, encoder=encoder)
    if cfg.model.size == "tiny":
        runtime = ESM3Runtime.random_init(
            trunk_cfg=mdlm.net.cfg, device=dev,
            encoder_cfg=EncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                      n_layers=2, d_out=16, knn=8),
            decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                      dtype="float32"))
    else:
        runtime = ESM3Runtime.random_init(trunk_cfg=mdlm.net.cfg, device=dev)
    runtime.trunk = mdlm.net.eval()
    runtime.sigma_embedder = mdlm.sigma_embedder.eval()
    print(f"[load_runtime] restored the trunk and sigma embedder from "
          f"{step_dir}")
    return runtime


@torch.no_grad()
def load_ar_params(ckpt_path: str | Path, model: CLM | JLM) -> CLM | JLM:
    """Fill ``model`` (a floating-point CLM or JLM) from an HF torch
    checkpoint (``.pt``/``.ckpt``: a bare state dict, DeepSpeed's
    ``module`` or Lightning's ``state_dict``, ``net.``-prefixed keys
    unwrapped), keeping each parameter's dtype and device.  The rules
    (CLM or JLM) and the depth are the model's.  Raises KeyError when a
    parameter of the model has no rule ("unmapped") or its HF key is not
    in the checkpoint ("missing"), ValueError on a shape mismatch."""
    path = Path(ckpt_path)
    if path.is_dir():
        _not_ported(f"loading {path}: an orbax AR checkpoint of the JAX "
                    "package")
    if isinstance(model, CLM):
        model_type, rules = "clm", clm_rules(model.cfg.n_layers)
    elif isinstance(model, JLM):
        model_type, rules = "jlm", jlm_rules(model.cfg.n_layers)
    else:
        raise TypeError(f"load_ar_params fills a CLM or a JLM, not "
                        f"{type(model).__name__}")
    sd = load_torch_state_dict(str(path))
    if any(k.startswith("net.") for k in sd):
        sd = strip_prefix(sd, "net.")
    own = model.state_dict()
    unmapped = sorted(k for k in own if k not in rules)
    missing = sorted(rules[k][0] for k in own
                     if k in rules and rules[k][0] not in sd)
    if unmapped or missing:
        raise KeyError(
            f"{path} does not fill the port's {model_type} "
            f"({model.cfg.n_layers} layers): {len(missing)} missing "
            f"{missing[:8]}, {len(unmapped)} unmapped {unmapped[:8]}")
    converted = {}
    for name, t in own.items():
        key, transform = rules[name]
        value = transform(sd[key])
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{name} <- {key}: checkpoint shape "
                             f"{tuple(value.shape)} vs port {tuple(t.shape)}")
        converted[name] = value.to(dtype=t.dtype, device=t.device)
    model.load_state_dict(converted, strict=True)
    print(f"[load_ar_params] converted {model_type} from {path} "
          f"({len(converted)} tensors)")
    return model
