"""Checkpoint loading for the port's inference runtimes.

Port of the training-run half of ``esmdiff_tpu/convert/checkpoints.py``:
``load_runtime`` restores an ``ESM3Runtime`` from one of the port's own
training runs (``train/loop.py``): the checkpoint directory (its best
entry in ``index.json``) or one ``step_N`` directory, with the run's
``config.yaml`` beside it, from which the trunk and the sigma embedder are
rebuilt.  The parameters are loaded as saved (float32), as the JAX runtime
holds its params; each module casts its matmul weights at use.  The VQ-VAE
encoder and decoder have no trained source and are random weights
(seed 0), as in JAX.

Not ported yet, and raising: the JAX package's orbax run directories, a
PyTorch ESM3 trunk file (``torch_to_jax``) and ``vqvae_ckpt``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
from esmdiff_tpu_torch.train.config import load_config
from esmdiff_tpu_torch.train.loop import build_mdlm, mdlm_modules
from esmdiff_tpu_torch.utils.checkpoint import PARAMS, load_params


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


def load_runtime(ckpt_path: str | Path, vqvae_ckpt: Optional[str] = None,
                 device=None) -> ESM3Runtime:
    """An ``ESM3Runtime`` whose trunk and sigma embedder hold the saved
    parameters of a training run of the port; see the module docstring."""
    if vqvae_ckpt:
        _not_ported("--vqvae_ckpt (a trained VQ-VAE)")
    step_dir, run_dir = _run_step_dir(ckpt_path)
    cfg_file = run_dir / "config.yaml"
    if not cfg_file.exists():
        raise FileNotFoundError(
            f"config.yaml not found beside checkpoint: {cfg_file}")
    cfg = load_config(str(cfg_file))
    dev = resolve_device(device)
    mdlm = build_mdlm(cfg, dev)
    mdlm_modules(mdlm).load_state_dict(load_params(step_dir), strict=True)
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
