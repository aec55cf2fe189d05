"""AR (CLM, JLM) conformation sampling CLI on the port.

Port of ``esmdiff_tpu/cli/sample_ar.py`` (``esmdiff-torch-sample-ar``):
each target PDB in ``--input`` -> its sequence tokens -> one trunk forward
giving the (L+2, 1536) conditioning embeddings -> KV-cached autoregressive
decoding of L+2 structure tokens per sample (top-p, temperature, the
special-token shield; ``api/ar_generation.py``) -> the VQ-VAE decode of
the interior L -> one multi-MODEL PDB per target.  The flags, defaults and
precedence rules are JAX's, plus ``--device`` (default ``cuda``):

  - ``--config``: a training yaml (``configs/clm.yaml``,
    ``configs/jlm.yaml``) rebuilds that net's geometry, or a predict yaml
    (``configs/predict.yaml``) whose values replace the flags' defaults
    (an explicitly passed flag wins) and whose ``train_config`` names the
    training yaml;
  - the model type: ``--model_type``, else the training config's
    ``task_name``, else "clm" or "jlm" in the ``--ckpt`` path, else clm;
  - the geometry: the training config's, else ``--model_scale tiny``'s
    (JAX's tiny widths), else the ``CLMConfig()``/``JLMConfig()`` defaults;
  - ``--ckpt``: one of the port's CLM/JLM training runs (the run, its
    checkpoint directory or a ``step_N`` directory), loaded strictly into
    the net ``--config`` builds (raising, with the keys, on any other
    shape), or an HF torch checkpoint; both through
    ``convert.checkpoints.load_ar_params``, which raises on any parameter
    it cannot fill, where the JAX package keeps random weights;
  - ``--quant int8``: the block projections in W8A8 int8 (ops/quant.py);
  - ``--runtime_ckpt``: a training run of the port providing the trunk,
    paired with a trained VQ-VAE by ``--vqvae_ckpt`` (which without
    ``--runtime_ckpt`` exits with an error).

Each sample's draws come from its own generator, seeded from (``--seed``,
the sample's index), so a sample does not depend on ``--batch_size``.

    python -m esmdiff_tpu_torch.cli.sample_ar --config configs/clm.yaml \\
        --input data/targets/bpti --output output/inference_ar
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from esmdiff_tpu_torch.api.ar_generation import (RowGeneratorDraws,
                                                 clm_generate, jlm_generate)
from esmdiff_tpu_torch.api.generation import (decode_tokens_to_proteins,
                                              request_row_seeds)
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models import clm as clm_mod
from esmdiff_tpu_torch.models import jlm as jlm_mod
from esmdiff_tpu_torch.models.esm3 import esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
from esmdiff_tpu_torch.nn.layers import cast_matmul_weights
from esmdiff_tpu_torch.train.config import (TrainConfig, is_predict_config,
                                            load_config, load_predict_config)
from esmdiff_tpu_torch.train.loop import build_clm, build_jlm

# the JAX CLI's --model_scale tiny geometry
TINY_CLM = dict(d_model=64, d_ff=128, n_layers=2, n_heads=4, dtype="float32")
TINY_JLM = dict(n_embd=64, n_layers=2, n_heads=4, dtype="float32",
                struct_embed_dim=32)


def get_argparser():
    p = argparse.ArgumentParser(
        description="AR structure-token sampling (PyTorch port).")
    p.add_argument("--input", type=str, default="data/targets/bpti")
    p.add_argument("--output", type=str, default="output/inference_ar")
    p.add_argument("--model_type", type=str, default=None,
                   choices=[None, "clm", "jlm"],
                   help="Inferred from --config or the --ckpt path if "
                        "omitted.")
    p.add_argument("--ckpt", type=str, default=None,
                   help="A CLM/JLM training run of the port (run, ckpt or "
                        "step dir; pass its --config) or an HF torch "
                        "checkpoint (.pt/.ckpt).")
    p.add_argument("--config", type=str, default=None,
                   help="Training experiment yaml (configs/clm.yaml etc.) "
                        "to rebuild the net's geometry, or a predict yaml "
                        "(configs/predict.yaml) whose inference block sets "
                        "the defaults of input/output/batch/n_samples/"
                        "temperature/top_p; explicit flags win.")
    p.add_argument("--n_samples", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_p", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_scale", type=str, default="full",
                   choices=["full", "tiny"])
    p.add_argument("--runtime_ckpt", type=str, default=None,
                   help="A training run of the port providing the trunk "
                        "(the conditioning embeddings).")
    p.add_argument("--vqvae_ckpt", type=str, default=None,
                   help="Trained VQ-VAE dir for the token decode (pairs "
                        "with --runtime_ckpt).")
    p.add_argument("--quant", type=str, default="none",
                   choices=["none", "int8"],
                   help="int8 = W8A8 AR block projections (ops/quant.py).")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs everything on the host.")
    return p


def resolve_config(args, parser) -> Optional[TrainConfig]:
    """Apply ``--config``: a predict yaml's values to the flags left at
    their defaults (in place), and return the training config to rebuild
    the net from (the yaml itself or the predict yaml's
    ``train_config``), or None."""
    if not args.config:
        return None
    if not is_predict_config(args.config):
        return load_config(args.config)
    pred = load_predict_config(args.config)
    inf = pred.inference
    for flag, val in (("input", inf.input), ("output", inf.output),
                      ("batch_size", inf.batch_size),
                      ("n_samples", inf.n_samples),
                      ("temperature", inf.temperature),
                      ("top_p", inf.top_p), ("seed", pred.seed),
                      ("ckpt", pred.ckpt_path),
                      ("model_type", pred.model_type)):
        if val is not None and getattr(args, flag) == parser.get_default(flag):
            setattr(args, flag, val)
    return load_config(pred.train_config) if pred.train_config else None


def infer_model_type(args, train_cfg: Optional[TrainConfig]) -> str:
    if args.model_type is not None:
        return args.model_type
    if train_cfg is not None and train_cfg.task_name in ("clm", "jlm"):
        return train_cfg.task_name
    ckpt = (args.ckpt or "").lower()
    if "clm" in ckpt:
        return "clm"
    if "jlm" in ckpt:
        return "jlm"
    return "clm"


def build_runtime(args) -> ESM3Runtime:
    """The trunk and VQ decoder: ``--runtime_ckpt`` (with
    ``--vqvae_ckpt``), or random weights at ``--model_scale``."""
    if args.runtime_ckpt:
        return checkpoints.load_runtime(
            args.runtime_ckpt, vqvae_ckpt=args.vqvae_ckpt, device=args.device)
    if args.model_scale == "tiny":
        return ESM3Runtime.random_init(
            seed=args.seed, trunk_cfg=esm3_tiny(dtype="float32"),
            encoder_cfg=EncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                      n_layers=2, d_out=16, knn=8),
            decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                      dtype="float32"),
            device=args.device)
    return ESM3Runtime.random_init(seed=args.seed, device=args.device)


def build_model(args, model_type: str, train_cfg: Optional[TrainConfig],
                cond_dim: int, device):
    """The AR net with uninitialised float32 parameters on ``device``:
    the training config's geometry, else ``--model_scale``'s (full with
    ``--runtime_ckpt``, as in JAX)."""
    if train_cfg is not None:
        build = build_clm if model_type == "clm" else build_jlm
        return build(train_cfg, device, cond_dim=cond_dim)
    tiny = args.model_scale == "tiny" and not args.runtime_ckpt
    with torch.device(device):
        if model_type == "clm":
            return clm_mod.CLM(clm_mod.CLMConfig(
                cond_dim=cond_dim, **(TINY_CLM if tiny else {})))
        return jlm_mod.JLM(jlm_mod.JLMConfig(
            cond_dim=cond_dim, **(TINY_JLM if tiny else {})))


@torch.no_grad()
def quantized(model):
    """The ``quant="int8"`` twin of a float32 CLM or JLM."""
    convert = (clm_mod.quantize_clm_params if isinstance(model, clm_mod.CLM)
               else jlm_mod.quantize_jlm_params)
    cfg = dataclasses.replace(model.cfg, quant="int8")
    with torch.device(next(model.parameters()).device):
        twin = type(model)(cfg)
    twin.load_state_dict(convert(model.state_dict()), strict=True)
    return twin


def prepare_model(model, args):
    """Random weights from ``--seed``, then ``--ckpt``'s, ``--quant``
    (from the float32 weights, as JAX quantizes), and the matmul weights
    stored in the compute dtype."""
    init = (clm_mod.init_params if isinstance(model, clm_mod.CLM)
            else jlm_mod.init_params)
    dev = next(model.parameters()).device
    init(model, torch.Generator(device=dev).manual_seed(int(args.seed)))
    if args.ckpt:
        checkpoints.load_ar_params(args.ckpt, model)
    if args.quant == "int8":
        model = quantized(model)
        print(f"[quant] {type(model).__name__.lower()} projections running "
              "W8A8 int8")
    return cast_matmul_weights(model).eval()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, runtime: Optional[ESM3Runtime] = None):
    """Run the CLI; ``runtime`` optionally supplies the trunk and decoder in
    place of the one ``--runtime_ckpt``/``--model_scale`` describe.
    Returns one report per target (seconds of the trunk forward, the AR
    decoding and the VQ decode)."""
    parser = get_argparser()
    args = parser.parse_args(argv)
    train_cfg = resolve_config(args, parser)
    model_type = infer_model_type(args, train_cfg)
    if args.vqvae_ckpt and not args.runtime_ckpt:
        raise SystemExit("--vqvae_ckpt needs --runtime_ckpt (the trunk "
                         "providing conditioning embeddings)")
    device = resolve_device(args.device if runtime is None
                            else runtime.device)
    if runtime is None:
        runtime = build_runtime(args)
    model = prepare_model(build_model(args, model_type, train_cfg,
                                      runtime.trunk.cfg.d_model, device),
                          args)
    generate = clm_generate if model_type == "clm" else jlm_generate

    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = []
    for path in sorted(Path(args.input).glob("*.pdb")):
        seq = ESMProtein.from_pdb(path).sequence
        L = len(seq) + 2
        _sync(device)
        t0 = time.time()
        seq_tokens = torch.as_tensor(runtime.seq_tokenizer.encode(seq),
                                     dtype=torch.long, device=device)
        with torch.no_grad():
            emb = runtime.trunk(sequence_tokens=seq_tokens[None]
                                ).embeddings[0].float()      # (L+2, D)
        _sync(device)
        t1 = time.time()
        batches = []
        for start in range(0, args.n_samples, args.batch_size):
            B = min(args.batch_size, args.n_samples - start)
            rows = np.stack([np.full(B, args.seed),
                             np.arange(start, start + B)], axis=1)
            draws = RowGeneratorDraws(request_row_seeds(rows), L,
                                      C.STRUCTURE_VOCAB_SIZE, device)
            batches.append(generate(model, emb[None].expand(B, -1, -1), L,
                                    args.temperature, args.top_p,
                                    draws=draws))
        # strip the first and last positions (BOS/EOS in the decode)
        tokens = torch.cat(batches).cpu().numpy().astype(np.int32)[:, 1:-1]
        t2 = time.time()
        prots = decode_tokens_to_proteins(runtime, seq, tokens)
        out_file = out_dir / f"{path.stem}.pdb"
        protein_io.ensemble_to_pdb_file([p.to_protein() for p in prots],
                                        out_file)
        t3 = time.time()
        print(f"[{path.stem}] {model_type} {args.n_samples} samples: "
              f"trunk {t1 - t0:.2f}s, tokens {t2 - t1:.2f}s, decode "
              f"{t3 - t2:.2f}s, total {t3 - t0:.2f}s -> {out_file}")
        report.append({"target": path.stem, "L": len(seq),
                       "model_type": model_type, "quant": args.quant,
                       "n_samples": args.n_samples,
                       "batches": len(batches), "sample_steps":
                           len(batches) * L,
                       "trunk_sec": t1 - t0, "ar_sec": t2 - t1,
                       "decode_sec": t3 - t2, "total_sec": t3 - t0})
    return report


if __name__ == "__main__":
    main()
