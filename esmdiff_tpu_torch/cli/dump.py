"""Encoding dump on the port: a directory of chains -> one ``.npz`` of
training encodings per chain.

Port of ``esmdiff_tpu/cli/dump.py``: every chain (a ``.pdb`` file, or a
``.npz`` example of the JAX package's ``cli/preprocess.py`` layout) goes
through the VQ-VAE structure encoder (``ESM3Runtime.encode``), optionally
also through the trunk for per-residue embeddings (needed by CLM/JLM
training), and is saved under the same names as JAX's:

  sequence_tokens (L+2,), structure_tokens (L+2,), coordinates (L, 37, 3),
  [embeddings (L+2, D)].

A chain whose file cannot be read is skipped with a message; a failure of
the encoder or the trunk (the card, a kernel) raises.

    python -m esmdiff_tpu_torch.cli.dump data/targets/bpti output/dump \\
        --with_embeddings
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.convert import checkpoints


def build_runtime(args) -> ESM3Runtime:
    """The runtime of ``--ckpt`` (a training run of the port or a
    reference PyTorch file, at its own geometry), or random weights at
    ``--model_scale`` (the stock-head trunk)."""
    if args.ckpt:
        return checkpoints.load_runtime(args.ckpt, device=args.device)
    return ESM3Runtime.random_init(
        seed=args.seed, device=args.device,
        **checkpoints.scale_configs(args.model_scale))


def get_argparser():
    p = argparse.ArgumentParser(
        description="Dump ESM3 encodings for training (PyTorch port).")
    p.add_argument("input_dir", type=str,
                   help="Directory of per-chain .pdb files and/or .npz "
                        "chains in the preprocess layout.")
    p.add_argument("output_dir", type=str)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--with_embeddings", action="store_true",
                   help="Also run the trunk and store per-residue "
                        "embeddings (needed for CLM/JLM training).")
    p.add_argument("--model_scale", type=str, default="full",
                   choices=["full", "tiny"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions.")
    return p


@torch.no_grad()
def main(argv=None, runtime: ESM3Runtime | None = None) -> int:
    """Run the dump; ``runtime`` optionally supplies an already built
    runtime in place of the one ``--ckpt``/``--model_scale`` describe.
    Returns the number of chains written."""
    args = get_argparser().parse_args(argv)
    if runtime is None:
        runtime = build_runtime(args)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = (sorted(Path(args.input_dir).glob("*.pdb"))
             + sorted(Path(args.input_dir).glob("*.npz")))
    print(f"[dump] {len(files)} chains -> {out_dir}")

    n_ok = 0
    for f in files:
        try:
            prot = (ESMProtein.from_npz(f) if f.suffix == ".npz"
                    else ESMProtein.from_pdb(f))
        except (OSError, KeyError, ValueError) as e:
            print(f"[dump] skip {f.name}: {e}")
            continue
        pt = runtime.encode(prot)
        arrays = {"sequence_tokens": pt.sequence.astype(np.int32),
                  "structure_tokens": pt.structure.astype(np.int32),
                  # as JAX writes them: NaN kept, inf to the largest float
                  "coordinates": np.nan_to_num(
                      prot.coordinates, nan=np.nan).astype(np.float32)}
        if args.with_embeddings:
            out = runtime.trunk(sequence_tokens=torch.as_tensor(
                pt.sequence[None], dtype=torch.long, device=runtime.device))
            arrays["embeddings"] = out.embeddings[0].float().cpu().numpy()
        np.savez_compressed(out_dir / f"{f.stem}.npz", **arrays)
        n_ok += 1
    print(f"[dump] wrote {n_ok}/{len(files)} encodings")
    return n_ok


if __name__ == "__main__":
    main()
