"""esmdiff-torch-train-vqvae: train the structure tokenizer (VQ-VAE) on a
corpus with the PyTorch port.

Port of ``esmdiff_tpu/cli/train_vqvae.py``: joint straight-through VQ-VAE
training (``train/vqvae.py``) over a directory of structures, exported in
the port's vqvae checkpoint layout, which the sample and serve CLIs load
through ``--vqvae_ckpt``.  Same flags, plus ``--device`` (default
``cuda``; without a card it raises unless ``--device cpu`` is given).
``--data_parallel`` trains one process per card under torchrun (DDP; the
batch divides by the world size; rank 0 exports):

    torchrun --nproc_per_node 8 -m esmdiff_tpu_torch.cli.train_vqvae \\
        --input data/targets --output ckpt/vqvae --data_parallel

Inputs: a directory of ``.pdb`` files and/or ``.npz`` chain files
(atom_positions/atom_mask layout).  Chains shorter than 10 residues or
longer than ``--max_len`` are skipped; the others are NaN-padded to one
length, the longest rounded up to a multiple of 32.

    esmdiff-torch-train-vqvae --input data/targets --output ckpt/vqvae \\
        --scale full --steps 20000 --batch 32 --augment
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
from esmdiff_tpu_torch.parallel.mesh import (close, init_from_env,
                                             local_device, rank, world)
from esmdiff_tpu_torch.train.vqvae import (VQAugmentConfig, VQLossConfig,
                                           export_vqvae, train_vqvae)


def _geometry(scale: str):
    if scale == "tiny":       # tests / smoke
        return (EncoderConfig(d_model=64, n_heads=2, v_heads=8, n_layers=2,
                              d_out=16, n_codes=256, knn=8),
                DecoderConfig(d_model=96, n_heads=4, n_layers=3,
                              dtype="float32", predict_ptm=False))
    if scale == "mid":        # ~90M decoder
        return (EncoderConfig(d_model=256, n_heads=4, v_heads=32,
                              n_layers=2, d_out=64, knn=16),
                DecoderConfig(d_model=768, n_heads=12, n_layers=12,
                              dtype="bfloat16", predict_ptm=False,
                              remat=True))
    # full: the reference tokenizer geometry (encoder d 1024, decoder
    # d 1280 x 30 layers)
    return (EncoderConfig(),
            DecoderConfig(predict_ptm=False, remat=True))


def load_corpus(input_dir: Path, max_len: int, log=print):
    """-> (coords (N, PAD_L, 3, 3) NaN-padded float32, lengths (N,),
    names)."""
    bb_idx = [rc.atom_order["N"], rc.atom_order["CA"], rc.atom_order["C"]]
    items = []
    files = sorted(list(input_dir.glob("**/*.pdb"))
                   + list(input_dir.glob("**/*.npz")))
    for f in files:
        try:
            if f.suffix == ".npz":
                z = np.load(f, allow_pickle=True)
                pos = z["atom_positions"].astype(np.float32)
                msk = z["atom_mask"]
                bb = pos[:, bb_idx, :].copy()
                bb[msk[:, bb_idx] < 0.5] = np.nan
            else:
                got = protein_io.from_pdb_file(f)
                prot = got[0] if isinstance(got, list) else got
                bb = prot.backbone_coords()
        except Exception as e:  # noqa: BLE001 — skip what does not parse
            log(f"[corpus] skip {f.name}: {e}")
            continue
        L = bb.shape[0]
        if L < 10 or L > max_len:
            log(f"[corpus] skip {f.name}: L={L}")
            continue
        items.append((f.stem, bb))
    if not items:
        raise SystemExit(f"no usable structures under {input_dir}")
    pad_l = max(bb.shape[0] for _, bb in items)
    pad_l = (pad_l + 31) // 32 * 32            # one padded length
    coords = np.full((len(items), pad_l, 3, 3), np.nan, np.float32)
    lengths = np.zeros((len(items),), np.int32)
    for i, (_, bb) in enumerate(items):
        coords[i, :bb.shape[0]] = bb
        lengths[i] = bb.shape[0]
    return coords, lengths, [n for n, _ in items]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train the VQ-VAE structure tokenizer jointly "
                    "(encoder + codebook + decoder), PyTorch port.")
    p.add_argument("--input", type=str, required=True,
                   help="dir of .pdb and/or .npz chain files")
    p.add_argument("--output", type=str, required=True,
                   help="output vqvae checkpoint dir (--vqvae_ckpt format)")
    p.add_argument("--scale", type=str, default="mid",
                   choices=["tiny", "mid", "full"])
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--beta", type=float, default=0.25,
                   help="commitment weight")
    p.add_argument("--recon", type=str, default="drmsd",
                   choices=["drmsd", "kabsch"])
    p.add_argument("--max_len", type=int, default=512)
    p.add_argument("--val_frac", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--restart_every", type=int, default=500,
                   help="dead-code restart interval (0 = off)")
    p.add_argument("--data_parallel", action="store_true",
                   help="one process per card under torchrun (DDP); "
                        "--batch is the global batch")
    p.add_argument("--augment", action="store_true",
                   help="train-batch crop/jitter/rotation augmentation "
                        "(VQAugmentConfig defaults)")
    p.add_argument("--aug_crop", type=float, default=0.5,
                   help="P(random contiguous crop) per structure")
    p.add_argument("--aug_crop_min", type=int, default=32)
    p.add_argument("--aug_jitter", type=float, default=0.05,
                   help="Gaussian coordinate noise stddev, Å")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions.")
    args = p.parse_args(argv)
    device = resolve_device(local_device(args.device))
    opened = init_from_env(device) if args.data_parallel else False
    try:
        return _run(args, device)
    finally:
        close(opened)


def _run(args, device):
    say = print if rank() == 0 else (lambda *a, **k: None)
    enc_cfg, dec_cfg = _geometry(args.scale)
    coords, lengths, names = load_corpus(Path(args.input), args.max_len,
                                         log=say)
    N = len(names)
    rs = np.random.RandomState(args.seed)
    n_val = max(1, int(N * args.val_frac)) if N >= 4 else 0
    val_idx = rs.permutation(N)[:n_val] if n_val else None
    say(f"[train_vqvae] {N} structures (pad_L={coords.shape[1]}, "
        f"{n_val} val), scale={args.scale}, {args.steps} steps "
        f"@ B={args.batch}" + (f" over {world()} ranks"
                               if args.data_parallel else ""))

    t0 = time.time()
    res = train_vqvae(
        enc_cfg, dec_cfg, coords, lengths, steps=args.steps,
        batch=args.batch, lr=args.lr,
        loss_cfg=VQLossConfig(beta=args.beta, recon=args.recon),
        seed=args.seed, restart_every=args.restart_every, val_idx=val_idx,
        data_parallel=args.data_parallel,
        augment=VQAugmentConfig(
            crop=args.aug_crop, crop_min=args.aug_crop_min,
            jitter=args.aug_jitter) if args.augment else None,
        device=device)
    summary = {
        "n_structures": N, "steps": args.steps,
        "final_loss": res.losses[-1],
        "n_live_codes": res.n_live_codes, "n_codes": enc_cfg.n_codes,
        "wall_s": round(time.time() - t0, 1),
    }
    if rank() == 0:
        out = Path(args.output)
        export_vqvae(out, enc_cfg, dec_cfg, res.params)
        (out / "train_summary.json").write_text(
            json.dumps(summary, indent=2))
        print(f"[train_vqvae] done: {json.dumps(summary)} -> {out}")
    return summary

if __name__ == "__main__":
    main()
