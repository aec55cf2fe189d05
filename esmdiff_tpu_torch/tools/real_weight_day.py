"""Real-weight-day runbook on the port: from the published PyTorch files to
a verified, quant-checked sampler (port of ``scripts/real_weight_day.py``).

Stages (all by default; ``--stages`` selects):

  download      check that the expected files exist and name their public
                sources; it fetches nothing
  verify        ``esmdiff-torch-verify`` of every file given (the trunk,
                the release, the VQ encoder and decoder): a hard gate at
                ``--tol`` on the worst per-layer relative diff
  convert       ``vqvae_from_reference`` (ESM3's VQ files -> a
                ``--vqvae_ckpt`` directory), ``load_runtime`` of the
                release (else the trunk) with it, and a sampling probe
                through ``esmdiff-torch-sample`` (ddpm on a release, gibbs
                on the stock trunk) that writes a multi-MODEL PDB of BPTI
  quant_parity  int8 against the float trunk's structure logits on the
                converted weights at five masking levels (argmax agreement,
                KL, max |d|), gated at ``--quant_gate``

``--fixture`` runs the chain on seeded reference-layout files at tiny
width (``convert/verify.py``'s generators, written as real ``.pt`` files:
the stock trunk, a Lightning release with ``net.*`` and
``sigma_embedder.*``, the VQ encoder and decoder).

    python -m esmdiff_tpu_torch.tools.real_weight_day \\
        --trunk esm3_sm_open_v1.pth --release release_v0.pt \\
        --vq_encoder esm3_structure_encoder_v0.pth \\
        --vq_decoder esm3_structure_decoder_v0.pth
    python -m esmdiff_tpu_torch.tools.real_weight_day --fixture --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from esmdiff_tpu_torch.convert import checkpoints, torch_ckpt
from esmdiff_tpu_torch.convert import verify as V
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig

ROOT = Path(__file__).resolve().parents[2]
BPTI_DIR = ROOT / "data" / "targets" / "bpti"
STAGES = ["download", "verify", "convert", "quant_parity"]
DOWNLOAD_NOTES = """\
[download] expected checkpoint files (reference README.md:60-65, net.py:358):
  trunk        esm3_sm_open_v1 state dict (HF hub EvolutionaryScale/esm3:
               data/weights/esm3_sm_open_v1.pth)
  vq_encoder   esm3_structure_encoder_v0.pth   (same HF snapshot)
  vq_decoder   esm3_structure_decoder_v0.pth   (same HF snapshot)
  release      release_v0.pt, the paper's fine-tuned ESMDiff weights
               (reference README.md:60; optional)
"""


def fixture_configs() -> dict:
    """The fixture's tiny geometry: the trunk (both head types), the VQ
    encoder and decoder (the JAX runbook's)."""
    cfgs = V.fixture_configs("tiny")
    return {"stock": cfgs["trunk"],
            "release": dataclasses.replace(cfgs["trunk"],
                                           head_type="structure"),
            "vq_encoder": cfgs["vqvae_encoder"],
            "vq_decoder": DecoderConfig(d_model=64, n_heads=4, n_layers=3,
                                        dtype="float32")}


def write_fixture_files(root: Path) -> dict:
    """The seeded reference-layout files of ``--fixture``: {name: path}."""
    cfgs = fixture_configs()
    root.mkdir(parents=True, exist_ok=True)
    stock, release = V.make_reference_trunk_state_dicts(
        [cfgs["stock"], cfgs["release"]])
    sigma = V.make_reference_sigma_embedder_state_dict(
        cfgs["release"].d_model, seed=1)
    objs = {"trunk": stock,
            "release": V.release_checkpoint(release, sigma),
            "vq_encoder": V.make_reference_encoder_state_dict(
                cfgs["vq_encoder"]),
            "vq_decoder": V.make_reference_decoder_state_dict(
                cfgs["vq_decoder"])}
    paths = {}
    for name, obj in objs.items():
        paths[name] = str(root / f"{name}.pt")
        torch.save(obj, paths[name])
    return paths


def stage_download(args) -> dict:
    if args.fixture:
        paths = write_fixture_files(Path(args.workdir) / "fixture_weights")
        print(f"[download] fixture weights -> {Path(paths['trunk']).parent}")
        return paths
    print(DOWNLOAD_NOTES)
    paths = {"trunk": args.trunk, "vq_encoder": args.vq_encoder,
             "vq_decoder": args.vq_decoder, "release": args.release}
    missing = [k for k, v in paths.items()
               if v is not None and not Path(v).is_file()]
    missing += [k for k in ("trunk", "vq_encoder", "vq_decoder")
                if not paths[k]]
    if missing:
        raise SystemExit(f"[download] missing checkpoint files: "
                         f"{sorted(set(missing))}: fetch them (above) and "
                         f"run again")
    print(f"[download] all present: "
          f"{ {k: v for k, v in paths.items() if v} }")
    return paths


def _gate(rows, label: str, tol: float) -> float:
    worst = max(r["rel_diff"] for r in rows)
    if worst > tol:
        raise SystemExit(f"[verify] {label}: worst rel diff {worst:.3e} > "
                         f"tol {tol:.1e}: the conversion disagrees with the "
                         f"torch oracle; do not serve these weights")
    print(f"[verify] {label}: {len(rows)} rows, worst rel diff "
          f"{worst:.3e} <= {tol:.0e}")
    return worst


def stage_verify(args, paths) -> dict:
    vq = fixture_configs() if args.fixture else {
        "vq_encoder": EncoderConfig(), "vq_decoder": DecoderConfig()}
    worst = {}
    for name in ("trunk", "release"):
        if paths.get(name):
            sd = torch_ckpt.load_torch_state_dict(paths[name])
            cfg = checkpoints.file_configs(sd)["trunk_cfg"]
            worst[name] = _gate(V.verify_trunk(sd, cfg, device=args.device),
                                name, args.tol)
    worst["vq_encoder"] = _gate(V.verify_vqvae_encoder(
        torch_ckpt.load_torch_state_dict(paths["vq_encoder"]),
        vq["vq_encoder"], device=args.device), "vq_encoder", args.tol)
    worst["vq_decoder"] = _gate(V.verify_vqvae_decoder(
        torch_ckpt.load_torch_state_dict(paths["vq_decoder"]),
        vq["vq_decoder"], device=args.device), "vq_decoder", args.tol)
    return worst


def stage_convert(args, paths):
    """(runtime, the runtime's trunk file): the VQ pair converted into
    ``<workdir>/vqvae``, the release (else the trunk) loaded with it, and
    the sampling probe."""
    from esmdiff_tpu_torch.cli import sample as sample_cli

    vq_dir = Path(args.workdir) / "vqvae"
    kw = ({"encoder_cfg": fixture_configs()["vq_encoder"],
           "decoder_cfg": fixture_configs()["vq_decoder"]}
          if args.fixture else {})
    checkpoints.vqvae_from_reference(paths["vq_encoder"], paths["vq_decoder"],
                                     vq_dir, **kw)
    trunk_path = paths.get("release") or paths["trunk"]
    runtime = checkpoints.load_runtime(trunk_path, vqvae_ckpt=str(vq_dir),
                                       device=args.device)
    mode = "ddpm" if runtime.trunk.cfg.head_type == "structure" else "gibbs"
    out = Path(args.workdir) / "probe"
    report = sample_cli.main(
        ["--input", str(BPTI_DIR), "--output", str(out), "--mode", mode,
         "--num_steps", "2", "--num_samples", "2", "--device",
         str(args.device)], runtime=runtime)
    pdb = out / f"{report[0]['target']}.pdb"
    n_models = sum(line.startswith("MODEL")
                   for line in pdb.read_text().splitlines())
    if n_models != 2:
        raise SystemExit(f"[convert] the probe wrote {n_models} MODELs, "
                         "not 2")
    print(f"[convert] VQ-VAE pair -> {vq_dir} (--vqvae_ckpt); {mode} probe "
          f"on {trunk_path} -> {pdb} ({n_models} MODELs)")
    return runtime, trunk_path


@torch.no_grad()
def logit_parity(runtime, qruntime, sequence: str, n_times: int = 5,
                 seed: int = 0) -> list[dict]:
    """Structure logits of two runtimes' trunks (float, int8) on the same
    8 rows of ``sequence`` at ``n_times`` masking levels from 0.2 to 1.0
    (the other structure positions random codes): argmax agreement, mean
    KL(float || int8) in nats, max |d| (``scripts/quant_parity.py``'s
    ``logit_parity``)."""
    st = runtime.seq_tokenizer.encode(sequence)
    Lw = len(st)
    L = ((Lw + 63) // 64) * 64
    seq_row = np.full((L,), C.SEQUENCE_PAD_TOKEN, np.int64)
    seq_row[:Lw] = st
    dev = runtime.device
    seq_b = torch.as_tensor(np.tile(seq_row[None], (8, 1)), device=dev)
    rng = np.random.default_rng(seed)
    rows = []
    for frac in np.linspace(0.2, 1.0, n_times):
        toks = np.full((8, L), C.STRUCTURE_PAD_TOKEN, np.int64)
        body = rng.integers(0, C.VQVAE_CODEBOOK_SIZE, (8, L))
        body[rng.random((8, L)) < frac] = C.STRUCTURE_MASK_TOKEN
        toks[:, :Lw] = body[:, :Lw]
        toks_b = torch.as_tensor(toks, device=dev)
        lf, lq = (rt.trunk(structure_tokens=toks_b, sequence_tokens=seq_b)
                  .structure_logits.float() for rt in (runtime, qruntime))
        pf, pq = lf.log_softmax(-1), lq.log_softmax(-1)
        rows.append({
            "mask_frac": float(frac),
            "argmax_agree": float((lf.argmax(-1) == lq.argmax(-1)).float()
                                  .mean()),
            "mean_kl_nats": float((pf.exp() * (pf - pq)).sum(-1).mean()),
            "max_abs_logit_diff": float((lf - lq).abs().max())})
    return rows


def stage_quant_parity(args, paths, runtime, trunk_path) -> list[dict]:
    from esmdiff_tpu_torch.api.protein_api import ESMProtein

    qruntime = checkpoints.load_runtime(
        trunk_path, vqvae_ckpt=str(Path(args.workdir) / "vqvae"),
        device=args.device, quant="int8")
    seq = ESMProtein.from_pdb(BPTI_DIR / "bpti.pdb").sequence
    rows = logit_parity(runtime, qruntime, seq)
    for r in rows:
        print(f"[quant_parity] {r}")
    worst = min(r["argmax_agree"] for r in rows)
    if worst < args.quant_gate:
        raise SystemExit(f"[quant_parity] argmax agreement {worst:.4f} < "
                         f"{args.quant_gate}: do not serve these weights "
                         f"with --quant int8")
    print(f"[quant_parity] argmax agreement >= {args.quant_gate}: "
          f"{worst:.4f}")
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fixture", action="store_true",
                   help="Run the chain on seeded reference-layout files at "
                        "tiny width.")
    p.add_argument("--trunk", type=str, default=None)
    p.add_argument("--vq_encoder", type=str, default=None)
    p.add_argument("--vq_decoder", type=str, default=None)
    p.add_argument("--release", type=str, default=None,
                   help="Fine-tuned ESMDiff file (release_v0.pt); sampled "
                        "from when given.")
    p.add_argument("--workdir", type=str, default="output/real_weight_day")
    p.add_argument("--stages", type=str, default=",".join(STAGES))
    p.add_argument("--tol", type=float, default=V.TOL,
                   help="Max per-layer relative activation diff.")
    p.add_argument("--quant_gate", type=float, default=0.95,
                   help="Min int8-vs-float argmax agreement.")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        p.error(f"unknown stage(s) {unknown}; valid stages: "
                f"{', '.join(STAGES)}")
    Path(args.workdir).mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    paths = stage_download(args)
    out = {"paths": paths}
    runtime = trunk_path = None
    for s in stages:
        if s == "download":
            continue
        print(f"========== {s} ==========", flush=True)
        if s == "verify":
            out["verify"] = stage_verify(args, paths)
        elif s in ("convert", "quant_parity") and runtime is None:
            runtime, trunk_path = stage_convert(args, paths)
        if s == "quant_parity":
            out["quant_parity"] = stage_quant_parity(args, paths, runtime,
                                                     trunk_path)
    print(f"[real_weight_day] stages {stages} passed in "
          f"{time.time() - t0:.1f} s")
    return out


if __name__ == "__main__":
    main()
