"""Conformation-ensemble sampling CLI on the port.

Port of ``esmdiff_tpu/cli/sample.py``: per-target PDB in a directory -> N
sampled conformations -> one multi-MODEL PDB per target, plus
``timings.json``.  Same flags, plus ``--device`` (default ``cuda``).

Modes (``--mode``, default gibbs as in JAX):
  gibbs — iterative confidence-ranked unmasking with the stock-head trunk
  ddpm  — fine-tuned ESMDiff ancestral masked-diffusion sampling
  eb    — entropy-bounded unmasking, at most ``8 * --num_steps`` steps
  block — block diffusion with SDAR-30B-A3B (``models/sdar.py``): blocks of
          4 structure tokens, ``--num_steps`` steps a block (at most one a
          position), random weights at ``--model_scale``
          (full: the published widths, 61 GB in bf16; tiny: the test
          widths), the same VQ decode

``--quant int8`` runs the trunk's projections in W8A8 int8; ``--refine``
projects each decoded CA trace into the bond/clash validity band.
Inpainting: ``--mask_ids`` (residues to generate; ddpm and gibbs) or
``--filled_ids`` (residues to keep; ddpm) condition the ensemble on the
target's structure through the VQ-VAE encoder.  ``--ckpt`` loads a
training run of the port or a reference PyTorch file (an ESMDiff release
or the stock ``esm3_sm_open_v1`` trunk, its geometry and head type read
from the file; ``convert/checkpoints.py``),
paired with a VQ-VAE by ``--vqvae_ckpt`` (``esmdiff-torch-train-vqvae``'s
export or ``vqvae_from_reference``'s conversion; without ``--ckpt`` it
exits with an error).  With several ``--input`` directories each target
lands in ``<output>/<dir name>/``, names that collide qualified by their
parents (``a--targets``, ``b--targets``).  ``--data_parallel`` splits
each batch's rows across a replica of the trunk on every visible card (one
process; ``EnsembleSampler(devices=...)``); ``--profile DIR`` turns the
tracer (``utils/tracing.py``) on for the sampling phase and writes its
``torch.profiler`` trace, the program's spans among the kernels, to
``DIR/trace.json`` and the spans and counters, on the same clock, to
``DIR/spans.json``.
``--ckpt`` also takes a JAX package's orbax run, where tensorstore is
installed (``convert/orbax.py``).

    python -m esmdiff_tpu_torch.cli.sample --input data/targets/bpti \\
        --output output/torch --mode gibbs --num_steps 16 --num_samples 100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

import numpy as np

from esmdiff_tpu_torch.api.generation import EnsembleSampler, GenerationConfig
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.sdar import SDAR, SDARConfig
from esmdiff_tpu_torch.models.vqvae import StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import cast_matmul_weights, init_params
from esmdiff_tpu_torch.ops.refine import refine_ca_ensemble
from esmdiff_tpu_torch.utils.tracing import start_profiler, stop_profiler


def sdar_runtime(args) -> ESM3Runtime:
    """``--mode block``'s runtime: an SDAR trunk and the VQ decoder of
    ``--model_scale``, random weights from ``--seed`` built on the
    device, in bf16 (``--quant`` quantizes the ESM3 trunk only)."""
    if args.quant != "none":
        raise SystemExit("--mode block runs the SDAR trunk in bf16: "
                         "--quant applies to the ESM3 modes")
    if args.ckpt:
        raise SystemExit("--mode block runs random weights (--model_scale); "
                         "a published SDAR checkpoint loads through "
                         "esmdiff_tpu_torch.convert.sdar")
    print("[warning] sampling with RANDOM weights (throughput/dev runs "
          "only — outputs are not physical ensembles)")
    dev = resolve_device(args.device)
    tiny = args.model_scale == "tiny"
    cfg = SDARConfig.tiny(dtype="float32") if tiny else SDARConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(args.seed))
    with torch.device(dev):
        model = SDAR(cfg).init_weights(gen)
        decoder = StructureTokenDecoder(
            checkpoints.scale_configs(args.model_scale)["decoder_cfg"])
    init_params(decoder, gen)
    cast_matmul_weights(decoder)
    return ESM3Runtime(model, decoder, None, device=dev)


def build_runtime(args) -> ESM3Runtime:
    """The runtime of ``--ckpt`` (a training run of the port or a
    reference PyTorch file), or random weights at ``--model_scale``: the
    fine-tune structure head for ddpm, the stock multi-track head for
    gibbs and eb.  With ``--quant int8`` the trunk is quantized from its
    float32 weights."""
    if args.mode == "block":
        return sdar_runtime(args)
    if args.vqvae_ckpt and not args.ckpt:
        raise SystemExit("--vqvae_ckpt pairs a trained VQ-VAE with a "
                         "trunk: it needs --ckpt")
    if args.ckpt:
        return checkpoints.load_runtime(
            args.ckpt, vqvae_ckpt=args.vqvae_ckpt, device=args.device,
            quant=args.quant)
    print("[warning] no --ckpt given: sampling with RANDOM weights "
          "(throughput/dev runs only — outputs are not physical ensembles)")
    cfgs = checkpoints.scale_configs(args.model_scale)
    cfgs["trunk_cfg"] = dataclasses.replace(
        cfgs["trunk_cfg"],
        head_type="structure" if args.mode == "ddpm" else "esm3")
    return ESM3Runtime.random_init(seed=args.seed, device=args.device,
                                   quant=args.quant, **cfgs)


def get_argparser():
    p = argparse.ArgumentParser(
        description="Sample protein conformation ensembles (PyTorch port).")
    p.add_argument("--input", type=str, nargs="+",
                   default=["data/targets/bpti"],
                   help="Directories of target .pdb files.")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--vqvae_ckpt", type=str, default=None,
                   help="Trained VQ-VAE dir (convert.checkpoints.save_vqvae "
                        "layout) to pair with --ckpt.")
    p.add_argument("--output", type=str, default="output/inference_esmdiff")
    p.add_argument("--mode", type=str, default="gibbs",
                   choices=["gibbs", "ddpm", "eb", "block"],
                   help="gibbs = cosine-schedule iterative unmasking; "
                        "ddpm = fine-tuned masked-diffusion; eb = adaptive "
                        "entropy-bounded unmasking; block = SDAR block "
                        "diffusion.")
    p.add_argument("--num_steps", type=int, default=25)
    p.add_argument("--num_samples", type=int, default=10)
    p.add_argument("--mask_ids", type=str, default=None,
                   help="Comma-separated 0-based residue indices to "
                        "inpaint (ddpm and gibbs).")
    p.add_argument("--filled_ids", type=str, default=None,
                   help="Comma-separated residue indices to KEEP, every "
                        "other one generated (ddpm only).")
    p.add_argument("--temperature", type=float, default=1.4)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--entropy_budget", type=float, default=1.0)
    p.add_argument("--ref_compat", action="store_true",
                   help="ddpm inpainting: mask TOKEN idx of the BOS-led "
                        "row (residue idx-1), as the reference sampler "
                        "does; the default masks residue idx.")
    p.add_argument("--quant", type=str, default="none",
                   choices=["none", "int8"],
                   help="int8 = W8A8 trunk projections (ops/quant.py).")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_scale", type=str, default="full",
                   choices=["full", "tiny"],
                   help="Trunk size when no ckpt is given.")
    p.add_argument("--max_batch", type=int, default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="Split each batch's rows across a replica of the "
                        "trunk on every visible card.")
    p.add_argument("--profile", type=str, default=None,
                   help="Directory for a torch.profiler trace of the "
                        "sampling phase with the program's spans "
                        "(trace.json) and the spans and counters on the "
                        "same clock (spans.json).")
    p.add_argument("--skip_existing", action="store_true",
                   help="Skip targets whose output PDB already exists.")
    p.add_argument("--refine", action="store_true",
                   help="Project each decoded CA trace into the bond/clash "
                        "validity band (ops/refine.py), shifting every "
                        "residue's atoms rigidly with its CA.")
    p.add_argument("--plan", type=str, default="single",
                   choices=["single", "ladder", "even"],
                   help="Batch planning: 'single' = one batch size per "
                        "length bucket; 'ladder' = fewest surplus rows; "
                        "'even' = the fewest batches the cap allows.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions.")
    return p


def main(argv=None, runtime: ESM3Runtime | None = None):
    """Run the CLI; ``runtime`` optionally supplies an already built
    runtime in place of the one ``--ckpt``/``--model_scale`` describe.
    With ``--quant int8`` a runtime whose trunk is not int8 yet is
    quantized, which raises on matmul weights held in bf16: build such a
    runtime with ``build_runtime`` or ``random_init(quant="int8")``."""
    args = get_argparser().parse_args(argv)
    data_paths = [Path(p) for p in args.input]
    for dp in data_paths:
        assert dp.is_dir(), f"--input must be a directory: {dp}"
    resolved = [dp.resolve() for dp in data_paths]
    if len(set(resolved)) != len(resolved):
        raise SystemExit("--input lists the same directory twice")
    multi_input = len(data_paths) > 1
    output_dir = Path(args.output)
    output_dir.mkdir(parents=True, exist_ok=True)

    if runtime is None:
        runtime = build_runtime(args)
    elif args.quant == "int8" and runtime.trunk.cfg.quant != "int8":
        runtime = runtime.quantize("int8")
    if args.quant == "int8":
        print("[quant] trunk projections running W8A8 int8")
    devices = None
    if args.data_parallel:
        devices = data_parallel_devices(runtime)
        print(f"[data_parallel] sampling across {len(devices)} device(s)")
    sampler = EnsembleSampler(runtime, plan_policy=args.plan,
                              devices=devices)
    mask_ids = ([int(i) for i in args.mask_ids.split(",")]
                if args.mask_ids else None)
    filled_ids = ([int(i) for i in args.filled_ids.split(",")]
                  if args.filled_ids else None)

    targets = []
    for dp, rp in zip(data_paths, resolved):
        sub = output_dir / subdir_name(rp, resolved) if multi_input \
            else output_dir
        sub.mkdir(parents=True, exist_ok=True)
        targets += [(p, sub) for p in sorted(dp.iterdir())
                    if p.suffix == ".pdb"]
    # a --skip_existing resume merges into the earlier report; rows from
    # before the report had keys are keyed by their target
    timings_path = output_dir / "timings.json"
    prior: dict[str, dict] = {}
    if args.skip_existing and timings_path.exists():
        for r in json.loads(timings_path.read_text()):
            r.setdefault("key", r["target"])
            prior[r["key"]] = r
    report = []
    profiler = start_profiler(runtime.device) if args.profile else None
    for path, out_dir_t in targets:
        key = f"{out_dir_t.name}/{path.stem}" if multi_input else path.stem
        out_file = out_dir_t / f"{path.stem}.pdb"
        if args.skip_existing and out_file.exists():
            print(f"[{key}] exists, skipped (--skip_existing)")
            continue
        prot = ESMProtein.from_pdb(path)
        seq = prot.sequence
        _sync(runtime.device)
        t0 = time.time()
        if args.mode == "eb":
            tokens = sampler.eb_ensemble(
                seq, args.num_samples, entropy_budget=args.entropy_budget,
                temperature=args.temperature, top_p=args.top_p,
                max_steps=args.num_steps * 8, seed=args.seed,
                max_batch=args.max_batch)
        elif args.mode == "gibbs":
            tokens = sampler.gibbs_ensemble(
                seq, args.num_samples,
                config=GenerationConfig(num_steps=args.num_steps,
                                        temperature=args.temperature,
                                        top_p=args.top_p),
                seed=args.seed,
                coordinates=prot.coordinates if mask_ids else None,
                mask_ids=mask_ids, max_batch=args.max_batch)
        elif args.mode == "block":
            tokens = sampler.block_ensemble(
                seq, args.num_samples, steps=args.num_steps,
                temperature=args.temperature,
                seed=args.seed, max_batch=args.max_batch)
        else:
            structure_tokens = None
            if mask_ids or filled_ids:
                structure_tokens = runtime.encode(prot).structure
            tokens = sampler.ddpm_ensemble(
                seq, args.num_samples, num_steps=args.num_steps,
                seed=args.seed, mask_ids=mask_ids, filled_ids=filled_ids,
                structure_tokens=structure_tokens, max_batch=args.max_batch,
                ref_compat=args.ref_compat)
        t_tokens = time.time() - t0
        prots = sampler.decode_ensemble(seq, tokens)
        if args.refine:
            refine_in_place(prots, runtime.device)
        t_total = time.time() - t0
        protein_io.ensemble_to_pdb_file(
            [p.to_protein() for p in prots], out_file)
        print(f"[{key}] {args.num_samples} samples x "
              f"{args.num_steps} steps: tokens {t_tokens:.2f}s, "
              f"total {t_total:.2f}s -> {out_file}")
        report.append({
            "target": path.stem, "key": key, "L": len(seq),
            "mode": args.mode, "num_samples": args.num_samples,
            "sampling_sec": t_tokens, "total_sec": t_total,
            **({"eb_steps": list(sampler.eb_steps)} if args.mode == "eb"
               else {}),
        })
    if profiler is not None:
        _sync(runtime.device)
        print(f"[profile] trace written to "
              f"{stop_profiler(profiler, Path(args.profile))}")
    prior.update({r["key"]: r for r in report})
    timings_path.write_text(
        json.dumps(sorted(prior.values(), key=lambda r: r["key"]), indent=2))
    return report


def subdir_name(rp: Path, resolved: list[Path]) -> str:
    """The output subdirectory of the resolved input directory ``rp``
    among ``resolved``: its name, or, where names collide, its path's
    last k parts joined by ``--`` for the least k that tells every
    colliding directory apart.  It depends on the paths alone, not on
    their order, so a resume with the directories reordered maps each to
    the same subdirectory."""
    same = [p for p in resolved if p.name == rp.name]
    if len(same) == 1:
        return rp.name
    k = 2
    while len({"--".join(p.parts[-k:]) for p in same}) != len(same):
        k += 1
    return "--".join(rp.parts[-k:]).replace("/", "--")


def refine_in_place(prots: list[ESMProtein], device) -> None:
    """Project each conformation's CA trace into the validity band
    (ops/refine.py) and translate every residue's atoms rigidly by its CA
    displacement."""
    ca = np.stack([p.coordinates[:, 1] for p in prots])
    shift = np.nan_to_num(refine_ca_ensemble(ca, device=device) - ca,
                          nan=0.0)
    for p, s in zip(prots, shift):
        p.coordinates += s[:, None, :]


def data_parallel_devices(runtime: ESM3Runtime) -> list:
    """Every visible card when the runtime is on one; else the runtime's
    device alone."""
    if runtime.device.type != "cuda":
        return [runtime.device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
