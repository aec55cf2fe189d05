#!/usr/bin/env python3
"""Smoke run of the PyTorch port (esmdiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each of which fails loudly (no error is caught):
  1. build every CUDA kernel from the repo's sources (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (bf16, random lengths with one empty row; max|d| <=
     2e-2 and mean|d| <= 2e-3), and time the kernel, the plain version and
     the one PyTorch library call that computes the same function (a
     yardstick only: the port never calls it), beside the bound from the
     bytes and tensor-core flops that this run's lengths need;
  3. drive the main path: a full-width ESM3Runtime.random_init (1.4B trunk
     + 30 x 1280 decoder, seed 0) through the port's CLI, ddpm, 25 steps,
     100 samples of BPTI -> a 100-MODEL PDB, timed after one untimed
     request at the same shapes, with every kernel launch counted; then one full-width trunk forward with the kernel against the
     same forward with the plain version (within twice the spread of two
     plain roundings);
  4. print the card, the main path's numbers, the kernels line, and as the
     last line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA card or without the
rest of the repo beside it.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12   # HBM3
TOL_MAX, TOL_MEAN = 2e-2, 2e-3
TARGET = "data/targets/bpti"
NUM_SAMPLES, NUM_STEPS, DECODE_BATCH = 100, 25, 32


def cuda_ms(torch, fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash_attention(torch, fa, B, L, H, gen):
    """Kernel vs plain version (and the SDPA yardstick) at one shape."""
    import torch.nn.functional as F

    Dh = fa.HEAD_DIM
    q, k, v = (torch.randn(B, L, H, Dh, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    lengths = torch.randint(1, L + 1, (B,), device="cuda", dtype=torch.int32,
                            generator=gen)
    lengths[0] = 0
    out = fa.flash_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    ref = fa.flash_attention_reference(q, k, v, lengths)
    diff = (out.float() - ref.float()).abs()
    max_err, mean_err = diff.max().item(), diff.mean().item()
    if not (torch.isfinite(out).all() and max_err <= TOL_MAX
            and mean_err <= TOL_MEAN):
        raise AssertionError(
            f"flash_attention disagrees with its plain version at "
            f"B={B} L={L} H={H}: max {max_err} mean {mean_err}")
    key_ok = torch.arange(L, device="cuda")[None, :] < lengths[:, None]
    bias = torch.zeros(B, 1, 1, L, device="cuda", dtype=torch.bfloat16)
    bias.masked_fill_(~key_ok[:, None, None, :], -1e9)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lens = lengths.tolist()
    keys = sum(n if n >= 1 else L for n in lens)   # keys the data needs
    flops = 4.0 * L * keys * Dh * H                # q.k^T and p.v
    # q read and o written in full; k and v only for the keys needed
    nbytes = ((2 * q.numel() + 2 * keys * H * Dh) * q.element_size()
              + lengths.numel() * lengths.element_size())
    t_flops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return {
        "B": B, "L": L, "H": H, "Dh": Dh,
        "max_abs_err": max_err, "mean_abs_err": mean_err,
        "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v, lengths)),
        "plain_ms": cuda_ms(
            torch, lambda: fa.flash_attention_reference(q, k, v, lengths)),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias)),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops > t_bytes else "bytes",
    }


def check_pdb(path: Path, n_models: int, n_atoms: int):
    lines = path.read_text().splitlines()
    models = sum(line.startswith("MODEL") for line in lines)
    atoms = [line for line in lines if line.startswith("ATOM")]
    xyz = [float(a[c:c + 8]) for a in atoms for c in (30, 38, 46)]
    if models != n_models or len(atoms) != n_atoms or not all(
            math.isfinite(x) for x in xyz):
        raise AssertionError(f"{path}: {models} MODELs (want {n_models}), "
                             f"{len(atoms)} atoms (want {n_atoms})")


def trunk_kernel_vs_plain(torch, runtime, attention_module, fa):
    """One full-width trunk forward on two BPTI rows three times: with the
    kernel, with its plain version, and with the plain path's other
    rounding (the JAX ``_xla_attention`` form, which normalises p before
    the bf16 cast).  Returns the relative L2 difference of the logits,
    kernel vs plain version, and the floor that the two plain roundings
    give: through 48 random bf16 layers a 1-ulp difference grows, so the
    kernel is held to the spread of two equally valid roundings."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein

    seq = runtime.seq_tokenizer.encode(
        ESMProtein.from_pdb(ROOT / TARGET / "bpti.pdb").sequence)
    toks = torch.full((2, 64), 1, dtype=torch.long, device="cuda")
    toks[:, :len(seq)] = torch.as_tensor(seq, device="cuda")
    lengths = torch.tensor([len(seq), 40], dtype=torch.int32, device="cuda")

    def normalised_first(q, k, v, lens):
        key_ok = torch.arange(q.shape[1], device="cuda")[None, :] < lens[:, None]
        return attention_module.plain_attention(
            q, k, v, mask=key_ok[:, None, None, :])

    logits = []
    for attn in (fa.flash_attention, fa.flash_attention_reference,
                 normalised_first):
        attention_module.flash_attention = attn
        try:
            with torch.no_grad():
                out = runtime.trunk(sequence_tokens=toks, lengths=lengths)
        finally:
            attention_module.flash_attention = fa.flash_attention
        logits.append(out.structure_logits[0, :len(seq)])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return rel(logits[0], logits[1]), rel(logits[2], logits[1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from esmdiff_tpu_torch.api.generation import plan_batches
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
    from esmdiff_tpu_torch.cli import sample as cli
    from esmdiff_tpu_torch.models.esm3 import ESM3Config
    from esmdiff_tpu_torch.nn import attention as attention_module
    from esmdiff_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them

    # 1. build
    t0 = time.time()
    fa.build()
    print(f"[build] flash_attention: {time.time() - t0:.2f} s")
    print(fa.build_log.strip(), flush=True)

    # 2. kernels against their plain versions, at the main path's shapes
    # (trunk B=64 L=64 H=24; decoder B=32 L=64 H=20) and the JAX package's
    # own flash lengths (512, 1024)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [check_flash_attention(torch, fa, B, L, H, gen)
              for B, L, H in ((64, 64, 24), (32, 64, 20), (16, 512, 24),
                              (4, 1024, 24))]
    for s in shapes:
        print("[kernel] flash_attention " + json.dumps(s), flush=True)

    # 3. the main path, every launch counted
    out_dir = ROOT / "output" / "chip_smoke"
    t0 = time.time()
    runtime = ESM3Runtime.random_init(
        seed=0, trunk_cfg=ESM3Config(head_type="structure"), device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    n_params = sum(p.numel() for p in runtime.trunk.parameters())

    def run_cli(out, num_steps):
        return cli.main(["--input", str(ROOT / TARGET), "--output", str(out),
                         "--mode", "ddpm", "--num_steps", str(num_steps),
                         "--num_samples", str(NUM_SAMPLES), "--seed", "0"],
                        runtime=runtime)[0]

    # one untimed request at the same batches and L (cuBLAS set-up and
    # allocator growth fall outside the timed one), then the counted run
    run_cli(ROOT / "output" / "chip_smoke_warmup", 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    report = run_cli(out_dir, NUM_STEPS)
    launches = fa.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    L_w = report["L"] + 2
    batches = plan_batches(L_w, NUM_SAMPLES, policy="single")
    chunks = -(-NUM_SAMPLES // DECODE_BATCH)
    expected = (runtime.trunk.cfg.n_layers * (NUM_STEPS + 1) * len(batches)
                + runtime.decoder.cfg.n_layers * chunks)
    if launches != expected:
        raise AssertionError(f"flash_attention launched {launches} times on "
                             f"the main path, expected {expected}")
    check_pdb(out_dir / "bpti.pdb", NUM_SAMPLES,
              NUM_SAMPLES * (report["L"] * 4 - 1))
    rel, floor = trunk_kernel_vs_plain(torch, runtime, attention_module, fa)
    if not rel <= 2 * floor:
        raise AssertionError(f"full-width trunk logits, kernel vs plain "
                             f"version: relative L2 {rel}, more than twice "
                             f"the two plain roundings' {floor}")
    steps = len(batches) * (NUM_STEPS + 1)
    print("[main path] " + json.dumps({
        "card": card, "trunk_params": n_params, "batches": batches,
        "decode_chunks": chunks, "init_s": init_s,
        "sampling_s": report["sampling_sec"], "total_s": report["total_sec"],
        "conformations_per_s": NUM_SAMPLES / report["total_sec"],
        "ms_per_step": 1e3 * report["sampling_sec"] / steps,
        "peak_memory_gib": peak_gib, "flash_attention_launches": launches,
        "trunk_logits_rel_l2_kernel_vs_plain": rel,
        "trunk_logits_rel_l2_plain_roundings": floor}), flush=True)

    # 4. the kernels line (headline shape: the trunk's), the device line
    head = shapes[0]
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "esmdiff_tpu_torch/csrc/flash_attention.cu",
        "replaces": "esmdiff_tpu/ops/flash_attention.py:37",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
