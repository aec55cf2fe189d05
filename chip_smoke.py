#!/usr/bin/env python3
"""Smoke run of the PyTorch port (esmdiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, each of which fails loudly (no error is caught):
  1. build every CUDA kernel from the repo's sources (one nvcc per source,
     all started together, sm_90a) and print each build's ptxas report,
     and a [ptxas] line per kernel (registers, spills);
  2. hold each kernel against its plain PyTorch version on the card (bf16,
     unit-normal inputs; the attention kernels at random lengths with one
     empty row, at the trunk's and the decoder's shapes and longer L; the
     fused LN/projection kernels on layer 0's weights of the full-width
     runtime, at a row count that is not a multiple of the row tile too,
     and at T/M 64; both also at D 512 on random weights, H 1536 for
     fused_ffn), and time, in device time (tools/timing.py), the kernel,
     the plain version and the PyTorch library call that computes the same
     function, or for the fused projections only their products (a
     yardstick: the port never calls it), beside the bound from the bytes
     and operations this run needs, and the host time of one call (200
     calls back to back, no synchronise); the attention kernels also with
     the heads a block (G) and the grid they launch;
  3. the default path: a full-width ESM3Runtime.random_init (1.4B trunk +
     30 x 1280 decoder, seed 0) through the port's CLI, ddpm, 25 steps, 100
     samples of BPTI -> a 100-MODEL PDB, timed after one untimed request at
     the same shapes, with every kernel launch counted; then one full-width
     trunk forward with the kernel against the same forward with its plain
     version (within twice the spread of two plain roundings; the patched
     ops must launch their kernels in the kernel forward only);
  4. the fused path: the same trunk weights in the configuration
     qkv_backend="fused", attn_backend="small" (the decoder and the sigma
     embedder shared), driven and checked the same way;
  5. print the card, each path's numbers, the kernels line, and as the last
     line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA card or without the
rest of the repo beside it.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

from esmdiff_tpu_torch.tools.timing import device_ms, host_ms

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM, 700 W
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
# kernel vs plain version, bf16: max |d| <= TOL_MAX and mean |d| <= TOL_MEAN;
# for the D=1536 LayerNorm/projection kernels max |d| is taken relative to
# max(1, |plain|), since one bf16 ulp at |y| >= 4 is 0.03
TOL_MAX, TOL_MEAN = 2e-2, 2e-3
TARGET = "data/targets/bpti"
NUM_SAMPLES, NUM_STEPS, DECODE_BATCH = 100, 25, 32
KERNELS = ("flash_attention", "small_attention", "fused_qkv", "fused_ffn")
REPLACES = {
    "flash_attention": "esmdiff_tpu/ops/flash_attention.py:37",
    "small_attention": "esmdiff_tpu/ops/small_attention.py:55",
    "fused_qkv": "esmdiff_tpu/ops/fused_qkv.py:41",
    "fused_ffn": "esmdiff_tpu/ops/fused_ffn.py:34",
}


def bound(flops, nbytes, fp32_flops=0.0):
    """Least time for the work: tensor-core and fp32 operations at their
    peaks against the bytes at the memory rate."""
    t_ops = flops / H100_BF16_FLOPS + fp32_flops / H100_FP32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def compare(torch, name, out, ref, shape, relative=False):
    """max/mean |kernel - plain|; raise outside the tolerance."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    max_err, mean_err = diff.max().item(), diff.mean().item()
    scaled = (diff / ref.float().abs().clamp_min(1.0)).max().item() \
        if relative else max_err
    if not (torch.isfinite(out).all() and scaled <= TOL_MAX
            and mean_err <= TOL_MEAN):
        raise AssertionError(
            f"{name} disagrees with its plain version at {shape}: max "
            f"{max_err} (relative {scaled}) mean {mean_err}")
    return {"max_abs_err": max_err, "mean_abs_err": mean_err,
            **({"max_rel_err": scaled} if relative else {})}


def attention_inputs(torch, B, L, H, gen):
    q, k, v = (torch.randn(B, L, H, 64, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    lengths = torch.randint(1, L + 1, (B,), device="cuda", dtype=torch.int32,
                            generator=gen)
    lengths[0] = 0
    return q, k, v, lengths


def attention_cost(q, lengths, extra_bytes=0):
    """Tensor-core flops and bytes of masked attention at these lengths:
    q read and o written in full, k and v only for the keys needed."""
    B, L, H, Dh = q.shape
    keys = sum(n if n >= 1 else L for n in lengths.tolist())
    flops = 4.0 * L * keys * Dh * H                # q.k^T and p.v
    nbytes = ((2 * q.numel() + 2 * keys * H * Dh) * q.element_size()
              + lengths.numel() * lengths.element_size() + extra_bytes)
    return flops, nbytes


def sdpa_ms(torch, q, k, v, lengths):
    """SDPA with a -1e9 additive key mask: the library yardstick."""
    import torch.nn.functional as F

    L = q.shape[1]
    key_ok = torch.arange(L, device="cuda")[None, :] < lengths[:, None]
    bias = torch.zeros(q.shape[0], 1, 1, L, device="cuda",
                       dtype=torch.bfloat16)
    bias.masked_fill_(~key_ok[:, None, None, :], -1e9)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias))


def launch_shape(fa, name, B, L, H):
    """The heads a block (G) and the grid (query tiles, head groups, B)
    with which ``name``'s kernel launches at this shape."""
    G = fa.heads_per_block(name, B, L, H, "cuda")
    return {"G": G, "grid": [-(-L // fa.TILE), -(-H // G), B]}


def check_flash_attention(torch, fa, B, L, H, gen):
    """Kernel vs plain version (and the SDPA yardstick) at one shape, with
    the heads a block takes (G) and the grid the kernel launches."""
    q, k, v, lengths = attention_inputs(torch, B, L, H, gen)
    res = compare(torch, "flash_attention", fa.flash_attention(q, k, v, lengths),
                  fa.flash_attention_reference(q, k, v, lengths), (B, L, H))
    return {
        "B": B, "L": L, "H": H, **res,
        **launch_shape(fa, "flash_attention", B, L, H),
        "ms": device_ms(lambda: fa.flash_attention(q, k, v, lengths)),
        "host_ms_per_call": host_ms(
            lambda: fa.flash_attention(q, k, v, lengths)),
        "plain_ms": device_ms(
            lambda: fa.flash_attention_reference(q, k, v, lengths)),
        "library_ms": sdpa_ms(torch, q, k, v, lengths),
        **bound(*attention_cost(q, lengths)),
    }


def check_small_attention(torch, sa, B, L, H, gen):
    """Rotary + attention kernel vs plain version; the yardstick is SDPA on
    q and k rotated beforehand (the rotation is not timed)."""
    from esmdiff_tpu_torch.nn.rotary import apply_rotary, rotary_tables
    from esmdiff_tpu_torch.ops import flash_attention as fa

    q, k, v, lengths = attention_inputs(torch, B, L, H, gen)
    cos, sin = rotary_tables(L, 64, device="cuda")
    res = compare(torch, "small_attention",
                  sa.small_attention(q, k, v, cos, sin, lengths),
                  sa.small_attention_reference(q, k, v, cos, sin, lengths),
                  (B, L, H))
    flops, nbytes = attention_cost(q, lengths,
                                   (cos.numel() + sin.numel()) * 4)
    return {
        "B": B, "L": L, "H": H, **res,
        **launch_shape(fa, "small_attention", B, L, H),
        "ms": device_ms(lambda: sa.small_attention(
            q, k, v, cos, sin, lengths)),
        "host_ms_per_call": host_ms(lambda: sa.small_attention(
            q, k, v, cos, sin, lengths)),
        "plain_ms": device_ms(lambda: sa.small_attention_reference(
            q, k, v, cos, sin, lengths)),
        "library_ms": sdpa_ms(torch, apply_rotary(q, cos, sin),
                              apply_rotary(k, cos, sin), v, lengths),
        # the rotation: 2 multiplies and an add per q and k value, fp32
        **bound(flops, nbytes, fp32_flops=6.0 * q.numel()),
    }


def qkv_weights(torch, D, gen, attn=None):
    """(ln, qkv.weight (3D, D), q_ln, k_ln): layer 0's attention weights at
    the trunk's width, else random ones of the same kind at width D."""
    if attn is not None:
        return (attn.ln.scale, attn.qkv.weight, attn.q_ln.scale,
                attn.k_ln.scale)
    w = (torch.randn(3 * D, D, device="cuda", generator=gen)
         * D ** -0.5).to(torch.bfloat16)
    ln, qs, ks = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
                  for _ in range(3))
    return ln, w, qs, ks


def check_fused_qkv(torch, fq, weights, T, gen):
    """LN + QKV + QK-LN kernel vs plain version; the yardstick is the
    (T, D) x (D, 3D) product alone.  Also the host time a call costs (the
    wrapper and the TMA descriptor it encodes)."""
    import torch.nn.functional as F

    ln, weight, qs, ks = weights
    D = weight.shape[1]
    x = torch.randn(T, D, device="cuda", dtype=torch.bfloat16, generator=gen)
    args = (x, ln, weight.t(), qs, ks)
    res = compare(torch, "fused_qkv", fq.fused_ln_qkv(*args),
                  fq.fused_ln_qkv_reference(*args), (T, D), relative=True)
    xn = fq.ln_f32(x, ln).to(torch.bfloat16)
    nbytes = (x.numel() + weight.numel() + 3 * T * D) * 2 + 3 * D * 4
    return {
        "T": T, "D": D, **res,
        "ms": device_ms(lambda: fq.fused_ln_qkv(*args)),
        "host_ms_per_call": host_ms(lambda: fq.fused_ln_qkv(*args)),
        "plain_ms": device_ms(lambda: fq.fused_ln_qkv_reference(*args)),
        "library_ms": device_ms(lambda: F.linear(xn, weight)),
        "library": "F.linear, the products only",
        # LayerNorms: about 5 fp32 operations per x and q/k value
        **bound(2.0 * T * D * 3 * D, nbytes, fp32_flops=15.0 * T * D),
    }


def ffn_weights(torch, D, H, gen, ffn=None):
    """(ln, up.weight (2H, D), down.weight (D, H)): layer 0's FFN weights
    at the trunk's width, else random ones of the same kind."""
    if ffn is not None:
        return ffn.ln.scale, ffn.up.weight, ffn.down.weight
    up = (torch.randn(2 * H, D, device="cuda", generator=gen)
          * D ** -0.5).to(torch.bfloat16)
    down = (torch.randn(D, H, device="cuda", generator=gen)
            * H ** -0.5).to(torch.bfloat16)
    return 1 + 0.1 * torch.randn(D, device="cuda", generator=gen), up, down


def check_fused_ffn(torch, ff, weights, M, gen):
    """SwiGLU FFN kernel vs plain version; the yardstick is its two
    products alone.  Also the host time a call costs (the wrapper and the
    three TMA descriptors it encodes)."""
    import torch.nn.functional as F

    ln, up, down = weights
    D, H = down.shape
    x = torch.randn(M, D, device="cuda", dtype=torch.bfloat16, generator=gen)
    args = (x, ln, up.t(), down.t())
    res = compare(torch, "fused_ffn", ff.fused_swiglu_ffn(*args),
                  ff.fused_swiglu_ffn_reference(*args), (M, D, H),
                  relative=True)
    xn = torch.randn(M, D, device="cuda", dtype=torch.bfloat16, generator=gen)
    hid = torch.randn(M, H, device="cuda", dtype=torch.bfloat16, generator=gen)
    nbytes = (2 * x.numel() + up.numel() + down.numel()) * 2 + D * 4
    return {
        "M": M, "D": D, "H": H, **res,
        "ms": device_ms(lambda: ff.fused_swiglu_ffn(*args)),
        "host_ms_per_call": host_ms(lambda: ff.fused_swiglu_ffn(*args)),
        "plain_ms": device_ms(lambda: ff.fused_swiglu_ffn_reference(*args)),
        "library_ms": device_ms(lambda: (
            F.linear(xn, up), F.linear(hid, down))),
        "library": "F.linear x 2, the products only",
        # LayerNorm and the gate: about 5 fp32 operations per value
        **bound(6.0 * M * D * H, nbytes, fp32_flops=5.0 * M * (D + H)),
    }


def ptxas_summary(log):
    """Per compiled kernel: registers, spill bytes, static shared memory
    (the attention kernels' shared memory is dynamic)."""
    import re

    entries = []
    for block in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        smem = re.search(r"(\d+) bytes smem", block)
        entries.append({
            "entry": block.split("'")[1], "registers": int(regs.group(1)),
            "spill_store_bytes": int(spill.group(1)),
            "spill_load_bytes": int(spill.group(2)),
            "static_smem_bytes": int(smem.group(1)) if smem else 0})
    return entries


def check_pdb(path: Path, n_models: int, n_atoms: int):
    lines = path.read_text().splitlines()
    models = sum(line.startswith("MODEL") for line in lines)
    atoms = [line for line in lines if line.startswith("ATOM")]
    xyz = [float(a[c:c + 8]) for a in atoms for c in (30, 38, 46)]
    if models != n_models or len(atoms) != n_atoms or not all(
            math.isfinite(x) for x in xyz):
        raise AssertionError(f"{path}: {models} MODELs (want {n_models}), "
                             f"{len(atoms)} atoms (want {n_atoms})")


def trunk_logits(torch, runtime, patches):
    """Structure logits of one full-width trunk forward on two BPTI rows
    (lengths 60 and 40), with each (module, name) in ``patches`` replaced
    by its function for the call."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein

    seq = runtime.seq_tokenizer.encode(
        ESMProtein.from_pdb(ROOT / TARGET / "bpti.pdb").sequence)
    toks = torch.full((2, 64), 1, dtype=torch.long, device="cuda")
    toks[:, :len(seq)] = torch.as_tensor(seq, device="cuda")
    lengths = torch.tensor([len(seq), 40], dtype=torch.int32, device="cuda")
    saved = {key: getattr(*key) for key in patches}
    for (module, name), fn in patches.items():
        setattr(module, name, fn)
    try:
        with torch.no_grad():
            out = runtime.trunk(sequence_tokens=toks, lengths=lengths)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)
    return out.structure_logits[0, :len(seq)]


def kernel_vs_plain(torch, runtime, kernel, plain, other):
    """Relative L2 of the trunk logits with the kernels against their plain
    versions, and the floor: the plain versions against the plain path's
    other rounding (the JAX package's unfused forms).  Through 48 random
    bf16 layers a 1-ulp difference grows, so the kernels are held to the
    spread of two equally valid roundings.  The patched ops' kernels must
    launch in the kernel forward and in no other."""
    ops = {module for module, _ in plain}
    logits = []
    for patches in (kernel, plain, other):
        before = sum(op.launches for op in ops)
        logits.append(trunk_logits(torch, runtime, patches))
        if (sum(op.launches for op in ops) > before) != (patches is kernel):
            raise AssertionError("the logits gate's patches missed the "
                                 "kernels' call sites")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return rel(logits[0], logits[1]), rel(logits[2], logits[1])


def drive(torch, runtime, ops, name, expected, out_dir):
    """One untimed request, then the counted and timed one through the CLI;
    checks each kernel's launches and the PDB, returns the path's numbers."""
    from esmdiff_tpu_torch.cli import sample as cli

    def run_cli(out, num_steps):
        return cli.main(["--input", str(ROOT / TARGET), "--output", str(out),
                         "--mode", "ddpm", "--num_steps", str(num_steps),
                         "--num_samples", str(NUM_SAMPLES), "--seed", "0"],
                        runtime=runtime)[0]

    # one untimed request at the same batches and L (cuBLAS set-up and
    # allocator growth fall outside the timed one), then the counted run
    run_cli(out_dir.with_name(out_dir.name + "_warmup"), 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for op in ops.values():
        op.launches = 0
    report = run_cli(out_dir, NUM_STEPS)
    launches = {k: op.launches for k, op in ops.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches}, expected "
                             f"{expected}")
    check_pdb(out_dir / "bpti.pdb", NUM_SAMPLES,
              NUM_SAMPLES * (report["L"] * 4 - 1))
    return report, launches, peak_gib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from esmdiff_tpu_torch.api.generation import plan_batches
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
    from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config, esm3_open_small
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
    from esmdiff_tpu_torch.nn.layers import cast_matmul_weights
    from esmdiff_tpu_torch.nn.rotary import apply_rotary
    from esmdiff_tpu_torch.ops import _build
    from esmdiff_tpu_torch.ops import flash_attention as fa
    from esmdiff_tpu_torch.ops import fused_ffn as ff
    from esmdiff_tpu_torch.ops import fused_qkv as fq
    from esmdiff_tpu_torch.ops import small_attention as sa

    ops = {"flash_attention": fa, "small_attention": sa, "fused_qkv": fq,
           "fused_ffn": ff}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them

    # 1. build, one nvcc per source, all at once
    t0 = time.time()
    _build.build(*KERNELS)
    print(f"[build] {', '.join(KERNELS)}: {time.time() - t0:.2f} s")
    for name in KERNELS:
        print(f"[build] {name}.cu ptxas:\n{_build.logs[name].strip()}",
              flush=True)
        for entry in ptxas_summary(_build.logs[name]):
            print(f"[ptxas] {name} " + json.dumps(entry), flush=True)

    t0 = time.time()
    runtime = ESM3Runtime.random_init(
        seed=0, trunk_cfg=ESM3Config(head_type="structure"), device="cuda")
    torch.cuda.synchronize()
    init_s = time.time() - t0
    trunk_cfg = runtime.trunk.cfg
    layer0 = runtime.trunk.transformer.blocks[0]

    # 2. kernels against their plain versions: the trunk's and decoder's
    # attention shapes (B 64 L 64 H 24; B 32 L 64 H 20), the JAX
    # package's own longer lengths, and L 2048 (past the longest K a block
    # keeps in shared memory); the projections at the trunk's T = 4096
    # tokens (64 x 64), at 1000 (not a multiple of their row tiles) and
    # below one row tile (64), and at their narrowest width (D 512, random
    # weights; fused_ffn at H 1536, the SwiGLU hidden width of D 512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.set_grad_enabled(False)  # inference throughout, as the CLI runs
    shapes = {
        "flash_attention": [check_flash_attention(torch, fa, B, L, H, gen)
                            for B, L, H in ((64, 64, 24), (32, 64, 20),
                                            (16, 512, 24), (4, 1024, 24),
                                            (2, 2048, 24))],
        "small_attention": [check_small_attention(torch, sa, B, L, H, gen)
                            for B, L, H in ((64, 64, 24), (32, 64, 20),
                                            (32, 128, 24), (16, 512, 24),
                                            (2, 2048, 24))],
        "fused_qkv": [check_fused_qkv(
            torch, fq, qkv_weights(
                torch, D, gen,
                layer0.attn if D == layer0.attn.d_model else None),
            T, gen) for T, D in ((4096, 1536), (1000, 1536), (64, 1536),
                                 (4096, 512), (64, 512))],
        "fused_ffn": [check_fused_ffn(
            torch, ff, ffn_weights(
                torch, D, H, gen,
                layer0.ffn if (D, H) == tuple(layer0.ffn.down.weight.shape)
                else None),
            M, gen) for M, D, H in ((4096, 1536, 4096), (1000, 1536, 4096),
                                    (64, 1536, 4096), (4096, 512, 1536),
                                    (64, 512, 1536))],
    }
    ffn_phase_launches = ff.launches
    for name, rows in shapes.items():
        for s in rows:
            print(f"[kernel] {name} " + json.dumps(s), flush=True)

    # 3. the default path (flash attention in every trunk and decoder layer)
    L_w = len(ESMProtein.from_pdb(ROOT / TARGET / "bpti.pdb").sequence) + 2
    batches = plan_batches(L_w, NUM_SAMPLES, policy="single")
    chunks = -(-NUM_SAMPLES // DECODE_BATCH)
    trunk_launches = trunk_cfg.n_layers * (NUM_STEPS + 1) * len(batches)
    dec_launches = runtime.decoder.cfg.n_layers * chunks
    steps = len(batches) * (NUM_STEPS + 1)
    n_params = sum(p.numel() for p in runtime.trunk.parameters())
    report, launches, peak_gib = drive(
        torch, runtime, ops, "default path",
        {"flash_attention": trunk_launches + dec_launches,
         "small_attention": 0, "fused_qkv": 0, "fused_ffn": 0},
        ROOT / "output" / "chip_smoke")
    rel, floor = kernel_vs_plain(
        torch, runtime,
        {}, {(fa, "flash_attention"): fa.flash_attention_reference},
        {(fa, "flash_attention"): plain_attention_with_lengths})
    if not rel <= 2 * floor:
        raise AssertionError(f"full-width trunk logits, kernel vs plain "
                             f"version: relative L2 {rel}, more than twice "
                             f"the two plain roundings' {floor}")
    print("[main path] " + json.dumps({
        "card": card, "trunk_params": n_params, "batches": batches,
        "decode_chunks": chunks, "init_s": init_s,
        "sampling_s": report["sampling_sec"], "total_s": report["total_sec"],
        "conformations_per_s": NUM_SAMPLES / report["total_sec"],
        "ms_per_step": 1e3 * report["sampling_sec"] / steps,
        "peak_memory_gib": peak_gib,
        "flash_attention_launches": launches["flash_attention"],
        "trunk_logits_rel_l2_kernel_vs_plain": rel,
        "trunk_logits_rel_l2_plain_roundings": floor}), flush=True)

    # 4. the fused path: same trunk weights, qkv_backend="fused",
    # attn_backend="small"; decoder and sigma embedder shared
    with torch.device("cuda"):
        fused_trunk = ESM3(esm3_open_small(
            head_type="structure", qkv_backend="fused", attn_backend="small"))
    cast_matmul_weights(fused_trunk)
    fused_trunk.load_state_dict(runtime.trunk.state_dict(), strict=True)
    fused_rt = ESM3Runtime(fused_trunk, runtime.decoder,
                           runtime.sigma_embedder, device="cuda")
    f_report, f_launches, f_peak = drive(
        torch, fused_rt, ops, "fused path",
        {"flash_attention": dec_launches, "small_attention": trunk_launches,
         "fused_qkv": trunk_launches, "fused_ffn": 0},
        ROOT / "output" / "chip_smoke_fused")

    def small_normalised_first(q, k, v, cos, sin, lens):
        # the JAX _xla_reference: p normalised before its bf16 cast
        return plain_attention_with_lengths(
            apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v, lens)

    f_rel, f_floor = kernel_vs_plain(
        torch, fused_rt, {},
        {(fq, "fused_ln_qkv"): fq.fused_ln_qkv_reference,
         (sa, "small_attention"): sa.small_attention_reference},
        {(fq, "fused_ln_qkv"): fq.ln_qkv_unfused,
         (sa, "small_attention"): small_normalised_first})
    if not f_rel <= 2 * f_floor:
        raise AssertionError(f"full-width fused-config trunk logits, kernels "
                             f"vs plain versions: relative L2 {f_rel}, more "
                             f"than twice the two plain roundings' {f_floor}")
    print("[fused path] " + json.dumps({
        "card": card, "config": {"qkv_backend": "fused",
                                 "attn_backend": "small"},
        "batches": batches, "decode_chunks": chunks,
        "sampling_s": f_report["sampling_sec"],
        "total_s": f_report["total_sec"],
        "conformations_per_s": NUM_SAMPLES / f_report["total_sec"],
        "ms_per_step": 1e3 * f_report["sampling_sec"] / steps,
        "peak_memory_gib": f_peak, "launches": f_launches,
        "trunk_logits_rel_l2_kernel_vs_plain": f_rel,
        "trunk_logits_rel_l2_plain_roundings": f_floor}), flush=True)

    # 5. the kernels line (headline shape: the trunk's), the device line;
    # launches from the path that runs the kernel, fused_ffn's from its
    # phase (no model path runs it)
    by_path = {"default path": launches, "fused path": f_launches}
    launches_from = {"flash_attention": "default path",
                     "small_attention": "fused path",
                     "fused_qkv": "fused path"}
    entries = []
    for name in KERNELS:
        head = shapes[name][0]
        src = launches_from.get(name)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"esmdiff_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": (by_path[src][name] if src
                         else ffn_phase_launches),
            "launches_from": src or "kernel phase: no model path runs it",
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(s["max_abs_err"] for s in shapes[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
