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
     30 x 1280 decoder, seed 0) through the port's CLI as it ships, ddpm,
     25 steps, 100 samples each of two targets -> a 100-MODEL PDB each:
     BPTI (bucket 64, where the sampler packs two rows to a device row and
     packed rows take the plain masked attention, so only the decoder runs
     the kernel) and a 118-residue chain (bucket 128, pack 1, so every trunk
     layer runs it); one untimed request over both, then each target timed
     with every kernel launch counted against its plan; then one
     full-width trunk forward with the kernel against the same forward
     with its plain version (within twice the spread of two plain
     roundings; the patched ops must launch their kernels in the kernel
     forward only);
  4. the fused path: the same trunk weights in the configuration
     qkv_backend="fused", attn_backend="small" (the decoder and the sigma
     embedder shared), driven and checked the same way;
  5. the gibbs path: a full-width stock-head runtime (ESM3Runtime.random_init
     with head_type "esm3", seed 0: the 1.4B trunk with its 4096-way
     structure head, the default path's decoder shared) through the CLI as
     it ships, on both targets: gibbs (16 steps, T 1.4, top_p 0.9) and eb
     (budget 1.0, at most 200 steps), 100 samples each, with exact launch
     counts (eb's from the step count of each batch); the stock-head trunk
     logits, kernel against plain version, gated as on the default path;
     on one (64, 128) batch of the 118-residue chain, the card against the
     CPU on one step's primitives (identical commit masks; top-p kept sets
     apart in at most 1e-4 of positions), and, printed without a gate, the
     share of a gibbs step and of an eb step spent outside the trunk
     forward with the device ms of each part;
  6. the serve path: a full-width runtime built as the port's server builds
     it (``--quant int8``: the trunk quantized from the same seed's float32
     weights, W8A8), ``int8_dot`` on the card against its plain version bit
     for bit at the trunk's four products (T 4096), the int8 trunk's
     logits packed (pack 2) against unpacked at B 64, L 64 (against the
     unpacked plain path within the spread of two plain roundings, against
     the kernel path within twice it, and two planted faults, a segment
     leak and a bf16 packed trunk, read above that limit), then the port's
     server on 127.0.0.1 over HTTP: /warmup (with a cross-length packed
     run), BPTI x 100 (the plan [64, 32, 8], pack 2: a 100-MODEL PDB),
     three concurrent requests of 58, 120 and 250 residues coalesced into
     one group, the same three as a coalesced gibbs group, one eb request
     (120 residues, 8 samples, a PDB), a bad request (400) and /healthz,
     with exact launch counts;
     and, printed without a gate, int8 against bf16 logits, BPTI's ms per
     step at JAX's pack against pack 1, the int8 trunk's ms per step at row
     widths T 64, 128 and 256, the int8 products' time against bf16
     ``F.linear``, and the host and device time of one step's draws for 64
     samples (a generator a row, and the packed engine's per-segment
     placement);
  7. the inpaint path: the default runtime (ddpm) and the gibbs path's
     stock-head runtime (gibbs), sharing one full-width structure encoder
     (float32, d 1024, 2 layers, k 16), through the CLI's --mask_ids and
     --filled_ids on both targets, one contiguous span each (named in the
     output), 100 samples: every known position keeps its encoded prior
     token in every sample, exact launch counts (the encoder launches no
     kernel: its attention takes the plain path by its config); the
     encoder on the card against its CPU copy (tokens equal but at near
     ties of the two nearest codes, z within 1e-4 relative L2); the trunk
     with structure coordinates (geometric attention, B 8 on the
     118-residue chain), kernel against plain version as on the default
     path; the server's inpainting requests in ddpm and gibbs (finite
     multi-MODEL PDBs; eb with mask_ids a 400); cli.dump of BPTI with
     embeddings (its structure tokens equal the runtime's encode); encode
     ms per target on a warm process;
  8. the train path: the port's cli.dump writes a corpus of every chain
     under data/targets/{apo,codnas,ped} through the full-width encoder;
     esmdiff-torch-train --config configs/mdlm.yaml on it at full width
     (1.4B trunk, float32 master weights, bf16 compute, remat, AdamW lr
     1e-5, batch 16, max_len 512): one unpacked epoch (data.pack_len=0:
     every trunk layer on the flash kernel, exact launches per train step
     and eval batch; warm ms per step, tokens/s, the bf16-peak share,
     peak memory, the save's seconds and size; the parameters moved) and
     one epoch of the shipped packed config (6 steps on this corpus;
     flash 0: packed rows take the plain masked path); one train step's forward and backward
     through the kernel against the trunk with attn_backend="xla" (logits,
     whole gradient and three parameters' gradients within twice the
     spread of two plain roundings); cli.sample --ckpt on the unpacked
     run (trunk parameters equal the saved ones bit for bit, a finite
     8-MODEL PDB of BPTI); the run is kept for phases 9 and 10;
  9. the AR path, with the default path's runtime (its trunk gives the
     embeddings, its decoder the structures):
     esmdiff-torch-sample-ar --config configs/clm.yaml, then
     configs/jlm.yaml (random weights from seed 0 at full width: CLM
     12 + 12 layers, d 1280, 437 M; JLM 48 layers, d 1280, 961 M), at
     the CLI's defaults (configs/predict.yaml: 100 samples, batch 32,
     T 1.0, top-p 0.95) on both targets, each a 100-MODEL PDB with exact
     launches (flash: 48 for the trunk forward + 30 a decode chunk of
     32), no structure special sampled; on BPTI's first batch the cached
     decode's logits against the teacher-forced forward (within twice the
     spread of two bf16 roundings: the forward with its Dense products
     accumulated as float32 products of the same operands), a decode
     step's host and device ms (tools/timing.py's host_ms, torch.profiler
     kernel time, a CUDA graph of the step on device_ms) beside its byte
     bound; one --quant int8 request a model on BPTI (32 samples: int8
     launches exact, its logits against bf16); after phase 10, one CLM
     request with --runtime_ckpt (the train path's run) and --vqvae_ckpt
     (the export; the decoder equal to it bit for bit), then both runs
     are deleted;
 10. the vqvae path, with the earlier runtimes freed: two probe steps at
     the CLI's default batch 32 (peak GiB printed), then, at batch 16,
     esmdiff-torch-train-vqvae --scale full (encoder d 1024,
     k 16, 4096 codes, float32; decoder d 1280 x 30, bf16, remat; AdamW
     warmup-cosine, clip 1.0) --steps 20 --restart_every 10 --augment on
     the chains of data/targets/{apo,codnas,ped} (pad_L 512, decoder rows
     514): exact flash launches a train step (forward + remat's
     recompute) and a val_recon, finite losses, val_recon falling, a
     restart, the parameters moved (warm ms a step, residues/s, the host
     share, peak GiB, the export's seconds printed); one VQ step's
     forward and backward through the kernel against the decoder on
     attn_backend="xla" (bb_pred, loss, whole gradient, bridge and
     codebook gradients within twice the spread of two plain roundings),
     and, printed, the encoder's share of a step's forward and backward;
     the export through load_vqvae, its standalone decoder against the
     training-time bb_pred (within twice that floor); cli.sample --ckpt
     (the train path's run) --vqvae_ckpt (the export) on BPTI x 8: the
     runtime's encoder and decoder equal the saved tensors bit for bit, a
     finite 8-MODEL PDB, exact launches; the flash kernel's device time
     at the decoder's VQ shapes (unmasked), beside its bound and SDPA;
 11. the eval path, on the default path's ensembles (100 samples each of
     BPTI and 1jm4.B) and the earlier runtimes freed: the port's
     esmdiff-torch-analyze in this process on the card, bpti against a
     stand-in reference trajectory (a seeded random walk of 100,000
     frames around data/targets/bpti/bpti.pdb, written as .npy in nm:
     58 CA, 1,653 pairwise distances, TICA at lag 500) with --clusters
     holding bpti.pdb, apo on 1jm4.B against a gapped, renumbered, moved
     copy of it (4,950 masked Kabsch fits), ped against the 114 PDBs of
     data/targets/ped; every output value finite (None only where the JAX
     package leaves it so), no kernel launched; the same suites with
     --device cpu, bpti on the trajectory cut to its first 10,000 frames
     (and that cut on the card too), held against the card's outputs (JS
     within 1e-4, TM and validity exactly, the rest within 1e-9
     relative); TICA's seconds on the card at 100,000 frames and at
     10,000 on the card and the CPU; the native TM library against
     _tm_score_np (its step-for-step numpy version) on the 100 BPTI
     samples against bpti.pdb (1e-6), and, printed, how far the library's
     RMSD lies above the optimal fit's (geo.rmsd: an SVD); each suite's
     seconds, the peak GiB, the g++ builds' seconds;
 12. the weights path, after the eval path: seeded reference-layout files
     at full width (convert/verify.py's generators; the weights are not in
     the repo), written and read as a user's: an ESMDiff release
     (Lightning state_dict, net.* = the 1.4B structure-head trunk,
     sigma_embedder.*), the stock esm3_sm_open_v1 trunk (the same body,
     the six heads, the 4096-way structure head), ESM3's VQ encoder and
     decoder (30 x 1280); esmdiff-torch-verify of each on the card (worst
     relative diff <= 1e-3) and a planted fault (layers 20 and 21 swapped
     through key_overrides) above that at exactly those layers;
     vqvae_from_reference, then load_runtime of the release with it: every
     tensor equal to the file's as held (bit for bit after the held
     cast), load seconds and peak GiB, the full-width trunk logits on the
     kernel path (bf16) against the oracle's float32 forward of the file
     within twice the spread of two plain roundings; cli.sample --ckpt
     --vqvae_ckpt, ddpm as it ships on both targets (100-MODEL PDBs, exact
     launches, conf/s beside the default path's); --mode gibbs --ckpt on
     the stock file (BPTI x 100, exact launches); model.pretrained_ckpt:
     3 unpacked steps of configs/mdlm.yaml at full width on the train
     path's corpus (the trunk equal to the file after init, finite
     losses, ms a step, flash 95 a step); the function decoder at its
     default geometry, the card against the CPU in float32 (1e-5
     relative); the runbook's --fixture chain at tiny width (on the CPU);
 13. the pipeline path, after the weights path (``pipeline_path``): (a)
     every chain of data/targets/{apo,codnas,ped} written as mmCIF (a
     third gzipped, every 47th at 6 A, a file that does not parse) and
     three two-chain complexes, through esmdiff-torch-preprocess
     --with_dssp --num_workers 8 (chain mode, then complex mode): the
     statuses, the DSSP on the card equal to the CPU on every chain, the
     .npz positions equal to the PDB parser's (5e-4 A), the DSSP's share;
     (b) esmdiff-torch-dump --with_embeddings of every second .npz chain
     at full width (a fresh seed-0 runtime): tokens equal to a dump of
     the same chains' PDB files, flash 48 a chain, embeddings GiB, the
     seconds of the trunk forwards and of the writes; (c)
     configs/clm.yaml and configs/jlm.yaml, one epoch each on that dump
     through esmdiff-torch-train (the JLM at batch 8: 16 does not fit):
     warm ms a step, tokens/s, peak GiB, the save; finite losses, the last
     quarter's under the first's; on 2 rows of one batch, the config
     dtype's loss and grad norm against the float32 net within twice the
     gap of float32 products of the bf16 operands; (d)
     esmdiff-torch-sample-ar --config --ckpt <best step dir> on BPTI x 32
     (the net equal to the run's tensors, finite PDBs, no special
     sampled, conf/s), then esmdiff-torch-analyze ped (finite); (e) 6
     unpacked steps of configs/mdlm.yaml on the train path's corpus under
     model.remat_policy=dots and under model.param_dtype=bfloat16 (ms a
     step, peak GiB, flash 95 a step, the dtypes), one batch's gradient
     under "dots" against "nothing" on the same weights (within the train
     path's two plain roundings); (f) esmdiff-torch-sweep --search sha,
     2 trials over optim.lr, bf16 parameters, on 32 chains of the dump:
     the promoted trial resumes its own checkpoint, best.json names the
     best; each part's seconds; every directory deleted after;
 14. print the card, each path's numbers, the kernels line, and as the
     last line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA card or without the
rest of the repo beside it.
"""

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

from esmdiff_tpu_torch.tools.timing import device_ms, host_ms

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12     # dense tensor-core peak, SXM, 700 W
H100_INT8_OPS = 1979e12      # int8 tensor-core peak, dense
H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
# kernel vs plain version, bf16: max |d| <= TOL_MAX and mean |d| <= TOL_MEAN;
# for the D=1536 LayerNorm/projection kernels max |d| is taken relative to
# max(1, |plain|), since one bf16 ulp at |y| >= 4 is 0.03
TOL_MAX, TOL_MEAN = 2e-2, 2e-3
TARGET = "data/targets/bpti"
# 118 residues: bucket 128, where the sampler does not pack
L128_TARGET = Path("data/targets/apo/1jm4.B.pdb")
NUM_SAMPLES, NUM_STEPS, DECODE_BATCH = 100, 25, 32
# gibbs as the CLI ships it (--num_steps 16, T 1.4, top_p 0.9); eb with
# --num_steps 25, so at most 200 steps, budget 1.0 (the CLI's defaults)
GIBBS_STEPS, GIBBS_TEMPERATURE, GIBBS_TOP_P = 16, 1.4, 0.9
EB_NUM_STEPS = 25
# the inpaint path's spans, 0-based residues: 15 of BPTI's 58, 18 of
# 1jm4.B's 118
INPAINT_SPANS = {"bpti": range(10, 25), "1jm4.B": range(40, 58)}
# the vqvae path: esmdiff-torch-train-vqvae --scale full on these chains,
# at batch 16: the CLI's default 32 does not fit 20 steps in 80 GB (the
# probe prints batch 32's peak over two steps; PERF.md, tokenizer)
VQ_DIRS, VQ_STEPS, VQ_BATCH, VQ_PROBE = ("apo", "codnas", "ped"), 20, 16, 32
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


def check_pdb(text: str, n_models: int, n_atoms: int, where: str):
    lines = text.splitlines()
    models = sum(line.startswith("MODEL") for line in lines)
    atoms = [line for line in lines if line.startswith("ATOM")]
    xyz = [float(a[c:c + 8]) for a in atoms for c in (30, 38, 46)]
    if models != n_models or len(atoms) != n_atoms or not all(
            math.isfinite(x) for x in xyz):
        raise AssertionError(f"{where}: {models} MODELs (want {n_models}), "
                             f"{len(atoms)} atoms (want {n_atoms})")


def bpti_logits(torch, runtime):
    """Structure logits of one full-width trunk forward on two BPTI rows
    (lengths 60 and 40): the first row's valid positions."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein

    seq = runtime.seq_tokenizer.encode(
        ESMProtein.from_pdb(ROOT / TARGET / "bpti.pdb").sequence)
    toks = torch.full((2, 64), 1, dtype=torch.long, device="cuda")
    toks[:, :len(seq)] = torch.as_tensor(seq, device="cuda")
    lengths = torch.tensor([len(seq), 40], dtype=torch.int32, device="cuda")
    out = runtime.trunk(sequence_tokens=toks, lengths=lengths)
    return out.structure_logits[0, :len(seq)]


def trunk_logits(torch, runtime, patches, forward=bpti_logits):
    """``forward(torch, runtime)`` under no_grad, with each (module, name)
    in ``patches`` replaced by its function for the call."""
    saved = {key: getattr(*key) for key in patches}
    for (module, name), fn in patches.items():
        setattr(module, name, fn)
    try:
        with torch.no_grad():
            return forward(torch, runtime)
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def kernel_vs_plain(torch, runtime, kernel, plain, other,
                    forward=bpti_logits):
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
        logits.append(trunk_logits(torch, runtime, patches, forward))
        if (sum(op.launches for op in ops) > before) != (patches is kernel):
            raise AssertionError("the logits gate's patches missed the "
                                 "kernels' call sites")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    return rel(logits[0], logits[1]), rel(logits[2], logits[1])


def path_launches(trunk_cfg, dec_layers, lw, fused, forwards=None,
                  num_samples=NUM_SAMPLES):
    """Each kernel's launches for one target's request of ``num_samples``
    through the CLI (plan "single"), from its plan: ``forwards[i]`` trunk forwards for
    batch i (ddpm: NUM_STEPS + 1 each), each layer's attention on the
    kernel only where the batch's pack factor is 1 (packed rows take the
    plain masked path), and one decoder launch per layer and decode
    chunk."""
    from esmdiff_tpu_torch.api.generation import bucket_length, plan_batches
    from esmdiff_tpu_torch.ops.packing import pack_factor

    plan = plan_batches(lw, num_samples, policy="single")
    if forwards is None:
        forwards = [NUM_STEPS + 1] * len(plan)
    layers = trunk_cfg.n_layers
    unpacked = layers * sum(f for b, f in zip(plan, forwards)
                            if pack_factor(b, bucket_length(lw)) == 1)
    decoder = dec_layers * -(-num_samples // DECODE_BATCH)
    if not fused:
        return {"flash_attention": unpacked + decoder, "small_attention": 0,
                "fused_qkv": 0, "fused_ffn": 0}
    return {"flash_attention": decoder, "small_attention": unpacked,
            "fused_qkv": layers * sum(forwards), "fused_ffn": 0}


def drive(torch, runtime, ops, name, targets, out_dir, mode="ddpm",
          num_steps=NUM_STEPS):
    """The path as the CLI ships it (``--mode mode``): one untimed request
    over every target (1 step, the same batches and L: cuBLAS set-up and
    allocator growth fall outside the timed runs), then for each target its
    own counted and timed request.  targets: {key: (directory, expected
    launches, or a function of the CLI's report that gives them)}.
    Checks each target's launches and PDB; returns {key: its numbers}."""
    from esmdiff_tpu_torch.cli import sample as cli

    def run_cli(dirs, out, steps):
        return cli.main(["--input", *map(str, dirs), "--output", str(out),
                         "--mode", mode, "--num_steps", str(steps),
                         "--num_samples", str(NUM_SAMPLES), "--seed", "0"],
                        runtime=runtime)

    run_cli([d for d, _ in targets.values()],
            out_dir.with_name(out_dir.name + "_warmup"), 1)
    numbers = {}
    for key, (directory, expected) in targets.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for op in ops.values():
            op.launches = 0
        report = run_cli([directory], out_dir / key, num_steps)[0]
        launches = {k: op.launches for k, op in ops.items()}
        if callable(expected):
            expected = expected(report)
        if launches != expected:
            raise AssertionError(f"{name}, {key}: kernel launches "
                                 f"{launches}, expected {expected}")
        pdb = out_dir / key / f"{report['target']}.pdb"
        check_pdb(pdb.read_text(), NUM_SAMPLES,
                  NUM_SAMPLES * (report["L"] * 4 - 1), str(pdb))
        numbers[key] = {"report": report, "launches": launches,
                        "peak_memory_gib":
                            torch.cuda.max_memory_allocated() / 2**30}
    return numbers


def check_int8_dot(torch, quant, dense, w_bf16, T, gen):
    """``int8_dot`` on the card against its plain version, bit for bit, on
    one layer-0 projection of the int8 trunk (``dense``: a QuantDense) at T
    tokens; device ms of the whole call (quantize, product, dequant), of
    the card product alone, of the plain version and of the bf16
    ``F.linear`` on the same layer's bf16 weight (``w_bf16``)."""
    import torch.nn.functional as F

    kq, scale = dense.kernel_q, dense.scale
    F_out, D = kq.shape
    x = torch.randn(T, D, device="cuda", generator=gen).to(torch.bfloat16)
    before = quant.launches
    out = quant.int8_dot(x, kq, scale)
    xq, sa = quant.quantize_activations(x)
    ref = (quant.int8_mm_reference(xq, kq).float() * sa * scale).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    if quant.launches != before + 1 or not torch.equal(out, ref):
        raise AssertionError(f"int8_dot at T {T}, ({F_out}, {D}): not bit "
                             f"for bit its plain version")
    # int8 operations at their peak against the bytes: x bf16 in, kq int8,
    # the scale, y bf16 out
    t_ops = 2.0 * T * D * F_out / H100_INT8_OPS
    t_bytes = (2 * T * D + F_out * D + 4 * F_out + 2 * T * F_out) \
        / H100_BYTES_PER_S
    return {
        "T": T, "D": D, "F": F_out, "bit_exact": True,
        "ms": device_ms(lambda: quant.int8_dot(x, kq, scale)),
        "int_mm_ms": device_ms(lambda: torch._int_mm(xq, kq.t())),
        "plain_ms": device_ms(lambda: quant.int8_mm_reference(xq, kq)),
        "bf16_linear_ms": device_ms(lambda: F.linear(x, w_bf16)),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
    }


def int8_logits(torch, fa, trunk, toks, lengths, pack=1, flash=None,
                leak=False):
    """Structure logits (B, L, V) of one no-grad trunk forward: unpacked
    with prefix ``lengths`` (``flash`` patched in for the kernel when
    given), or ``pack`` rows to a device row under a segment mask
    (``leak``: a planted fault, every valid token of a row in one
    segment, so that segments attend each other)."""
    from esmdiff_tpu_torch.ops.packing import (packed_positions,
                                               packed_segment_ids)

    B, L = toks.shape
    saved = fa.flash_attention
    if flash is not None:
        fa.flash_attention = flash
    try:
        with torch.no_grad():
            if pack == 1:
                out = trunk(sequence_tokens=toks, lengths=lengths)
            else:
                sid = packed_segment_ids(lengths, L, pack)
                out = trunk(sequence_tokens=toks.reshape(B // pack, pack * L),
                            sequence_id=sid.clamp(max=0) if leak else sid,
                            positions=packed_positions(L, pack,
                                                       device="cuda"))
    finally:
        fa.flash_attention = saved
    return out.structure_logits.reshape(B, L, -1)


def post(url, payload):
    """(status, JSON body) of a POST to the port's server."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def coalesced_posts(url, service, payloads):
    """POST ``payloads`` at once while the server's sample lock is held,
    so that they queue into one coalesced group; the replies, in order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(payloads)) as ex:
        with service._sample_lock:
            futs = [ex.submit(post, url, p) for p in payloads]
            deadline = time.time() + 120
            while time.time() < deadline:
                with service._pending_lock:
                    queued = sum(len(v) for v in service._pending.values())
                if queued == len(payloads):
                    break
                time.sleep(0.02)
            else:
                raise AssertionError(f"only {queued} requests queued")
        return [f.result(timeout=900) for f in futs]


def trunk_step_ms(torch, sampler, T, rows):
    """Host-clock ms of one int8 trunk step (``forward_logits``: sigma
    embedding, trunk, shields) on ``rows`` packed rows of width T, each
    one segment under the segment mask (the plain path, as in every packed
    row); mean of 5 after one untimed step."""
    from esmdiff_tpu_torch.core import constants as C

    toks = torch.full((rows, T), C.STRUCTURE_MASK_TOKEN, device="cuda")
    seq = torch.randint(4, 24, (rows, T), device="cuda")
    sid = torch.zeros(rows, T, dtype=torch.long, device="cuda")
    pos = torch.arange(T, device="cuda").expand(rows, T)
    sigma = torch.full((rows, 1), 0.5, device="cuda")

    def step():
        with torch.no_grad():
            sampler.mdlm.forward_logits(toks, seq, sigma, shield_specials=True,
                                        sequence_id=sid, positions=pos)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 5


def plan_ms_per_step(torch, sampler, sequence, plan, pack):
    """Host-clock ms per trunk step of ``sequence``'s batches (``plan``)
    through ``MDLM.ddpm_sample`` at pack factor ``pack(B, L)``, each batch
    set up as the sampler's engine sets it up (request seed 0)."""
    import numpy as np

    from esmdiff_tpu_torch.api.generation import bucket_length
    from esmdiff_tpu_torch.core import constants as C

    dev = sampler.runtime.device
    toks = sampler.runtime.seq_tokenizer.encode(sequence)
    lw, Lb = len(toks), bucket_length(len(toks))
    seq = torch.full((Lb,), C.SEQUENCE_PAD_TOKEN, dtype=torch.long,
                     device=dev)
    seq[:lw] = torch.as_tensor(toks, device=dev)
    prior = torch.full((Lb,), C.STRUCTURE_PAD_TOKEN, dtype=torch.long,
                       device=dev)
    prior[:lw] = C.STRUCTURE_MASK_TOKEN
    torch.cuda.synchronize()
    t0 = time.time()
    for B in plan:
        ids = np.stack([np.zeros(B, int), np.arange(B)], axis=1)
        sampler.mdlm.ddpm_sample(
            seq.expand(B, Lb),
            sampler.noise_factory(ids, Lb, sampler.mdlm_cfg.vocab_size, dev),
            num_steps=NUM_STEPS, input_prior=prior.expand(B, Lb),
            lengths=torch.full((B,), lw, dtype=torch.int32, device=dev),
            pack=pack(B, Lb))
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / (len(plan) * (NUM_STEPS + 1))


def unmask_anatomy(torch, sampler, sequence, gen):
    """One (64, Lb) batch of ``sequence`` (the engine's rows, request seed
    0) on the stock-head trunk: the card against the CPU on one step's
    primitives (the same fp32 inputs: ``select_top_by_confidence``'s commit
    masks identical, ``top_p_filter``'s kept sets apart in at most 1e-4 of
    positions), and where a step's time goes: host-clock ms of 16 trunk
    forwards alone, of a gibbs run of 16 steps and of an eb run cut at 16
    steps, and the device ms of the parts outside the trunk."""
    from esmdiff_tpu_torch.core import constants as C
    from esmdiff_tpu_torch.diffusion import gibbs

    B = 64
    rows, init, dmask, ids, _ = sampler._request_rows([sequence], [B], [0])
    dev = sampler.runtime.device
    seq_b = torch.as_tensor(rows, device=dev)
    lengths = (seq_b != C.SEQUENCE_PAD_TOKEN).sum(dim=-1, dtype=torch.int32)
    forward = sampler._trunk_forward(sampler._pack(B, rows.shape[1]))

    def fwd(tokens):
        return forward(tokens, seq_b, lengths)

    init_t = torch.as_tensor(init, device=dev)
    dmask_t = torch.as_tensor(dmask, device=dev)
    uniforms = sampler.uniform_factory(ids, rows.shape[1],
                                       sampler._logits_width(), dev)

    # one step's inputs, then each primitive on the card and on the CPU
    logits = fwd(init_t)
    scaled = logits / GIBBS_TEMPERATURE
    kept = gibbs.top_p_filter(scaled, GIBBS_TOP_P) > -1e8
    kept_cpu = gibbs.top_p_filter(scaled.cpu(), GIBBS_TOP_P) > -1e8
    top_p_differ = (kept.cpu() != kept_cpu).sum().item()
    sampled = gibbs._gumbel_sample(
        torch.where(kept, scaled, -1e9), uniforms(0))
    conf = torch.log_softmax(logits, dim=-1).gather(
        -1, sampled[..., None])[..., 0]
    still = (init_t == C.STRUCTURE_MASK_TOKEN) & dmask_t
    n_new = torch.randint(0, 40, (B,), device=dev, generator=gen)
    commit = gibbs.select_top_by_confidence(conf, still, n_new)
    commit_cpu = gibbs.select_top_by_confidence(conf.cpu(), still.cpu(),
                                                n_new.cpu())
    if not torch.equal(commit.cpu(), commit_cpu):
        raise AssertionError("select_top_by_confidence: the card's commit "
                             "masks differ from the CPU's")
    if top_p_differ > 1e-4 * kept_cpu.numel():
        raise AssertionError(f"top_p_filter: {top_p_differ} kept-set "
                             f"positions differ between card and CPU")

    def host(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    _, trunk_ms = host(lambda: [fwd(init_t) for _ in range(GIBBS_STEPS)])
    _, gibbs_ms = host(lambda: gibbs.iterative_unmask_sample(
        fwd, uniforms, init_t, dmask_t, num_steps=GIBBS_STEPS,
        temperature=GIBBS_TEMPERATURE, top_p=GIBBS_TOP_P))
    (_, eb_steps), eb_ms = host(lambda: gibbs.entropy_bounded_unmask_sample(
        fwd, uniforms, init_t, dmask_t, entropy_budget=1.0,
        temperature=GIBBS_TEMPERATURE, top_p=GIBBS_TOP_P,
        max_steps=GIBBS_STEPS))

    def entropy():
        logp = torch.log_softmax(logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(dim=-1)

    return {
        "B": B, "L": rows.shape[1],
        "card_vs_cpu": {"select_top_commit_masks_equal": True,
                        "top_p_kept_positions_differing": top_p_differ,
                        "top_p_positions": kept_cpu.numel()},
        "host_ms_16_steps": {"trunk_forwards": trunk_ms, "gibbs": gibbs_ms,
                             "eb": eb_ms, "eb_steps": eb_steps},
        "outside_trunk_share": {"gibbs": 1 - trunk_ms / gibbs_ms,
                                "eb": 1 - trunk_ms / eb_ms},
        "device_ms_per_step": {
            "trunk_forward": device_ms(lambda: fwd(init_t), iters=10),
            "top_p_filter": device_ms(
                lambda: gibbs.top_p_filter(scaled, GIBBS_TOP_P), iters=10),
            "uniforms": device_ms(lambda: uniforms(0), iters=10),
            "select_top_by_confidence": device_ms(
                lambda: gibbs.select_top_by_confidence(conf, still, n_new),
                iters=10),
            "eb_entropy": device_ms(entropy, iters=10)},
    }


def gibbs_path(torch, runtime, ops, target_dirs, lws, gen):
    """Phase 5 (module docstring).  Returns (numbers, launches summed over
    both modes and targets)."""
    from esmdiff_tpu_torch.api.generation import EnsembleSampler, plan_batches
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
    from esmdiff_tpu_torch.models.esm3 import ESM3Config
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths

    fa = ops["flash_attention"]
    t0 = time.time()
    rt = ESM3Runtime.random_init(
        seed=0, trunk_cfg=ESM3Config(head_type="esm3"), device="cuda")
    stock_rt = ESM3Runtime(rt.trunk, runtime.decoder, rt.sigma_embedder,
                           device="cuda", encoder=runtime.encoder)
    del rt
    torch.cuda.synchronize()
    init_s = time.time() - t0
    trunk_cfg = stock_rt.trunk.cfg
    dec_layers = runtime.decoder.cfg.n_layers

    def plan(key):
        return plan_batches(lws[key], NUM_SAMPLES, policy="single")

    g_driven = drive(
        torch, stock_rt, ops, "gibbs path, gibbs",
        {key: (d, path_launches(trunk_cfg, dec_layers, lws[key], False,
                                [GIBBS_STEPS] * len(plan(key))))
         for key, d in target_dirs.items()},
        ROOT / "output" / "chip_smoke_gibbs", mode="gibbs",
        num_steps=GIBBS_STEPS)
    e_driven = drive(
        torch, stock_rt, ops, "gibbs path, eb",
        {key: (d, lambda report, key=key: path_launches(
            trunk_cfg, dec_layers, lws[key], False, report["eb_steps"]))
         for key, d in target_dirs.items()},
        ROOT / "output" / "chip_smoke_eb", mode="eb",
        num_steps=EB_NUM_STEPS)

    def numbers(driven, forwards):
        out = {}
        for key, n in driven.items():
            r = n["report"]
            steps = forwards(key, r)
            out[key] = {
                "L": r["L"], "batches": plan(key),
                "sampling_s": r["sampling_sec"], "total_s": r["total_sec"],
                "conformations_per_s": NUM_SAMPLES / r["total_sec"],
                "trunk_steps": steps,
                "ms_per_step": 1e3 * r["sampling_sec"] / steps,
                "peak_memory_gib": n["peak_memory_gib"],
                "launches": n["launches"],
                **({"eb_steps": r["eb_steps"]} if "eb_steps" in r else {})}
        return out

    rel, floor = kernel_vs_plain(
        torch, stock_rt,
        {}, {(fa, "flash_attention"): fa.flash_attention_reference},
        {(fa, "flash_attention"): plain_attention_with_lengths})
    if not rel <= 2 * floor:
        raise AssertionError(f"full-width stock-head trunk logits, kernel vs "
                             f"plain version: relative L2 {rel}, more than "
                             f"twice the two plain roundings' {floor}")
    seq_128 = ESMProtein.from_pdb(
        next(target_dirs[L128_TARGET.stem].glob("*.pdb"))).sequence
    anatomy = unmask_anatomy(torch, EnsembleSampler(stock_rt), seq_128, gen)
    launches = {k: sum(n["launches"][k]
                       for driven in (g_driven, e_driven)
                       for n in driven.values()) for k in KERNELS}
    return {
        "init_s": init_s, "config": {"head_type": "esm3"},
        "gibbs": {"num_steps": GIBBS_STEPS, "temperature": GIBBS_TEMPERATURE,
                  "top_p": GIBBS_TOP_P,
                  "targets": numbers(g_driven, lambda key, r: len(plan(key))
                                     * GIBBS_STEPS)},
        "eb": {"entropy_budget": 1.0, "max_steps": 8 * EB_NUM_STEPS,
               "temperature": GIBBS_TEMPERATURE, "top_p": GIBBS_TOP_P,
               "targets": numbers(e_driven,
                                  lambda key, r: sum(r["eb_steps"]))},
        "launches": launches,
        "trunk_logits_rel_l2_kernel_vs_plain": rel,
        "trunk_logits_rel_l2_plain_roundings": floor,
        "anatomy_1jm4_B": anatomy}, launches, stock_rt


def serve_path(torch, runtime, ops, card, gen):
    """Phase 5 (module docstring).  Returns (numbers, launches)."""
    import numpy as np

    from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                                  bucket_length,
                                                  plan_batches)
    from esmdiff_tpu_torch.api.protein_api import ESMProtein
    from esmdiff_tpu_torch.cli import sample as cli
    from esmdiff_tpu_torch.cli import serve as server
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
    from esmdiff_tpu_torch.ops import quant
    from esmdiff_tpu_torch.ops.packing import pack_factor

    fa = ops["flash_attention"]
    t0 = time.time()
    args = server.get_argparser().parse_args(["--quant", "int8", "--mode",
                                              "ddpm", "--seed", "0"])
    rt = cli.build_runtime(args)       # as the server's main builds it
    torch.cuda.synchronize()
    init_s = time.time() - t0
    trunk, n_layers = rt.trunk, rt.trunk.cfg.n_layers
    q0, b0 = rt.trunk.transformer.blocks[0], runtime.trunk.transformer.blocks[0]

    # int8_dot bit for bit at the trunk's four products, T = 64 x 64
    int8_rows = [check_int8_dot(torch, quant, dense, w.weight, 4096, gen)
                 for dense, w in ((q0.attn.qkv, b0.attn.qkv),
                                  (q0.attn.out, b0.attn.out),
                                  (q0.ffn.up, b0.ffn.up),
                                  (q0.ffn.down, b0.ffn.down))]
    for r in int8_rows:
        print("[int8] " + json.dumps(r), flush=True)

    # packed against unpacked int8 logits, B 64, L 64: a random chain of
    # the 20 amino acids a row (rows that differ, so that a segment that
    # sees its neighbour reads different keys), lengths from 20 to 62
    B, L = 64, 64
    toks = torch.randint(4, 24, (B, L), device="cuda", generator=gen)
    lengths = torch.randint(20, L - 1, (B,), device="cuda",
                            dtype=torch.int32, generator=gen)
    fa_before = fa.launches
    packed = int8_logits(torch, fa, trunk, toks, lengths, pack=2)
    if fa.launches != fa_before:
        raise AssertionError("packed rows reached the flash kernel")
    kernel = int8_logits(torch, fa, trunk, toks, lengths)
    plain = int8_logits(torch, fa, trunk, toks, lengths,
                        flash=fa.flash_attention_reference)
    other = int8_logits(torch, fa, trunk, toks, lengths,
                        flash=plain_attention_with_lengths)
    bf16 = int8_logits(torch, fa, runtime.trunk, toks, lengths)
    # two planted faults the packing gate must read above its limit: a
    # segment mask that lets a row's segments see each other, and a packed
    # trunk that runs bf16 in place of int8
    leak = int8_logits(torch, fa, trunk, toks, lengths, pack=2, leak=True)
    bf16_packed = int8_logits(torch, fa, runtime.trunk, toks, lengths, pack=2)
    valid = torch.arange(L, device="cuda")[None, :] < lengths[:, None]

    def rel(a, b):
        a, b = a[valid].float(), b[valid].float()
        return ((a - b).norm() / b.norm()).item()

    # packed rows take the plain masked attention, so packing only changes
    # the rounding of one plain attention: packed against the unpacked
    # plain path is held to the spread of two plain roundings (once, not
    # twice), and against the kernel path to twice it
    gate = {"packed_vs_unpacked": rel(packed, kernel),
            "plain_roundings": rel(other, plain),
            "packed_vs_unpacked_same_rounding": rel(packed, other),
            "int8_vs_bf16": rel(kernel, bf16),
            "planted_segment_leak": rel(leak, other),
            "planted_bf16_packed": rel(bf16_packed, other)}
    limit = gate["plain_roundings"]
    if not (torch.isfinite(packed[valid]).all()
            and gate["packed_vs_unpacked_same_rounding"] <= limit
            and gate["packed_vs_unpacked"] <= 2 * limit):
        raise AssertionError(f"int8 trunk logits, packed vs unpacked: {gate}")
    if not min(gate["planted_segment_leak"],
               gate["planted_bf16_packed"]) > limit:
        raise AssertionError(f"the packing gate passes a planted fault: "
                             f"{gate}")

    # the server, over HTTP on 127.0.0.1
    sampler = EnsembleSampler(rt)
    service = server.SamplerService(sampler, max_samples=args.max_samples,
                                    max_batch=args.max_batch)
    httpd = server.serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        t0 = time.time()
        status, warm = post(url + "/warmup", {
            "lengths": [58], "num_samples": NUM_SAMPLES, "mode": "ddpm",
            "packed_lengths": [58, 120, 250]})
        if status != 200:
            raise AssertionError(f"/warmup: {status} {warm}")
        warmup_s = time.time() - t0

        # BPTI x 100, the ladder plan with max_batch 64: [64, 32, 8], pack 2
        bpti = ESMProtein.from_pdb(ROOT / TARGET / "bpti.pdb").sequence
        lw = len(bpti) + 2
        plan = plan_batches(lw, NUM_SAMPLES, max_batch=args.max_batch,
                            policy="ladder")
        packs = [pack_factor(b, bucket_length(lw)) for b in plan]
        decode_chunks = -(-NUM_SAMPLES // DECODE_BATCH)
        want_bpti = {
            "flash_attention": (n_layers * (NUM_STEPS + 1)
                                * sum(p == 1 for p in packs)
                                + rt.decoder.cfg.n_layers * decode_chunks),
            "int8_products": 4 * n_layers * (NUM_STEPS + 1) * len(plan)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for op in (*ops.values(), quant):
            op.launches = 0
        status, reply = post(url + "/sample", {
            "sequence": bpti, "num_samples": NUM_SAMPLES, "mode": "ddpm",
            "num_steps": NUM_STEPS, "seed": 0, "format": "pdb"})
        launches = {k: op.launches for k, op in ops.items()}
        bpti_launches = {**launches, "int8_products": quant.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if status != 200:
            raise AssertionError(f"/sample BPTI: {status} {reply}")
        check_pdb(reply["pdb"], NUM_SAMPLES, NUM_SAMPLES * (len(bpti) * 4 - 1),
                  "/sample BPTI")
        if (bpti_launches["flash_attention"] != want_bpti["flash_attention"]
                or bpti_launches["int8_products"]
                != want_bpti["int8_products"]
                or any(launches[k] for k in ("small_attention", "fused_qkv",
                                              "fused_ffn"))):
            raise AssertionError(f"serve path, BPTI: launches "
                                 f"{bpti_launches}, expected {want_bpti}")

        # three concurrent requests, three length buckets, one group
        def residues(n):
            return ("ACDEFGHIKLMNPQRSTVWY" * (n // 20 + 1))[:n]

        lens, n_each = [58, 120, 250], 8
        lws = [n + 2 for n in lens]
        route = sampler._mixed_route(
            lws, [n_each] * 3, max(128, bucket_length(max(lws), 64)))
        want_group = 0
        if route[0] == "split":       # per-bucket batches; pack 1 -> flash
            for n in lws:
                want_group += n_layers * (NUM_STEPS + 1) * sum(
                    pack_factor(b, bucket_length(n)) == 1
                    for b in plan_batches(n, n_each,
                                          max_batch=args.max_batch))
        fa_before = fa.launches
        t0 = time.time()
        replies = coalesced_posts(url + "/sample", service, [
            {"sequence": residues(n), "num_samples": n_each, "mode": "ddpm",
             "num_steps": NUM_STEPS, "seed": i, "format": "tokens"}
            for i, n in enumerate(lens)])
        group_s = time.time() - t0
        group_launches = fa.launches - fa_before
        for n, (status, body) in zip(lens, replies):
            shape = np.asarray(body.get("tokens", [])).shape
            if (status != 200 or body.get("coalesced") != 3
                    or shape != (n_each, n)):
                raise AssertionError(f"coalesced request of {n}: {status}, "
                                     f"coalesced {body.get('coalesced')}, "
                                     f"tokens {shape}")
        if group_launches != want_group:
            raise AssertionError(f"coalesced group: {group_launches} flash "
                                 f"launches, expected {want_group}")

        # the same three buckets as a coalesced gibbs group (per-bucket
        # sub-groups; pack 1 -> flash), then one eb request of 120
        # residues (bucket 128, pack 1) with its PDB
        want_gibbs = sum(
            n_layers * GIBBS_STEPS * sum(
                pack_factor(b, bucket_length(n)) == 1
                for b in plan_batches(n, n_each, max_batch=args.max_batch))
            for n in lws)
        fa_before = fa.launches
        t0 = time.time()
        replies = coalesced_posts(url + "/sample", service, [
            {"sequence": residues(n), "num_samples": n_each, "mode": "gibbs",
             "num_steps": GIBBS_STEPS, "seed": i, "format": "tokens"}
            for i, n in enumerate(lens)])
        gibbs_group_s = time.time() - t0
        gibbs_group_launches = fa.launches - fa_before
        for n, (status, body) in zip(lens, replies):
            toks = np.asarray(body.get("tokens", []))
            if (status != 200 or body.get("coalesced") != 3
                    or toks.shape != (n_each, n) or not (toks < 4096).all()):
                raise AssertionError(f"coalesced gibbs request of {n}: "
                                     f"{status}, coalesced "
                                     f"{body.get('coalesced')}, tokens "
                                     f"{toks.shape}")
        if gibbs_group_launches != want_gibbs:
            raise AssertionError(f"coalesced gibbs group: "
                                 f"{gibbs_group_launches} flash launches, "
                                 f"expected {want_gibbs}")
        eb_len = 120
        fa_before = fa.launches
        t0 = time.time()
        status, eb_reply = post(url + "/sample", {
            "sequence": residues(eb_len), "num_samples": n_each,
            "mode": "eb", "seed": 0, "format": "pdb"})
        eb_s = time.time() - t0
        eb_launches = fa.launches - fa_before
        if status != 200:
            raise AssertionError(f"/sample eb: {status} {eb_reply}")
        check_pdb(eb_reply["pdb"], n_each, n_each * (eb_len * 4 - 1),
                  "/sample eb")
        eb_plan = plan_batches(eb_len + 2, n_each, max_batch=args.max_batch)
        want_eb = n_layers * sum(
            s for b, s in zip(eb_plan, sampler.eb_steps)
            if pack_factor(b, bucket_length(eb_len + 2)) == 1) \
            + rt.decoder.cfg.n_layers * -(-n_each // DECODE_BATCH)
        if eb_launches != want_eb or len(sampler.eb_steps) != len(eb_plan):
            raise AssertionError(f"eb request: {eb_launches} flash launches "
                                 f"over steps {sampler.eb_steps}, expected "
                                 f"{want_eb}")

        status, bad = post(url + "/sample", {"sequence": "X1",
                                             "mode": "ddpm"})
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if status != 400 or health.get("card") != torch.cuda.get_device_name(
                0):
            raise AssertionError(f"bad request {status} {bad}; /healthz "
                                 f"{health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)

    # BPTI's plan at pack 1 against JAX's pack, through ddpm_sample
    steps = len(plan) * (NUM_STEPS + 1)
    by_pack = {name: plan_ms_per_step(torch, sampler, bpti, plan, pack)
               for name, pack in (("pack_1", lambda B, L: 1),
                                  ("jax_pack", pack_factor))}

    # host time of a step's draws for BPTI's B-64 batch: one generator a
    # row (the multi engine), and the same 64 samples as segments placed
    # two to a 128-wide row (the packed engine's SegmentNoise)
    from esmdiff_tpu_torch.api.generation import SegmentNoise

    V = sampler.mdlm_cfg.vocab_size
    ids = np.stack([np.zeros(64, int), np.arange(64)], axis=1)
    row_noise = sampler.noise_factory(ids, bucket_length(lw), V, rt.device)
    seg_noise = SegmentNoise(
        sampler.noise_factory,
        [(0, j, lw, j // 2, (j % 2) * 64) for j in range(64)], 32, 128, V,
        rt.device)
    noise_ms = {name: {"host_ms": host_ms(lambda: src(0), calls=20),
                       "device_ms": device_ms(lambda: src(0), iters=5)}
                for name, src in (("row_generators", row_noise),
                                  ("segment_noise", seg_noise))}

    rows = {T: trunk_step_ms(torch, sampler, T, 8192 // T)
            for T in (64, 128, 256)}
    numbers = {
        "card": card, "init_s": init_s, "warmup_s": warmup_s,
        "warmed": warm["warmed"], "plan": plan, "packs": packs,
        "decode_chunks": decode_chunks,
        "sampling_s": reply["sampling_sec"], "total_s": reply["total_sec"],
        "conformations_per_s": NUM_SAMPLES / reply["total_sec"],
        "ms_per_step": 1e3 * reply["sampling_sec"] / steps,
        "peak_memory_gib": peak_gib, "launches": bpti_launches,
        "coalesced_group": {"lengths": lens, "samples_each": n_each,
                            "route": route[0], "route_costs": route[1:],
                            "s": group_s,
                            "flash_attention_launches": group_launches},
        "coalesced_gibbs_group": {
            "lengths": lens, "samples_each": n_each,
            "num_steps": GIBBS_STEPS, "s": gibbs_group_s,
            "flash_attention_launches": gibbs_group_launches},
        "eb_request": {"length": eb_len, "samples": n_each,
                       "plan": eb_plan, "eb_steps": list(sampler.eb_steps),
                       "s": eb_s, "sampling_s": eb_reply["sampling_sec"],
                       "ms_per_step": 1e3 * eb_reply["sampling_sec"]
                       / sum(sampler.eb_steps),
                       "flash_attention_launches": eb_launches},
        "bpti_ms_per_step": by_pack, "draws_per_step_b64": noise_ms,
        "int8_trunk_ms_per_step_8192_tokens": {
            T: {"rows": 8192 // T, "ms_per_step": ms,
                "ms_per_step_per_row": ms / (8192 // T)}
            for T, ms in rows.items()},
        "trunk_logits_rel_l2": gate, "healthz_card": health["card"]}
    return numbers, bpti_launches


@contextlib.contextmanager
def recorded(owner, name):
    """Keeps what ``owner.name`` (a method or a module's function) returns
    while the block runs (the tokens the CLI samples, for the prior gate;
    the runtime ``--ckpt`` loads); the call itself is unchanged."""
    orig, outputs = getattr(owner, name), []

    def keep(*args, **kwargs):
        outputs.append(orig(*args, **kwargs))
        return outputs[-1]

    setattr(owner, name, keep)
    try:
        yield outputs
    finally:
        setattr(owner, name, orig)


def prior_kept(tokens, prior, C):
    """Positions (over every sample) where a known token (a code in the
    prior) was not kept; the prior must hold both kinds."""
    known = prior != C.STRUCTURE_MASK_TOKEN
    if known.all() or not known.any():
        raise AssertionError("the prior holds no span to inpaint")
    return int((tokens[:, known] != prior[known]).sum())


def encoder_card_vs_cpu(torch, encoder, backbones):
    """The encoder on the card against its float32 CPU copy on each
    target's backbone: tokens differing outside near ties (the two nearest
    codes within 1e-5 relative distance, by the CPU's z; must be 0), near
    ties, z's relative L2 (at most 1e-4)."""
    import copy

    cpu = copy.deepcopy(encoder).cpu()
    out = {}
    for key, bb in backbones.items():
        x = torch.as_tensor(bb[None], dtype=torch.float32)
        with torch.no_grad():
            tokens, z, valid = encoder(x.cuda())
            ref_tokens, ref_z, ref_valid = cpu(x)
        d = torch.cdist(ref_z[0].double(), cpu.codebook.double())
        two = d.topk(2, dim=-1, largest=False).values
        near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0]
        differ = (tokens.cpu()[0] != ref_tokens[0])
        out[key] = {
            "tokens_differing": int((differ & ~near_tie).sum()),
            "tokens_differing_at_near_ties": int((differ & near_tie).sum()),
            "near_ties": int(near_tie.sum()),
            "z_rel_l2": ((z.cpu() - ref_z).norm() / ref_z.norm()).item(),
            "valid_equal": bool(torch.equal(valid.cpu(), ref_valid))}
        if (out[key]["tokens_differing"] or out[key]["z_rel_l2"] > 1e-4
                or not out[key]["valid_equal"]):
            raise AssertionError(f"encoder, card vs CPU on {key}: "
                                 f"{out[key]}")
    return out


def coords_logits(torch, runtime, seq, backbone):
    """Structure logits of one full-width trunk forward with structure
    coordinates (geometric attention in block 0) on 8 rows of ``seq``
    (bucket 128, prefix lengths), row r with 4 r residues' frames removed
    from the middle: the rows' valid positions."""
    import numpy as np

    toks = runtime.seq_tokenizer.encode(seq)
    lw, L, B = len(toks), 128, 8
    coords = np.full((B, L, 3, 3), np.nan, np.float32)
    coords[:, 1:lw - 1] = backbone
    for r in range(B):
        coords[r, 40:40 + 4 * r] = np.nan
    seq_b = torch.full((B, L), 1, dtype=torch.long, device="cuda")
    seq_b[:, :lw] = torch.as_tensor(toks, device="cuda")
    out = runtime.trunk(
        sequence_tokens=seq_b,
        structure_coords=torch.as_tensor(coords, device="cuda"),
        lengths=torch.full((B,), lw, dtype=torch.int32, device="cuda"))
    return out.structure_logits[:, :lw]


def inpaint_path(torch, runtime, stock_rt, ops, target_dirs, lws, card):
    """Phase 7 (module docstring).  Returns (numbers, launches summed over
    the path's CLI runs, server requests and dump; the gate forwards that
    hold kernels against plain versions do not count)."""
    import numpy as np

    from esmdiff_tpu_torch.api.generation import EnsembleSampler
    from esmdiff_tpu_torch.api.protein_api import ESMProtein
    from esmdiff_tpu_torch.cli import dump as dump_cli
    from esmdiff_tpu_torch.cli import sample as cli
    from esmdiff_tpu_torch.cli import serve as server
    from esmdiff_tpu_torch.core import constants as C
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths

    t_phase = time.time()
    fa = ops["flash_attention"]
    if stock_rt.encoder is not runtime.encoder:
        raise AssertionError("the ddpm and gibbs runtimes must share one "
                             "encoder")
    pdbs = {key: next(d.glob("*.pdb")) for key, d in target_dirs.items()}
    prots = {key: ESMProtein.from_pdb(p) for key, p in pdbs.items()}
    spans = {key: list(INPAINT_SPANS[key]) for key in prots}

    # encode ms per target (warm: one untimed call first), no kernel
    encode_ms, priors = {}, {}
    fa_before = fa.launches
    for key, prot in prots.items():
        runtime.encode(prot)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            structure = runtime.encode(prot).structure
        encode_ms[key] = 1e3 * (time.perf_counter() - t0) / 5
        ddpm_prior = structure[1:-1].copy()
        ddpm_prior[spans[key]] = C.STRUCTURE_MASK_TOKEN
        coords = prot.coordinates.copy()
        coords[spans[key]] = np.inf
        seq = "".join("_" if i in spans[key] else ch
                      for i, ch in enumerate(prot.sequence))
        priors[key] = {"ddpm": ddpm_prior, "gibbs": runtime.encode(
            ESMProtein(seq, coords)).structure[1:-1]}
    if fa.launches != fa_before:
        raise AssertionError("the encoder launched the flash kernel")
    card_vs_cpu = encoder_card_vs_cpu(
        torch, runtime.encoder,
        {key: prot.backbone() for key, prot in prots.items()})

    # the CLI, as it ships, with --mask_ids / --filled_ids, 100 samples
    trunk_cfg, dec_layers = runtime.trunk.cfg, runtime.decoder.cfg.n_layers
    runs = [("ddpm", "bpti", "--mask_ids"), ("ddpm", "bpti", "--filled_ids"),
            ("ddpm", "1jm4.B", "--mask_ids"), ("gibbs", "bpti", "--mask_ids"),
            ("gibbs", "1jm4.B", "--mask_ids")]
    out_dir = ROOT / "output" / "chip_smoke_inpaint"
    launches = {k: 0 for k in KERNELS}
    numbers = {}
    for mode, key, flag in runs:
        ids = spans[key] if flag == "--mask_ids" else [
            i for i in range(len(prots[key].sequence))
            if i not in spans[key]]
        rt, steps = ((runtime, NUM_STEPS) if mode == "ddpm"
                     else (stock_rt, GIBBS_STEPS))
        name = f"{mode} {key} {flag}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for op in ops.values():
            op.launches = 0
        method = "ddpm_ensemble" if mode == "ddpm" else "gibbs_ensemble"
        with recorded(EnsembleSampler, method) as outputs:
            report = cli.main(
                ["--input", str(target_dirs[key]), "--output",
                 str(out_dir / f"{mode}_{key}_{flag[2:]}"), "--mode", mode,
                 "--num_steps", str(steps), "--num_samples",
                 str(NUM_SAMPLES), "--seed", "0", flag,
                 ",".join(map(str, ids))], runtime=rt)[0]
        run_launches = {k: op.launches for k, op in ops.items()}
        plan_forwards = ([NUM_STEPS + 1] * 2 if mode == "ddpm"
                         else [GIBBS_STEPS] * 2)
        want = path_launches(trunk_cfg, dec_layers, lws[key], False,
                             plan_forwards)
        if run_launches != want:
            raise AssertionError(f"inpaint path, {name}: launches "
                                 f"{run_launches}, expected {want}")
        differ = prior_kept(outputs[0], priors[key][mode], C)
        if differ:
            raise AssertionError(f"inpaint path, {name}: {differ} known "
                                 f"positions lost their prior token")
        pdb = out_dir / f"{mode}_{key}_{flag[2:]}" / f"{report['target']}.pdb"
        check_pdb(pdb.read_text(), NUM_SAMPLES,
                  NUM_SAMPLES * (report["L"] * 4 - 1), str(pdb))
        for k in KERNELS:
            launches[k] += run_launches[k]
        trunk_steps = 2 * (NUM_STEPS + 1 if mode == "ddpm" else GIBBS_STEPS)
        numbers[name] = {
            "span": [spans[key][0], spans[key][-1]],
            "sampling_s": report["sampling_sec"],
            "total_s": report["total_sec"],
            "conformations_per_s": NUM_SAMPLES / report["total_sec"],
            "trunk_steps": trunk_steps,
            "ms_per_step": 1e3 * report["sampling_sec"] / trunk_steps,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": run_launches, "prior_positions_differing": differ}

    # the trunk with coordinates, kernel against plain version
    key = L128_TARGET.stem

    def with_coords(torch, rt):
        return coords_logits(torch, rt, prots[key].sequence,
                             prots[key].backbone())

    rel, floor = kernel_vs_plain(
        torch, runtime,
        {}, {(fa, "flash_attention"): fa.flash_attention_reference},
        {(fa, "flash_attention"): plain_attention_with_lengths},
        forward=with_coords)
    if not rel <= 2 * floor:
        raise AssertionError(f"full-width trunk logits with coordinates, "
                             f"kernel vs plain version: relative L2 {rel}, "
                             f"more than twice the two plain roundings' "
                             f"{floor}")

    # the server: inpainting in ddpm and gibbs (the structure-head runtime,
    # as `cli.serve --mode ddpm` builds it, serves both), eb's 400
    service = server.SamplerService(EnsembleSampler(runtime))
    httpd = server.serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}/sample"
    pdb_text = pdbs["bpti"].read_text()
    serve_numbers = {}
    try:
        for mode in ("ddpm", "gibbs"):
            fa_before = fa.launches
            t0 = time.time()
            status, reply = post(url, {
                "pdb": pdb_text, "mode": mode, "mask_ids": spans["bpti"],
                "num_samples": NUM_SAMPLES, "seed": 0, "format": "pdb"})
            request_s = time.time() - t0
            if status != 200:
                raise AssertionError(f"/sample inpainting {mode}: {status} "
                                     f"{reply}")
            check_pdb(reply["pdb"], NUM_SAMPLES,
                      NUM_SAMPLES * (len(prots["bpti"].sequence) * 4 - 1),
                      f"/sample inpainting {mode}")
            # BPTI's ladder plan packs every batch: flash in the decoder
            want = dec_layers * -(-NUM_SAMPLES // DECODE_BATCH)
            if fa.launches - fa_before != want:
                raise AssertionError(f"/sample inpainting {mode}: "
                                     f"{fa.launches - fa_before} flash "
                                     f"launches, expected {want}")
            launches["flash_attention"] += want
            serve_numbers[mode] = {"request_s": request_s,
                                   "sampling_s": reply["sampling_sec"],
                                   "flash_attention_launches": want}
        status, bad = post(url, {"pdb": pdb_text, "mode": "eb",
                                 "mask_ids": [1]})
        if status != 400 or "eb mode does not support" not in bad["error"]:
            raise AssertionError(f"eb with mask_ids: {status} {bad}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)

    # cli.dump of BPTI with embeddings: one trunk forward (flash per layer)
    fa_before = fa.launches
    dump_dir = ROOT / "output" / "chip_smoke_dump"
    if dump_cli.main([str(target_dirs["bpti"]), str(dump_dir),
                      "--with_embeddings"], runtime=runtime) != 1:
        raise AssertionError("cli.dump wrote no encoding")
    dump_launches = fa.launches - fa_before
    with np.load(dump_dir / "bpti.npz") as z:
        dumped = {k: z[k] for k in z.files}
    lw = lws["bpti"]
    if not (np.array_equal(dumped["structure_tokens"],
                           runtime.encode(prots["bpti"]).structure)
            and dumped["embeddings"].shape == (lw, trunk_cfg.d_model)
            and np.isfinite(dumped["embeddings"]).all()
            and dump_launches == trunk_cfg.n_layers):
        raise AssertionError(f"cli.dump: {sorted(dumped)}, embeddings "
                             f"{dumped['embeddings'].shape}, flash "
                             f"{dump_launches}")
    launches["flash_attention"] += dump_launches
    return {
        "card": card, "phase_s": time.time() - t_phase,
        "spans": {k: [v[0], v[-1]] for k, v in spans.items()},
        "encoder": {"config": "d 1024, 1 head, v_heads 128, 2 layers, "
                              "d_out 128, 4096 codes, k 16, float32",
                    "encode_ms": encode_ms, "card_vs_cpu": card_vs_cpu},
        "runs": numbers, "launches": launches,
        "server": serve_numbers,
        "trunk_with_coords_rel_l2_kernel_vs_plain": rel,
        "trunk_with_coords_rel_l2_plain_roundings": floor,
        "dump": {"files": sorted(dumped), "flash_attention_launches":
                 dump_launches}}, launches


@contextlib.contextmanager
def stepped(torch, module, name, fa, out):
    """Wraps ``module.name`` (the trainer's train or eval step) while the
    block runs: each call is synchronised before and after, and its ms,
    flash launches, batch tokens (real, padded), loss and grad norm are
    appended to ``out``; the call itself is unchanged."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        batch = next(a for a in args if isinstance(a, dict))
        torch.cuda.synchronize()
        before, t0 = fa.launches, time.perf_counter()
        metrics = orig(*args, **kwargs)
        torch.cuda.synchronize()
        out.append({"ms": 1e3 * (time.perf_counter() - t0),
                    "flash": fa.launches - before,
                    "real_tokens": int(batch["mask"].sum().item()),
                    "padded_tokens": batch["mask"].numel(),
                    "shape": list(batch["mask"].shape),
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics.get("grad_norm",
                                                   float("nan")))})
        return metrics

    setattr(module, name, wrapped)
    try:
        yield out
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def timed_saves(torch, manager_cls, out):
    """Wraps ``CheckpointManager.save``: free disk before each save, its
    seconds and the bytes it wrote are appended to ``out``."""
    orig = manager_cls.save

    def save(self, state, step, metric):
        torch.cuda.synchronize()
        free = shutil.disk_usage(self.dir).free
        t0 = time.perf_counter()
        orig(self, state, step, metric)
        out.append({"free_disk_gib_before": free / 2**30,
                    "save_s": time.perf_counter() - t0,
                    "save_gib": sum(f.stat().st_size for f in (
                        self.dir / f"step_{step}").iterdir()) / 2**30})

    manager_cls.save = save
    try:
        yield out
    finally:
        manager_cls.save = orig


def train_run(torch, fa, overrides, run_dir, n_dense):
    """One ``esmdiff-torch-train --config configs/mdlm.yaml`` run on the
    card with ``overrides``: (numbers, the train steps' records, the eval
    batches' records, failures).  The first train step is off the clock."""
    from esmdiff_tpu_torch.cli import train as train_cli
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager

    steps, evals, saves, failures = [], [], [], []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with stepped(torch, tstate, "train_step", fa, steps), \
            stepped(torch, tstate, "eval_step", fa, evals), \
            timed_saves(torch, CheckpointManager, saves):
        result = train_cli.main([
            "--config", str(ROOT / "configs/mdlm.yaml"), *overrides,
            f"trainer.ckpt_dir={run_dir}", "trainer.print_config=false"])
    wall = time.time() - t0
    warm = steps[1:]
    warm_s = sum(r["ms"] for r in warm) / 1e3
    padded = sum(r["padded_tokens"] for r in warm)
    numbers = {
        "overrides": overrides, "steps": result["steps"], "wall_s": wall,
        "first_step_ms": steps[0]["ms"],
        "warm_ms_per_step": 1e3 * warm_s / len(warm),
        "real_tokens_per_s": sum(r["real_tokens"] for r in warm) / warm_s,
        "padded_tokens_per_s": padded / warm_s,
        # the trunk's products at 8 x params x padded tokens: forward 2,
        # backward 4, remat's recomputed forward 2 (attention not counted)
        "bf16_peak_share": 8 * n_dense * padded / warm_s / H100_BF16_FLOPS,
        "batch_shapes": [r["shape"] for r in steps],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_gib_before": resident / 2**30,
        "flash_per_train_step": sorted({r["flash"] for r in steps}),
        "flash_per_eval_batch": sorted({r["flash"] for r in evals}),
        "losses": [r["loss"] for r in steps],
        "grad_norms": [r["grad_norm"] for r in steps],
        "val_loss": result["best_val_loss"], "eval_batches": len(evals),
        "saves": saves}
    finite = [*numbers["losses"], *numbers["grad_norms"],
              numbers["val_loss"]]
    if not all(math.isfinite(x) for x in finite) or len(steps) < 2:
        failures.append(f"{overrides}: non-finite loss or grad norm, or "
                        f"fewer than 2 steps: {finite}")
    if len(saves) != 1:
        failures.append(f"{overrides}: {len(saves)} saves, expected 1")
    return numbers, steps, evals, failures


def train_kernel_vs_plain(torch, fa, corpus, failures):
    """One unpacked train step's forward and backward at full width on one
    batch with the same draws, three times: the kernel (flash), its plain
    version (p cast before normalising), and the trunk with
    ``attn_backend="xla"`` (JAX's XLA rounding).  Gated, for the structure
    logits, the whole gradient and the first and last ``attn.qkv`` and the
    last ``ffn.down`` gradients: rel L2 of kernel vs xla within twice
    that of the two plain roundings; the loss's relative change within
    twice the logits' floor, the grad norm's within twice the gradient's
    (the triangle inequality bounds it by the gradient's rel L2)."""
    from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
    from esmdiff_tpu_torch.train import data as data_mod
    from esmdiff_tpu_torch.train.config import load_config
    from esmdiff_tpu_torch.train.loop import (build_task, init_params,
                                              mdlm_modules, to_device)

    cfg = load_config(str(ROOT / "configs/mdlm.yaml"),
                      [f"data.path={corpus}", "data.pack_len=0"])
    mdlm, loss_fn = build_task(cfg, "cuda")
    init_params(mdlm, cfg)
    modules = mdlm_modules(mdlm)
    split, _ = data_mod.train_val_split(
        data_mod.EncodingDataset(cfg.data), cfg.data)
    batch = to_device(next(data_mod.batches(split, cfg.data, shuffle=True,
                                            seed=cfg.seed)), "cuda")
    L = mdlm.net.cfg.n_layers
    named = [f"net.transformer.blocks.{i}.{leaf}" for i, leaf in (
        (0, "attn.qkv.weight"), (L - 1, "attn.qkv.weight"),
        (L - 1, "ffn.down.weight"))]
    params = dict(modules.named_parameters())
    captured = {}
    hook = mdlm.net.output_heads.register_forward_hook(
        lambda m, i, out: captured.update(logits=out.structure_logits))

    def run(flash, backend):
        for block in mdlm.net.transformer.blocks:
            block.attn.attn_backend = backend
        saved, fa.flash_attention = fa.flash_attention, flash
        before = fa.launches
        try:
            modules.zero_grad(set_to_none=True)
            with torch.enable_grad():
                loss, _ = loss_fn(batch, GeneratorDraws("cuda", seed=0))
                loss.backward()
            torch.cuda.synchronize()
        finally:
            fa.flash_attention = saved
        return loss.item(), captured.pop("logits").float(), \
            fa.launches - before

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    t0 = time.time()
    ref_loss, ref_logits, ref_launches = run(fa.flash_attention, "xla")
    ref = {n: p.grad.clone() for n, p in params.items()
           if p.grad is not None}
    out = {}
    for key, flash in (("kernel", fa.flash_attention),
                       ("plain_version", fa.flash_attention_reference)):
        loss, logits, launches = run(flash, "auto")
        diff2 = norm2 = 0.0
        for n, g in ref.items():
            diff2 += (params[n].grad - g).float().norm().item() ** 2
            norm2 += g.float().norm().item() ** 2
        gnorm = math.sqrt(sum(p.grad.float().norm().item() ** 2
                              for p in params.values()
                              if p.grad is not None))
        out[key] = {
            "loss": loss, "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
            "grad_norm": gnorm, "grad_norm_rel":
                abs(gnorm - math.sqrt(norm2)) / math.sqrt(norm2),
            "logits_rel_l2": rel(logits, ref_logits),
            "grad_rel_l2": math.sqrt(diff2 / norm2),
            **{f"{n}_rel_l2": rel(params[n].grad, ref[n]) for n in named},
            "flash_launches": launches}
    hook.remove()
    k, floor = out["kernel"], out["plain_version"]
    for name in ("logits_rel_l2", "grad_rel_l2",
                 *(f"{n}_rel_l2" for n in named)):
        if not k[name] <= 2 * floor[name]:
            failures.append(f"train step, kernel vs xla: {name} {k[name]} "
                            f"> 2 x the plain roundings' {floor[name]}")
    for name, limit in (("loss_rel", "logits_rel_l2"),
                        ("grad_norm_rel", "grad_rel_l2")):
        if not k[name] <= 2 * floor[limit]:
            failures.append(f"train step, kernel vs xla: {name} {k[name]} "
                            f"> 2 x {limit}'s floor {floor[limit]}")
    want = 2 * L - mdlm.net.cfg.n_layers_geom
    if (k["flash_launches"], floor["flash_launches"], ref_launches) != \
            (want, 0, 0):
        failures.append(f"train step launches: kernel "
                        f"{k['flash_launches']} (want {want}), plain "
                        f"{floor['flash_launches']}, xla {ref_launches}")
    return {"batch_shape": list(batch["mask"].shape),
            "xla": {"loss": ref_loss, "grad_norm": math.sqrt(
                sum(g.float().norm().item() ** 2 for g in ref.values()))},
            **out, "s": time.time() - t0}


def train_path(torch, runtime, ops, card):
    """Phase 8 (module docstring).  Returns (numbers, launches of the
    path's runs: the dump, both training runs and the --ckpt sample, the
    unpacked run's checkpoint directory, which the vqvae path deletes)."""
    import numpy as np

    from esmdiff_tpu_torch.cli import dump as dump_cli
    from esmdiff_tpu_torch.cli import sample as sample_cli
    from esmdiff_tpu_torch.convert import checkpoints
    from esmdiff_tpu_torch.models.esm3 import ESM3
    from esmdiff_tpu_torch.nn.layers import Dense
    from esmdiff_tpu_torch.train.config import load_config
    from esmdiff_tpu_torch.train.loop import (build_mdlm, init_params,
                                              mdlm_modules, trunk_config)
    from esmdiff_tpu_torch.utils.checkpoint import load_params

    t_phase = time.time()
    fa = ops["flash_attention"]
    work = ROOT / "output" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    corpus = work / "corpus"
    failures = []

    # 1. the corpus: every chain under data/targets/{apo,codnas,ped}
    # through the full-width random-weight encoder (cli.dump)
    t0 = time.time()
    before = fa.launches
    dirs = [ROOT / "data/targets" / d for d in ("apo", "codnas", "ped")]
    n_files = sum(len(list(d.glob("*.pdb"))) for d in dirs)
    n_chains = sum(dump_cli.main([str(d), str(corpus)], runtime=runtime)
                   for d in dirs)
    lengths = []
    for f in sorted(corpus.glob("*.npz")):
        with np.load(f) as z:
            lengths.append(len(z["structure_tokens"]) - 2)
    corpus_numbers = {"chains": n_chains, "files": n_files,
                      "min_L": min(lengths), "max_L": max(lengths),
                      "residues": sum(lengths), "s": time.time() - t0,
                      "flash_launches": fa.launches - before}
    if n_chains != n_files or len(lengths) != n_files or \
            corpus_numbers["flash_launches"]:
        failures.append(f"corpus: {corpus_numbers}")
    print("[train corpus] " + json.dumps(corpus_numbers), flush=True)

    cfg = load_config(str(ROOT / "configs/mdlm.yaml"))
    tcfg = trunk_config(cfg)
    with torch.device("meta"):
        n_dense = sum(m.weight.numel() for m in ESM3(tcfg).modules()
                      if isinstance(m, Dense))
    n_layers = tcfg.n_layers
    launches = {"flash_attention": corpus_numbers["flash_launches"]}

    # 2. one unpacked epoch at full width
    run = work / "unpacked"
    unpacked, steps, evals, fails = train_run(
        torch, fa, [f"data.path={corpus}", "data.pack_len=0",
                    "trainer.max_epochs=1", "trainer.log_every_n_steps=1"],
        run, n_dense)
    failures += fails
    want = (2 * n_layers - tcfg.n_layers_geom, n_layers)
    if (unpacked["flash_per_train_step"], unpacked["flash_per_eval_batch"]) \
            != ([want[0]], [want[1]]):
        failures.append(f"unpacked flash launches per train step / eval "
                        f"batch {unpacked['flash_per_train_step']} / "
                        f"{unpacked['flash_per_eval_batch']}, want {want}")
    launches["flash_attention"] += sum(r["flash"] for r in steps + evals)
    step_dir = Path(json.loads(
        (run / "ckpt" / "index.json").read_text())[0]["path"])
    saved = load_params(step_dir)
    # the parameters moved: the saved ones against a fresh init of the seed
    fresh = build_mdlm(cfg, "cuda")
    init_params(fresh, cfg)
    fresh_sd = mdlm_modules(fresh).state_dict()
    moved = {k: not torch.equal(saved[k], fresh_sd[k].cpu()) for k in (
        "net.transformer.blocks.0.attn.qkv.weight",
        f"net.transformer.blocks.{n_layers - 1}.ffn.down.weight",
        "sigma_embedder.fc1.weight")}
    del fresh, fresh_sd
    unpacked["params_changed"] = moved
    if not all(moved.values()):
        failures.append(f"unpacked run: parameters unchanged: {moved}")
    print("[train unpacked] " + json.dumps(unpacked), flush=True)

    # 3. the shipped config: one epoch of packed rows of 512 (the corpus
    # packs into 6 batches)
    packed, steps, evals, fails = train_run(
        torch, fa, [f"data.path={corpus}", "trainer.max_epochs=1",
                    "trainer.log_every_n_steps=1"],
        work / "packed", n_dense)
    failures += fails
    if packed["flash_per_train_step"] != [0] or \
            packed["flash_per_eval_batch"] != [0]:
        failures.append(f"packed run launched flash: {packed}")
    shutil.rmtree(work / "packed")
    print("[train packed] " + json.dumps(packed), flush=True)

    # 4. kernel against plain in training, at full width
    gate = train_kernel_vs_plain(torch, fa, corpus, failures)
    torch.cuda.empty_cache()
    print("[train gate] " + json.dumps(gate), flush=True)

    # 5. --ckpt: the CLI loads the unpacked run and samples BPTI
    t0 = time.time()
    before = fa.launches
    with recorded(checkpoints, "load_runtime") as loaded:
        report = sample_cli.main([
            "--ckpt", str(run / "ckpt"), "--mode", "ddpm", "--input",
            str(ROOT / TARGET), "--output", str(work / "sample"),
            "--num_samples", "8", "--seed", "0"])[0]
    rt = loaded[0]
    own = {**{f"net.{k}": v for k, v in rt.trunk.state_dict().items()},
           **{f"sigma_embedder.{k}": v
              for k, v in rt.sigma_embedder.state_dict().items()}}
    differ = [k for k in saved
              if k not in own or not torch.equal(own[k].cpu(), saved[k])]
    if differ or own.keys() != saved.keys():
        failures.append(f"--ckpt runtime vs saved params: {differ[:8]}")
    pdb = work / "sample" / f"{report['target']}.pdb"
    check_pdb(pdb.read_text(), 8, 8 * (report["L"] * 4 - 1), str(pdb))
    lw = report["L"] + 2
    want_ckpt = path_launches(rt.trunk.cfg, rt.decoder.cfg.n_layers, lw,
                              False, num_samples=8)["flash_attention"]
    ckpt_numbers = {"s": time.time() - t0, "L": report["L"],
                    "sampling_s": report["sampling_sec"],
                    "params_equal_bit_for_bit": not differ,
                    "params_compared": len(saved),
                    "flash_launches": fa.launches - before,
                    "flash_launches_planned": want_ckpt}
    if ckpt_numbers["flash_launches"] != want_ckpt:
        failures.append(f"--ckpt sample launches {ckpt_numbers}")
    launches["flash_attention"] += ckpt_numbers["flash_launches"]
    del rt, loaded, own, saved
    # the corpus stays for the weights path's fine-tune
    shutil.rmtree(work / "sample")
    torch.cuda.empty_cache()
    numbers = {"card": card, "phase_s": time.time() - t_phase,
               "trunk_dense_params": n_dense, "corpus": corpus_numbers,
               "unpacked": unpacked, "packed": packed, "gate": gate,
               "ckpt": ckpt_numbers, "launches": launches}
    if failures:
        print("[train path] " + json.dumps(numbers), flush=True)
        raise AssertionError("train path: " + "; ".join(failures))
    return numbers, launches, run / "ckpt"


@contextlib.contextmanager
def calls(torch, owner, name, fa, out):
    """Wraps ``owner.name`` while the block runs: each call synchronised
    before and after, its seconds, flash launches, arguments and result
    appended to ``out``; the call itself is unchanged."""
    orig = getattr(owner, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        before, t0 = fa.launches, time.perf_counter()
        result = orig(*args, **kwargs)
        torch.cuda.synchronize()
        out.append({"s": time.perf_counter() - t0,
                    "flash": fa.launches - before, "args": args,
                    "result": result})
        return result

    setattr(owner, name, wrapped)
    try:
        yield out
    finally:
        setattr(owner, name, orig)


def vq_probe(torch, tvq, tstate, cfgs, corpus, batch):
    """Two VQ train steps (forward, backward, AdamW: the second with the
    Adam moments allocated) of a fresh full-geometry model at ``batch`` on
    the longest chains: the peak GiB, or None when the card runs out of
    memory (activations have static shapes, so the chains do not change
    the answer)."""
    import numpy as np

    coords, lengths = corpus
    held = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with torch.device("cuda"):
            held["model"] = model = tvq.VQVAE(*cfgs)
        tvq.init_vqvae(model, 0)
        held["state"] = state = tstate.create_train_state(
            model, tstate.make_optimizer(model.parameters(), lr=3e-4,
                                         weight_decay=0.01, grad_clip=1.0))
        b = tvq.gather_batch(coords, lengths,
                             np.argsort(lengths)[-batch:], "cuda")
        for _ in range(2):
            tstate.train_step(state, lambda bb, d: tvq.batch_loss(
                model, bb, tvq.VQLossConfig()), b, None)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2**30
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        held.clear()
        gc.collect()
        torch.cuda.empty_cache()


def check_flash_unmasked(torch, fa, B, L, H, gen):
    """The flash kernel with no lengths (the VQ decoder's call) against
    its plain version, and its device time beside the bound and SDPA."""
    import torch.nn.functional as F

    q, k, v = (torch.randn(B, L, H, 64, device="cuda", dtype=torch.bfloat16,
                           generator=gen) for _ in range(3))
    res = compare(torch, "flash_attention", fa.flash_attention(q, k, v),
                  fa.flash_attention_reference(q, k, v), (B, L, H))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    full = torch.full((B,), L, device="cuda", dtype=torch.int32)
    return {"B": B, "L": L, "H": H, **res,
            "ms": device_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": device_ms(
                lambda: fa.flash_attention_reference(q, k, v)),
            "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt)),
            **bound(*attention_cost(q, full))}


def vq_kernel_vs_plain(torch, fa, tvq, model, batch, failures):
    """One VQ train step's forward and backward (the trained parameters,
    one unaugmented batch) three times: the decoder on the kernel, on its
    plain version, and on ``attn_backend="xla"``.  Gated: bb_pred, the
    whole gradient and the bridge and codebook gradients, kernel vs xla
    in relative L2, within twice the spread of the two plain roundings;
    the loss's relative change within twice bb_pred's floor.  The encoder
    runs the same ops in all three (so its codebook gradient agrees
    exactly).  Returns the numbers and bb_pred's floor."""
    params = dict(model.named_parameters())
    named = ("bridge.weight", "encoder.codebook")
    blocks = model.decoder.decoder_stack.blocks

    def run(flash, backend):
        for block in blocks:
            block.attn.attn_backend = backend
        saved, fa.flash_attention = fa.flash_attention, flash
        before = fa.launches
        try:
            model.zero_grad(set_to_none=True)
            with torch.enable_grad():
                out, aux = model(batch["coords"], batch["lengths"])
                loss, _ = tvq.vqvae_loss(
                    out, aux, batch["coords_clean"], batch["coord_mask"],
                    batch["lengths"], tvq.VQLossConfig())
                loss.backward()
            torch.cuda.synchronize()
        finally:
            fa.flash_attention = saved
            for block in blocks:
                block.attn.attn_backend = "auto"
        return loss.item(), out["bb_pred"].detach().float(), \
            fa.launches - before

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    t0 = time.time()
    ref_loss, ref_bb, ref_launches = run(fa.flash_attention, "xla")
    ref = {n: p.grad.clone() for n, p in params.items()
           if p.grad is not None}
    out = {}
    for key, flash in (("kernel", fa.flash_attention),
                       ("plain_version", fa.flash_attention_reference)):
        loss, bb, launches = run(flash, "auto")
        diff2 = norm2 = 0.0
        for n, g in ref.items():
            diff2 += (params[n].grad - g).float().norm().item() ** 2
            norm2 += g.float().norm().item() ** 2
        out[key] = {"loss": loss,
                    "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                    "bb_pred_rel_l2": rel(bb, ref_bb),
                    "grad_rel_l2": math.sqrt(diff2 / norm2),
                    **{f"{n}_grad_rel_l2": rel(params[n].grad, ref[n])
                       for n in named},
                    "flash_launches": launches}
    model.zero_grad(set_to_none=True)
    k, floor = out["kernel"], out["plain_version"]
    for name in ("bb_pred_rel_l2", "grad_rel_l2",
                 *(f"{n}_grad_rel_l2" for n in named)):
        if not k[name] <= 2 * floor[name]:
            failures.append(f"VQ step, kernel vs xla: {name} {k[name]} > 2 "
                            f"x the plain roundings' {floor[name]}")
    if not k["loss_rel"] <= 2 * floor["bb_pred_rel_l2"]:
        failures.append(f"VQ step, kernel vs xla: loss_rel {k['loss_rel']}"
                        f" > 2 x bb_pred's floor {floor['bb_pred_rel_l2']}")
    want = 2 * len(blocks)
    if (k["flash_launches"], floor["flash_launches"], ref_launches) != \
            (want, 0, 0):
        failures.append(f"VQ step launches: kernel {k['flash_launches']} "
                        f"(want {want}), plain {floor['flash_launches']}, "
                        f"xla {ref_launches}")
    return {"batch_shape": list(batch["coords"].shape[:2]),
            "xla": {"loss": ref_loss}, **out, "s": time.time() - t0}, \
        floor["bb_pred_rel_l2"]


def vq_split_ms(torch, tvq, model, batch, reps=3):
    """Synchronised wall ms of one VQ forward and backward, and of the
    encoder's alone (the backward of its outputs' sum): the encoder's
    share of a step.  Mean of ``reps`` calls after one warm call."""
    def encoder():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            _, z, _, z_q = model.encoder(batch["coords"], return_zq=True)
            (z.float().sum() + z_q.sum()).backward()

    def step():
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            tvq.batch_loss(model, batch, tvq.VQLossConfig())[0].backward()

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    out = {"encoder_fwd_bwd_ms": ms(encoder), "step_fwd_bwd_ms": ms(step)}
    model.zero_grad(set_to_none=True)
    out["encoder_share"] = out["encoder_fwd_bwd_ms"] / out["step_fwd_bwd_ms"]
    return out


def vqvae_path(torch, ops, card, gen, mdlm_ckpt):
    """Phase 10 (module docstring).  ``mdlm_ckpt``: the train path's
    unpacked run, for --vqvae_ckpt.  Returns (numbers, launches of the
    path's runs: the CLI's training and the --vqvae_ckpt sample, the
    export), leaving its work directory for the AR path."""
    from esmdiff_tpu_torch.cli import sample as sample_cli
    from esmdiff_tpu_torch.cli import train_vqvae as vq_cli
    from esmdiff_tpu_torch.convert import checkpoints
    from esmdiff_tpu_torch.models.vqvae import StructureTokenDecoder
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train import vqvae as tvq
    from esmdiff_tpu_torch.utils.checkpoint import load_params

    import numpy as np

    t_phase = time.time()
    fa = ops["flash_attention"]
    work = ROOT / "output" / "chip_smoke_vqvae"
    shutil.rmtree(work, ignore_errors=True)
    failures = []
    # the corpus: the chains of data/targets/{apo,codnas,ped}
    chains = work / "chains"
    for d in VQ_DIRS:
        shutil.copytree(ROOT / "data/targets" / d, chains / d)
    cfgs = vq_cli._geometry("full")
    n_layers = cfgs[1].n_layers
    corpus = vq_cli.load_corpus(chains, 512, log=lambda m: None)[:2]

    # 1. the CLI's default batch, two steps, printed (the run takes 16)
    probe = vq_probe(torch, tvq, tstate, cfgs, corpus, VQ_PROBE)
    capacity = torch.cuda.get_device_properties(0).total_memory / 2**30
    print(f"[vqvae probe] batch {VQ_PROBE}, two steps: " + (
        "out of memory" if probe is None else f"peak {probe:.2f} GiB")
        + f" of {capacity:.2f} GiB", flush=True)
    batch = VQ_BATCH

    # 2. esmdiff-torch-train-vqvae as it ships, but --steps
    export = work / "export"
    steps, vals, gathers, restarts, exports = [], [], [], [], []
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before, t0 = fa.launches, time.time()
    with calls(torch, tstate, "train_step", fa, steps), \
            calls(torch, tvq, "val_recon", fa, vals), \
            calls(torch, tvq, "gather_batch", fa, gathers), \
            calls(torch, tvq, "restart_dead_codes", fa, restarts), \
            calls(torch, vq_cli, "export_vqvae", fa, exports):
        summary = vq_cli.main([
            "--input", str(chains), "--output", str(export), "--scale",
            "full", "--steps", str(VQ_STEPS), "--batch", str(batch),
            "--restart_every", "10", "--augment", "--seed", "0"])
    wall = time.time() - t0
    train_launches = fa.launches - before
    train_gathers = [g for g in gathers if len(g["args"]) == 6]
    warm = steps[1:]
    warm_s = sum(r["s"] for r in warm)
    real = sum(int(g["result"]["lengths"].sum()) for g in train_gathers[1:])
    losses = [float(r["result"]["loss"]) for r in steps]
    val_recon = [float(r["result"]) for r in vals]
    numbers = {
        "batch": batch, f"probe_{VQ_PROBE}_peak_gib": probe,
        "card_gib": capacity, "steps": len(steps),
        "structures": summary["n_structures"],
        "pad_L": int(corpus[0].shape[1]), "wall_s": wall,
        "first_step_ms": 1e3 * steps[0]["s"],
        "warm_ms_per_step": 1e3 * warm_s / len(warm),
        "residues_per_s": real / warm_s,
        "padded_residues_per_s": len(warm) * batch * corpus[0].shape[1]
        / warm_s,
        "host_share": sum(g["s"] for g in train_gathers[1:])
        / (warm_s + sum(g["s"] for g in train_gathers[1:])),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_gib_before": resident / 2**30,
        "export_s": exports[0]["s"],
        "export_gib": sum(f.stat().st_size for f in export.iterdir())
        / 2**30,
        "flash_per_train_step": sorted({r["flash"] for r in steps}),
        "flash_per_val_recon": [r["flash"] for r in vals],
        "flash_launches": train_launches,
        "losses": losses, "val_recon": val_recon,
        "restarted": [r["result"] for r in restarts],
        "n_live_codes": summary["n_live_codes"]}
    if len(steps) != VQ_STEPS or numbers["flash_per_train_step"] != \
            [2 * n_layers] or numbers["flash_per_val_recon"] != \
            [n_layers, n_layers] or train_launches != \
            VQ_STEPS * 2 * n_layers + 2 * n_layers:
        failures.append(f"VQ launches: {len(steps)} steps, "
                        f"{numbers['flash_per_train_step']} a step, "
                        f"{numbers['flash_per_val_recon']} a val_recon, "
                        f"{train_launches} in all")
    if not all(math.isfinite(x) for x in losses + val_recon):
        failures.append(f"VQ losses not finite: {losses} {val_recon}")
    if not val_recon[-1] < val_recon[0]:
        failures.append(f"val_recon did not fall: {val_recon}")
    if not sum(numbers["restarted"]):
        failures.append(f"no dead code restarted: {numbers['restarted']}")
    vq_params = exports[0]["args"][3]
    with torch.device("cuda"):
        fresh = tvq.init_vqvae(tvq.VQVAE(*cfgs), 0).state_dict()
    moved = {k: not torch.equal(vq_params[k], fresh[k]) for k in (
        "encoder.codebook", "bridge.weight",
        "decoder.decoder_stack.blocks.0.attn.qkv.weight")}
    del fresh
    numbers["params_changed"] = moved
    if not all(moved.values()):
        failures.append(f"VQ parameters unchanged: {moved}")
    print("[vqvae train] " + json.dumps(numbers), flush=True)

    # 3. kernel against plain in a VQ step, on the trained parameters
    with torch.device("cuda"):
        model = tvq.VQVAE(*cfgs)
    model.load_state_dict(vq_params, strict=True)
    del steps, exports, vq_params
    torch.cuda.empty_cache()
    idx = np.random.RandomState(0).choice(len(corpus[1]), batch)
    vbatch = tvq.gather_batch(*corpus, idx, "cuda")
    gate, bb_floor = vq_kernel_vs_plain(torch, fa, tvq, model, vbatch,
                                        failures)
    print("[vqvae gate] " + json.dumps(gate), flush=True)
    split = vq_split_ms(torch, tvq, model, vbatch)
    print("[vqvae split] " + json.dumps(split), flush=True)

    # 4. the export: load_vqvae, the standalone decoder on full_tokens
    enc_cfg, _, dec_cfg, dec_params = checkpoints.load_vqvae(export)
    with torch.device("cuda"):
        decoder = StructureTokenDecoder(dec_cfg)
    decoder.load_state_dict(dec_params, strict=True)
    with torch.no_grad():
        out, aux = model(vbatch["coords"], vbatch["lengths"])
        alone = decoder.eval()(aux["full_tokens"], compute_ptm=False)
    export_rel = ((alone["bb_pred"].float() - out["bb_pred"].float()).norm()
                  / out["bb_pred"].float().norm()).item()
    export_numbers = {"cfgs_equal": (enc_cfg, dec_cfg) == cfgs,
                      "bb_pred_rel_l2": export_rel,
                      "bb_pred_floor": bb_floor}
    if not export_numbers["cfgs_equal"] or not export_rel <= 2 * bb_floor:
        failures.append(f"export: {export_numbers}")
    del model, decoder, dec_params, out, aux, alone
    torch.cuda.empty_cache()

    # 5. --vqvae_ckpt: the train path's trunk with the trained tokenizer
    t0 = time.time()
    before = fa.launches
    with recorded(checkpoints, "load_runtime") as loaded:
        report = sample_cli.main([
            "--ckpt", str(mdlm_ckpt), "--vqvae_ckpt", str(export), "--mode",
            "ddpm", "--input", str(ROOT / TARGET), "--output",
            str(work / "sample"), "--num_samples", "8", "--seed", "0"])[0]
    rt = loaded[0]
    saved = load_params(export)
    own = {**{f"encoder.{k}": v for k, v in rt.encoder.state_dict().items()},
           **{f"decoder.{k}": v for k, v in rt.decoder.state_dict().items()}}
    differ = [k for k in saved
              if k not in own or not torch.equal(own[k].cpu(), saved[k])]
    if differ or own.keys() != saved.keys():
        failures.append(f"--vqvae_ckpt runtime vs saved: {differ[:8]}")
    pdb = work / "sample" / f"{report['target']}.pdb"
    check_pdb(pdb.read_text(), 8, 8 * (report["L"] * 4 - 1), str(pdb))
    want = path_launches(rt.trunk.cfg, rt.decoder.cfg.n_layers,
                         report["L"] + 2, False,
                         num_samples=8)["flash_attention"]
    sample_numbers = {"s": time.time() - t0, "L": report["L"],
                      "sampling_s": report["sampling_sec"],
                      "params_equal_bit_for_bit": not differ,
                      "params_compared": len(saved),
                      "flash_launches": fa.launches - before,
                      "flash_launches_planned": want}
    if sample_numbers["flash_launches"] != want:
        failures.append(f"--vqvae_ckpt sample launches {sample_numbers}")
    del rt, loaded, own, saved
    torch.cuda.empty_cache()

    # 6. the flash kernel at the decoder's VQ shape (and B 32), printed
    kernel = [check_flash_unmasked(torch, fa, b, corpus[0].shape[1] + 2,
                                   cfgs[1].n_heads, gen)
              for b in sorted({batch, 32})]
    for row in kernel:
        print("[kernel] flash_attention vqvae " + json.dumps(row),
              flush=True)
    numbers = {"card": card, "phase_s": time.time() - t_phase,
               "train": numbers, "gate": gate, "split": split,
               "export": export_numbers,
               "vqvae_ckpt": sample_numbers, "flash_vq_shape": kernel,
               "launches": {"flash_attention": train_launches
                            + sample_numbers["flash_launches"]}}
    if failures:
        print("[vqvae path] " + json.dumps(numbers), flush=True)
        raise AssertionError("vqvae path: " + "; ".join(failures))
    return numbers, numbers["launches"], export


# the AR path: cli.sample_ar as it ships (configs/predict.yaml's inference
# block: 100 samples, batch 32, temperature 1.0, top_p 0.95), seed 0, at
# the geometry of each training config
AR_CONFIGS = {"clm": "configs/clm.yaml", "jlm": "configs/jlm.yaml"}
AR_BATCH, AR_TEMPERATURE, AR_TOP_P = 32, 1.0, 0.95
# one batch each: the int8 request (its step is the slowest) and the
# --runtime_ckpt one
AR_INT8_SAMPLES = AR_CKPT_SAMPLES = 32


def ar_launches(runtime, cfg, model_type, lw, num_samples, quant):
    """Launches of one target's AR request: flash, the trunk forward (a
    launch a layer) and one VQ decoder call a layer for each chunk of 32
    rows; the AR net's int8 products with ``quant``, a batch: the CLM's
    encoder 7 a layer, its cross K/V 2 a layer and 9 a decoder layer in
    each of the lw steps; the JLM's prefill and lw - 1 steps 4 a layer
    each."""
    batches = -(-num_samples // AR_BATCH)
    per_batch = (cfg.n_layers * (7 + 2 + 9 * lw) if model_type == "clm"
                 else cfg.n_layers * 4 * lw)
    return {"flash_attention": runtime.trunk.cfg.n_layers
            + runtime.decoder.cfg.n_layers * -(-num_samples // DECODE_BATCH),
            "small_attention": 0, "fused_qkv": 0, "fused_ffn": 0,
            "int8": per_batch * batches if quant else 0}


def ar_request(torch, runtime, ops, argv, model_type, out):
    """One request through ``cli.sample_ar`` (``runtime`` None: the CLI
    builds it from ``--runtime_ckpt``), its launches counted from 0 and
    checked against ``ar_launches``, its PDB checked, and no structure
    special in any sampled token.  Returns (the CLI's report with the
    launches and peak GiB, the runtime, the AR net the CLI built, the
    sampled token batches)."""
    from esmdiff_tpu_torch.cli import sample_ar
    from esmdiff_tpu_torch.convert import checkpoints
    from esmdiff_tpu_torch.ops import quant

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for op in (*ops.values(), quant):
        op.launches = 0
    with recorded(sample_ar, "prepare_model") as models, \
            recorded(sample_ar, f"{model_type}_generate") as batches, \
            recorded(checkpoints, "load_runtime") as loaded:
        (report,) = sample_ar.main(
            [*argv, "--output", str(out), "--seed", "0"], runtime=runtime)
    launches = {k: op.launches for k, op in ops.items()}
    launches["int8"] = quant.launches
    runtime = runtime or loaded[0]
    n, lw = report["n_samples"], report["L"] + 2
    want = ar_launches(runtime, models[0].cfg, model_type, lw, n,
                       "--quant" in argv)
    where = f"ar path, {model_type} {' '.join(argv)}"
    if launches != want:
        raise AssertionError(f"{where}: launches {launches}, expected {want}")
    pdb = out / f"{report['target']}.pdb"
    check_pdb(pdb.read_text(), n, n * (report["L"] * 4 - 1), str(pdb))
    specials = sum(int((b >= 4096).sum()) for b in batches)
    if specials or sum(b.shape[0] for b in batches) != n:
        raise AssertionError(f"{where}: {specials} structure specials "
                             "sampled")
    report.update(launches=launches, peak_memory_gib=(
        torch.cuda.max_memory_allocated() / 2**30))
    return report, runtime, models[0], batches


def ar_numbers(report):
    lw, ar_s = report["L"] + 2, report["ar_sec"]
    return {"L": report["L"], "quant": report["quant"],
            "conformations_per_s": report["n_samples"] / report["total_sec"],
            "total_s": report["total_sec"], "trunk_s": report["trunk_sec"],
            "ar_s": ar_s, "vq_decode_s": report["decode_sec"],
            "batches": report["batches"],
            "ms_per_decode_step": 1e3 * ar_s / (report["batches"] * lw),
            "tokens_per_s": report["n_samples"] * lw / ar_s,
            "peak_memory_gib": report["peak_memory_gib"],
            "launches": report["launches"]}


def ar_inputs(torch, runtime, model, path, tokens):
    """The embeddings of ``path``'s sequence for ``tokens``' rows (the
    trunk's forward, as the CLI runs it) and the teacher-forced inputs of
    those sampled tokens: the CLM's decoder inputs (start token, then
    tokens shifted right), the JLM's structure tokens (BOS, then shifted
    right)."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein
    from esmdiff_tpu_torch.core import constants as C

    seq = ESMProtein.from_pdb(path).sequence
    toks = torch.as_tensor(runtime.seq_tokenizer.encode(seq), device="cuda")
    emb = runtime.trunk(sequence_tokens=toks[None]).embeddings[0].float()
    first = (model.cfg.decoder_start_token_id if hasattr(
        model.cfg, "decoder_start_token_id") else C.STRUCTURE_BOS_TOKEN)
    ids = torch.cat([torch.full_like(tokens[:, :1], first), tokens[:, :-1]],
                    1)
    return emb[None].expand(tokens.shape[0], -1, -1), ids


def ar_full_logits(model, emb, ids):
    """Teacher-forced logits (B, L, V): the CLM's ``decode_train``, the
    JLM's training forward's structure logits."""
    if hasattr(model, "decode_train"):
        enc = model.encode(emb)
        return model.decode_train(
            ids, enc, cond_embeds=enc if model.cfg.dec_add_input_emb
            else None)
    return model(emb, ids)["structure_logits"]


def ar_decoder(model, emb, ids):
    """The KV-cached decode of ``ids`` as the generate functions run it:
    a function ``step(p)`` -> the float32 logits of position p (in order;
    the JLM's p = 0 is its prefill)."""
    from esmdiff_tpu_torch.models.clm import causal_table

    B, L = ids.shape
    if hasattr(model, "decode_train"):
        enc = model.encode(emb)
        caches = model.init_cache(B, L)
        ctx = model.decode_context(enc, L)
        add = model.cfg.dec_add_input_emb
        return lambda p: model.decode_step(
            ids[:, p], p, enc, caches, cond_embed=enc[:, p] if add else None,
            context=ctx)
    T_max = emb.shape[1] + model.cfg.offset + L + 1
    caches = model.init_cache(B, T_max)
    causal = causal_table(T_max, emb.device)
    prompt = []

    def step(p):
        if p == 0:
            logits, T = model.prefill(emb, ids[:, :1], caches, causal)
            prompt.append(T)
            return logits
        pos = prompt[0] + p - 1
        pos_id = p if model.cfg.sep_strategy == "position" else pos
        return model.decode_step(ids[:, p], pos, caches, pos_id, causal)

    return step


def float32_product(self, x):
    """A ``Dense.forward`` whose product is a float32 product of the same
    bf16 operands: another rounding of the same bf16 net."""
    import torch.nn.functional as F

    bias = None if self.bias is None else self.bias.to(self.dtype).float()
    return F.linear(x.to(self.dtype).float(),
                    self.weight.to(self.dtype).float(), bias).to(self.dtype)


def ar_gate(torch, model, emb, ids):
    """Relative L2 of the cached decode's logits against the teacher-forced
    forward on the same tokens, and the floor: the forward against itself
    with every Dense product accumulated as a float32 product of the same
    bf16 operands (another rounding of the same bf16 net)."""
    from esmdiff_tpu_torch.nn.layers import Dense

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    full = ar_full_logits(model, emb, ids)
    step = ar_decoder(model, emb, ids)
    cached = torch.stack([step(p) for p in range(ids.shape[1])], 1)
    orig = Dense.forward
    Dense.forward = float32_product
    try:
        other = ar_full_logits(model, emb, ids)
    finally:
        Dense.forward = orig
    return rel(cached, full), rel(other, full), full


def ar_step_bytes_and_flops(model, emb, ids):
    """What one decode step of the batch must read at its last position
    (the weights a step uses once, the K/V caches and the CLM's cross K/V
    in bf16, the uniforms) and its products' operations."""
    B, L = ids.shape
    skip = (("adapter.", "token_embed.", "enc_", "dec_relpos.")
            if hasattr(model, "decode_train") else
            ("seq_adapter.", "sequence_head.", "structure_embed.", "wpe.",
             "token_type.", "sep_token"))
    weights = [t for name, t in (*model.named_parameters(),
                                 *model.named_buffers())
               if not name.startswith(skip)
               and not (".cross_attn.k." in name or ".cross_attn.v." in name)]
    matmul = sum(t.numel() for t in weights if t.dim() == 2)
    if hasattr(model, "decode_train"):
        cfg = model.cfg
        kv = cfg.n_layers * 2 * 2 * B * (L + emb.shape[1]) * cfg.d_model
    else:
        cfg = model.cfg
        kv = (cfg.n_layers * 2 * 2 * B * (emb.shape[1] + cfg.offset + L + 1)
              * cfg.n_embd)
    nbytes = sum(t.numel() * t.element_size() for t in weights) + kv \
        + B * 4101 * 4
    # products: 2 a weight a row; scores and PV: 2 a cached element, and
    # kv counts 2 bytes an element
    return nbytes, 2 * B * matmul + kv


def ar_step_anatomy(torch, model, emb, ids, u):
    """One decode step of the batch at its last position, as the generate
    functions run it (``decode_step``, the shield, top-p, the Gumbel-max
    over the uniforms ``u``): the host ms of one enqueue
    (``tools/timing.py``'s ``host_ms``), the wall ms of a step run back to
    back and synchronised at the end, the device ms summed over its
    kernels under ``torch.profiler`` (one stream: the busy time; the
    profiled steps are not the timed ones), the busy share, the device ms
    of the same step replayed from one CUDA graph (``device_ms``), and
    the bound from the bytes it must read."""
    from esmdiff_tpu_torch.api.ar_generation import (sample_token,
                                                     shield_specials,
                                                     special_shield)

    last = ids.shape[1] - 1
    step_at = ar_decoder(model, emb, ids)
    for p in range(last):
        step_at(p)
    shield = special_shield("cuda")

    def step():
        return sample_token(u, shield_specials(step_at(last), shield),
                            AR_TEMPERATURE, AR_TOP_P)

    enqueue_ms = host_ms(step, calls=20)
    steps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / steps
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph_ms = device_ms(graph.replay, iters=20)
    del graph
    nbytes, flops = ar_step_bytes_and_flops(model, emb, ids)
    return {"batch": list(ids.shape), "host_enqueue_ms": enqueue_ms,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernels_per_step": len(kernels) / steps,
            "cuda_graph_device_ms": graph_ms,
            "bytes_read": nbytes, **bound(flops, nbytes)}


def ar_path(torch, runtime, ops, card, target_dirs):
    """The AR path's main part (module docstring): each model through the
    CLI on both targets, int8 on BPTI, the gate, the step's anatomy.
    Returns (numbers, flash launches of its requests)."""
    t_phase = time.time()
    work = ROOT / "output" / "chip_smoke_ar"
    shutil.rmtree(work, ignore_errors=True)
    numbers, flash = {"card": card}, 0
    bpti = next((ROOT / TARGET).glob("*.pdb"))
    for model_type, cfg in AR_CONFIGS.items():
        common = ["--config", str(ROOT / cfg)]
        # untimed: allocator growth and cuBLAS set-up, 2 rows
        ar_request(torch, runtime, ops,
                   [*common, "--input", str(ROOT / TARGET), "--n_samples",
                    "2", "--batch_size", "2"], model_type,
                   work / "warmup" / model_type)
        out = numbers[model_type] = {}
        for key, d in target_dirs.items():
            report, _, model, batches = ar_request(
                torch, runtime, ops, [*common, "--input", str(d)],
                model_type, work / model_type / key)
            flash += report["launches"]["flash_attention"]
            out[key] = ar_numbers(report)
            if key == "bpti":
                emb, ids = ar_inputs(torch, runtime, model, bpti, batches[0])
                rel, floor, full = ar_gate(torch, model, emb, ids)
                out["gate"] = {"batch": list(ids.shape),
                               "rel_l2_cached_vs_forward": rel,
                               "rel_l2_two_roundings": floor}
                if not rel <= 2 * floor:
                    raise AssertionError(
                        f"ar path, {model_type}: cached decode vs forward "
                        f"relative L2 {rel}, more than twice the two "
                        f"roundings' {floor}")
                u = torch.rand(ids.shape[0], 4101, device="cuda")
                out["step"] = ar_step_anatomy(torch, model, emb, ids, u)
                print(f"[ar step] {model_type} " + json.dumps(out["step"]),
                      flush=True)
            del model, batches
        report, _, qmodel, _ = ar_request(
            torch, runtime, ops, [*common, "--input", str(ROOT / TARGET),
                                  "--quant", "int8", "--n_samples",
                                  str(AR_INT8_SAMPLES)],
            model_type, work / model_type / "int8")
        flash += report["launches"]["flash_attention"]
        out["int8_bpti"] = ar_numbers(report)
        q_full = ar_full_logits(qmodel, emb, ids)
        out["int8_bpti"]["logits_rel_l2_int8_vs_bf16"] = (
            (q_full - full).norm() / full.norm()).item()
        out["int8_bpti"]["step"] = ar_step_anatomy(torch, qmodel, emb, ids,
                                                   u)
        del qmodel, q_full, full, emb, ids
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[ar path] {model_type} " + json.dumps(out), flush=True)
    shutil.rmtree(work)
    numbers["phase_s"] = time.time() - t_phase
    return numbers, flash


def ar_ckpt_request(torch, ops, card, mdlm_ckpt, export):
    """The AR path's last request: CLM (configs/clm.yaml) with
    ``--runtime_ckpt`` (the train path's run) and ``--vqvae_ckpt`` (the
    vqvae path's export) on BPTI: exact launches, a finite PDB, the
    runtime's decoder holding the export bit for bit."""
    from esmdiff_tpu_torch.utils.checkpoint import load_params

    work = ROOT / "output" / "chip_smoke_ar_ckpt"
    shutil.rmtree(work, ignore_errors=True)
    report, runtime, _, _ = ar_request(
        torch, None, ops,
        ["--config", str(ROOT / AR_CONFIGS["clm"]), "--runtime_ckpt",
         str(mdlm_ckpt), "--vqvae_ckpt", str(export), "--input",
         str(ROOT / TARGET), "--n_samples", str(AR_CKPT_SAMPLES)],
        "clm", work)
    saved = load_params(export)
    own = {f"decoder.{k}": v for k, v in runtime.decoder.state_dict().items()}
    differ = [k for k in own if not torch.equal(own[k].cpu(), saved[k])]
    if differ:
        raise AssertionError(f"ar path --vqvae_ckpt decoder vs saved: "
                             f"{differ[:8]}")
    shutil.rmtree(work)
    return {"card": card, **ar_numbers(report),
            "decoder_tensors_equal_bit_for_bit": len(own)}, \
        report["launches"]["flash_attention"]


# the eval path: esmdiff-torch-analyze on the default path's ensembles.
# BPTI's stand-in reference trajectory has EVAL_FRAMES frames; the
# card-against-CPU gate cuts it to its first EVAL_CPU_FRAMES (for the
# CPU's time); TICA at the CLI's lag
EVAL_FRAMES, EVAL_CPU_FRAMES, EVAL_LAGTIME = 100_000, 10_000, 500
# JSON keys held exactly card against CPU: TM (host C++ on the same
# arrays) and validity (counts of the same distances)
EVAL_EXACT = ("TM-", "RMSD-ens", "per_cluster", "tm", "val_", "gaps")


def stand_in_trajectory(n_frames, seed=0):
    """A seeded random walk of BPTI's CA around the structure, (frames,
    58, 3) float32 in nm: two slow collective modes (random displacement
    fields of 2.0 and 1.5 A rms, AR(1) coefficients 0.9998 and 0.999:
    correlation times of ~5000 and ~1000 frames, past the lag of 500) and
    independent noise on every atom and frame (0.5 A rms), so that TICA's
    top two components stand well apart from the rest."""
    import numpy as np
    from scipy.signal import lfilter

    from esmdiff_tpu_torch.core.protein import load_ca_ensemble

    ca = load_ca_ensemble(ROOT / TARGET / "bpti.pdb")[0].astype(np.float64)
    rng = np.random.default_rng(seed)

    def ar1(a, shape):   # unit stationary variance
        return lfilter([math.sqrt(1 - a * a)], [1.0, -a],
                       rng.standard_normal(shape), axis=0)

    x = np.repeat(ca[None], n_frames, axis=0)
    for amp, a in ((2.0, 0.9998), (1.5, 0.999)):
        field = rng.standard_normal(ca.shape)
        x += ar1(a, (n_frames, 1, 1)) * (
            field * amp / np.sqrt((field ** 2).sum(-1).mean()))
    x += rng.standard_normal(x.shape) * (0.5 / math.sqrt(3))
    return (x / 10.0).astype(np.float32)


def apo_layout(work, samples_pdb):
    """The apo suite's inputs, as tests/test_analysis.py's real-target CLI
    test builds them: 1jm4.B and a holo partner (the same chain minus 4
    residues at its middle, renumbered from 200; here also its atoms moved
    by 0.5 A, seeded, so that the pair's per-residue RMSD is a signal and
    not rounding noise) in the splits layout <dir>/<name[:2]>/<name>, the
    default path's ensemble as the samples, and the splits CSV."""
    import csv
    import dataclasses

    import numpy as np

    from esmdiff_tpu_torch.core import protein

    prot = protein.from_pdb_file(ROOT / L128_TARGET)
    L = len(prot.aatype)
    keep = np.ones(L, bool)
    keep[L // 2:L // 2 + 4] = False
    moved = prot.atom_positions + np.random.RandomState(0).randn(
        *prot.atom_positions.shape).astype(np.float32) * 0.5
    holo = dataclasses.replace(
        prot, atom_positions=moved[keep], atom_mask=prot.atom_mask[keep],
        aatype=prot.aatype[keep], b_factors=prot.b_factors[keep],
        residue_index=np.arange(200, 200 + keep.sum(), dtype=np.int32))
    name1, name2 = L128_TARGET.name, f"{L128_TARGET.stem}_holo.pdb"
    structures, samples = work / "structures", work / "samples"
    for name, p in ((name1, prot), (name2, holo)):
        (structures / name[:2]).mkdir(parents=True, exist_ok=True)
        protein.to_pdb_file(p, structures / name[:2] / name)
    samples.mkdir(parents=True)
    shutil.copy(samples_pdb, samples / samples_pdb.name)
    with open(work / "apo.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "holo", "seqres"])
        w.writeheader()
        w.writerow({"name": name1, "holo": name2, "seqres": prot.sequence})
    return ["--samples", str(samples), "--pairs-csv", str(work / "apo.csv"),
            "--structures", str(structures)]


def analyze_run(torch, argv, out, device):
    """One ``esmdiff-torch-analyze`` run in this process (its printed JSON
    kept in ``out/stdout.txt``): (each output file's values, seconds)."""
    import csv

    from esmdiff_tpu_torch.cli import analyze

    out.mkdir(parents=True)
    torch.cuda.synchronize()
    t0 = time.time()
    with open(out / "stdout.txt", "w") as f, contextlib.redirect_stdout(f):
        analyze.main([*argv, "--output", str(out), "--device", device])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    files = {}
    for path in sorted(out.glob("*.json")):
        files[path.name] = json.loads(path.read_text())
    for path in sorted(out.glob("*.csv")):
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        files[path.name] = [dict(zip(rows[0], r)) for r in rows[1:]]
    return files, seconds


def eval_finite(tree, where, none_ok=()):
    """Every number of an output tree finite; None only under ``none_ok``
    (the keys the JAX package leaves None by rule)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if v is None and k in none_ok:
                continue
            eval_finite(v, f"{where}.{k}", none_ok)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            eval_finite(v, f"{where}[{i}]", none_ok)
    elif tree is None or (isinstance(tree, float) and not math.isfinite(tree)):
        raise AssertionError(f"eval path: {where} is {tree}")


def eval_gap(card, cpu, where, worst, key=""):
    """Holds a card run's outputs against the CPU run's: JS values within
    1e-4 (their 4-decimal rounding), TM and validity exactly, every other
    number within 1e-9 relative; strings equal.  Records the largest
    difference of each kind in ``worst``."""
    if isinstance(card, dict):
        if list(card) != list(cpu):
            raise AssertionError(f"eval path {where}: keys {list(card)} "
                                 f"against {list(cpu)}")
        for k in card:
            eval_gap(card[k], cpu[k], f"{where}.{k}", worst, k)
        return
    if isinstance(card, list):
        if len(card) != len(cpu):
            raise AssertionError(f"eval path {where}: lengths differ")
        for i, (a, b) in enumerate(zip(card, cpu)):
            eval_gap(a, b, f"{where}[{i}]", worst, key)
        return
    try:
        a, b = float(card), float(cpu)
    except (TypeError, ValueError):
        if card != cpu:
            raise AssertionError(f"eval path {where}: {card} against {cpu}")
        return
    if key.startswith("js_"):
        kind, d, limit = "js_abs", abs(a - b), 1e-4 + 1e-12
    elif key.startswith(EVAL_EXACT):
        kind, d, limit = "exact_abs", abs(a - b), 0.0
    else:
        kind, d, limit = "rel", abs(a - b) / max(abs(b), 1e-12), 1e-9
    worst[kind] = max(worst.get(kind, 0.0), d)
    if not d <= limit:
        raise AssertionError(f"eval path {where}: card {a} against CPU {b} "
                             f"({kind} {d} > {limit})")


def tica_seconds(torch, frames, device):
    """Seconds of TICA's fit and projection (lag 500) on ``frames``' pairwise
    distances, formed beforehand on ``device``."""
    from esmdiff_tpu_torch.eval import metrics

    X = metrics.pairwise_distance_ca(frames, device=device)
    torch.cuda.synchronize()
    t0 = time.time()
    metrics.TICA(dim=2, lagtime=EVAL_LAGTIME).fit(X).transform(X)
    torch.cuda.synchronize()
    return time.time() - t0


def eval_path(torch, ops, card, ensembles):
    """The eval path (module docstring): esmdiff-torch-analyze bpti, apo and
    ped on the default path's ensembles, on the card, the card against the
    CPU, the native TM against its plain version.  ensembles: {key: the
    default path's 100-MODEL PDB}."""
    import numpy as np

    from esmdiff_tpu_torch.core.protein import load_ca_ensemble
    from esmdiff_tpu_torch.eval import geo, tmscore
    from esmdiff_tpu_torch.utils import native

    t_phase = time.time()
    work = ROOT / "output" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    (work / "clusters").mkdir(parents=True)
    shutil.copy(ROOT / TARGET / "bpti.pdb", work / "clusters" / "bpti.pdb")
    t0 = time.time()
    traj = stand_in_trajectory(EVAL_FRAMES)
    np.save(work / "traj.npy", traj)
    np.save(work / "traj_cut.npy", traj[:EVAL_CPU_FRAMES])
    make_s = time.time() - t0
    bpti_pdb, l128_pdb = ensembles["bpti"], ensembles[L128_TARGET.stem]
    bpti = ["bpti", "--preds", str(bpti_pdb), "--clusters",
            str(work / "clusters"), "--lagtime", str(EVAL_LAGTIME)]
    argv = {"bpti": [*bpti, "--target", str(work / "traj.npy")],
            "apo": ["apo", *apo_layout(work / "apo_inputs", l128_pdb)],
            "ped": ["ped", "--preds", str(bpti_pdb), str(l128_pdb),
                    "--targets", str(ROOT / "data" / "targets" / "ped")]}
    cut = [*bpti, "--target", str(work / "traj_cut.npy")]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for op in ops.values():
        op.launches = 0
    outputs, seconds = {}, {}
    for suite, args in argv.items():
        outputs[suite], seconds[suite] = analyze_run(
            torch, args, work / suite, "cuda")
    launches = {k: op.launches for k, op in ops.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(launches.values()):
        raise AssertionError(f"eval path: kernel launches {launches} (the "
                             "evaluation runs no model)")
    for suite, files in outputs.items():
        eval_finite(files, suite, none_ok=("tm_correlation",))
    apo = outputs["apo"]["apo_metrics.json"]["per_target"][0]
    if apo["gaps"] != [0, 4] or not apo["tm_pair"] > 0.9:
        raise AssertionError(f"eval path: the apo pair's registration: "
                             f"{apo}")

    # the card against the CPU: the same suites, the trajectory cut
    worst, gate_s = {}, {}
    for suite, args in {"bpti_cut": cut, "apo": argv["apo"],
                        "ped": argv["ped"]}.items():
        if suite == "bpti_cut":
            card_files, gate_s["bpti_cut_card"] = analyze_run(
                torch, args, work / "bpti_cut_card", "cuda")
        else:
            card_files = outputs[suite]
        cpu_files, gate_s[f"{suite}_cpu"] = analyze_run(
            torch, args, work / f"{suite}_cpu", "cpu")
        eval_gap(card_files, cpu_files, suite, worst)

    # TICA alone: the trajectory on the card, its cut on the card and CPU
    frames = load_ca_ensemble(work / "traj.npy")
    tica = {"card_s": tica_seconds(torch, frames, "cuda"),
            "card_cut_s": tica_seconds(torch, frames[:EVAL_CPU_FRAMES],
                                       "cuda"),
            "cpu_cut_s": tica_seconds(torch, frames[:EVAL_CPU_FRAMES],
                                      "cpu")}
    tica["cpu_over_card_cut"] = tica["cpu_cut_s"] / tica["card_cut_s"]

    # the native TM against its plain version on the BPTI pairs; printed,
    # how far the library's global RMSD lies above the optimal (SVD) fit's
    ens = load_ca_ensemble(bpti_pdb).astype(np.float64)
    ref = load_ca_ensemble(ROOT / TARGET / "bpti.pdb")[0].astype(np.float64)
    tms, rmsds = tmscore.tm_score_many(ens, ref)
    t0 = time.time()
    plain = np.array([tmscore._tm_score_np(e, ref) for e in ens])
    plain_s = time.time() - t0
    tm_gap = float(max(np.abs(tms - plain[:, 0]).max(),
                       np.abs(rmsds - plain[:, 1]).max()))
    if not tm_gap <= 1e-6:
        raise AssertionError(f"eval path: native TM against _tm_score_np: "
                             f"{tm_gap}")
    optimum = geo.rmsd_batched(torch.from_numpy(ens).cuda(),
                               torch.from_numpy(ref).cuda()).cpu().numpy()
    shutil.rmtree(work)
    scores = {"bpti": outputs["bpti"]["js_metrics.csv"],
              "bpti_clusters": outputs["bpti"]["bpti_tm_rmsd_div.json"],
              "apo": outputs["apo"]["apo_metrics.json"],
              "ped": outputs["ped"]["ped_metrics.json"]}
    return {"card": card, "frames": EVAL_FRAMES,
            "cut_frames": EVAL_CPU_FRAMES, "stand_in_s": make_s,
            "suite_s": seconds, "gate_s": gate_s, "tica": tica,
            "peak_memory_gib": peak,
            "native_build_s": dict(native.build_seconds),
            "card_vs_cpu_worst": worst, "native_vs_plain_tm_max": tm_gap,
            "tm_pairs_checked": len(ens), "plain_tm_s": plain_s,
            "native_rmsd_above_optimum_max": float((rmsds - optimum).max()),
            "native_rmsd_above_1e-6": int((rmsds - optimum > 1e-6).sum()),
            "launches": launches,
            "scores": scores, "phase_s": time.time() - t_phase}, launches


# the weights path: seeded reference-layout files at full width, written
# and read as a user's would be; the planted fault swaps these two trunk
# layers' tensors through key_overrides
WEIGHTS_DIR = ROOT / "output" / "chip_smoke_weights"
SWAPPED_LAYERS = (20, 21)
VERIFY_TOL = 1e-3
FD_BATCH = 64      # residue groups of the function decoder's check


def saved(torch, obj, path):
    """torch.save ``obj`` to ``path``: {file, gb, write_s}."""
    t0 = time.time()
    torch.save(obj, path)
    return {"file": path.name, "gb": path.stat().st_size / 1e9,
            "write_s": time.time() - t0}


def verified(torch, tv, path, component):
    """``esmdiff-torch-verify <path> --component <component>`` on the card
    (its own gate at VERIFY_TOL): {rows, worst_rel_diff, s}."""
    t0 = time.time()
    rows = tv.check([str(path), "--component", component, "--device",
                     "cuda", "--tol", str(VERIFY_TOL)])
    torch.cuda.synchronize()
    return {"rows": len(rows), "worst_rel_diff": max(r["rel_diff"]
                                                     for r in rows),
            "read_and_verify_s": time.time() - t0}


def held_differ(torch, module, sd, rules, skip=()):
    """Names of ``module``'s tensors that differ from the file's tensor
    (``sd[rules[name]]``) cast to the dtype the module holds."""
    return [name for name, t in module.state_dict().items()
            if name not in skip and not torch.equal(
                t, sd[rules[name]].to(device=t.device, dtype=t.dtype))]


@contextlib.contextmanager
def after_init(module, check):
    """Runs ``check(mdlm, cfg)`` right after each ``module.init_params``
    call (the trainer's init) while the block runs."""
    orig = module.init_params

    def wrapped(mdlm, cfg):
        orig(mdlm, cfg)
        check(mdlm, cfg)

    module.init_params = wrapped
    try:
        yield
    finally:
        module.init_params = orig


def weights_path(torch, ops, card, target_dirs, lws, default_targets,
                 corpus):
    """The weights path (module docstring): seeded reference-layout files
    at full width, esmdiff-torch-verify of each and a planted fault,
    load_runtime of the release, ddpm over --ckpt, gibbs over the stock
    file, model.pretrained_ckpt through the trainer on ``corpus``, the
    function decoder card against CPU, the runbook's --fixture chain.
    Returns (numbers, flash launches of the driven runs)."""
    import numpy as np

    from esmdiff_tpu_torch.api.generation import plan_batches
    from esmdiff_tpu_torch.cli import sample as cli
    from esmdiff_tpu_torch.convert import checkpoints
    from esmdiff_tpu_torch.convert import torch_ckpt as tc
    from esmdiff_tpu_torch.convert import verify as tv
    from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config
    from esmdiff_tpu_torch.models.function_decoder import (
        FunctionDecoderConfig, FunctionTokenDecoder)
    from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
    from esmdiff_tpu_torch.nn.layers import Dense
    from esmdiff_tpu_torch.tools import real_weight_day
    from esmdiff_tpu_torch.train import loop as train_loop
    from esmdiff_tpu_torch.train.config import load_config

    t_phase = time.time()
    fa = ops["flash_attention"]
    work = WEIGHTS_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    numbers = {"card": card}

    # (a) the files: an ESMDiff release (Lightning state_dict: net.* = the
    # structure-head trunk, sigma_embedder.*), the stock esm3_sm_open_v1
    # trunk (the same body, the six heads), ESM3's VQ encoder and decoder
    rel_cfg, stock_cfg = ESM3Config(head_type="structure"), ESM3Config()
    t0 = time.time()
    release_sd, stock_sd = tv.make_reference_trunk_state_dicts(
        [rel_cfg, stock_cfg])
    sigma_sd = tv.make_reference_sigma_embedder_state_dict(rel_cfg.d_model,
                                                           seed=1)
    enc_sd = tv.make_reference_encoder_state_dict(EncoderConfig())
    dec_sd = tv.make_reference_decoder_state_dict(DecoderConfig())
    files = {"release": work / "release_v0.ckpt",
             "stock": work / "esm3_sm_open_v1.pth",
             "vq_encoder": work / "esm3_structure_encoder_v0.pth",
             "vq_decoder": work / "esm3_structure_decoder_v0.pth"}
    written = {"generate_s": time.time() - t0}
    for key, obj in (("release", tv.release_checkpoint(release_sd, sigma_sd)),
                     ("stock", stock_sd), ("vq_encoder", enc_sd),
                     ("vq_decoder", dec_sd)):
        written[key] = saved(torch, obj, files[key])
    del enc_sd
    numbers["files"] = written
    print("[weights files] " + json.dumps(written), flush=True)

    # (b) esmdiff-torch-verify of each file on the card; the planted fault
    verify = {key: verified(torch, tv, files[key], comp) for key, comp in (
        ("release", "trunk"), ("stock", "trunk"),
        ("vq_encoder", "vqvae_encoder"), ("vq_decoder", "vqvae_decoder"))}
    swap = {}
    for name in tv._block_specs("L", 1, 1):
        a, b = (name.replace("L", f"transformer.blocks.{i}", 1)
                for i in SWAPPED_LAYERS)
        swap.update({a: b, b: a})
    t0 = time.time()
    rows = tv.verify_trunk(tc.load_torch_state_dict(str(files["release"])),
                           key_overrides=swap, device="cuda")
    hit = {f"block{i}" for i in SWAPPED_LAYERS}
    planted = {"layers": list(SWAPPED_LAYERS),
               "hit_rel_diff": {r["layer"]: r["rel_diff"] for r in rows
                                if r["layer"] in hit},
               "others_worst": max(r["rel_diff"] for r in rows
                                   if r["layer"] not in hit),
               "s": time.time() - t0}
    verify["planted_swap"] = planted
    numbers["verify"] = verify
    print("[weights verify] " + json.dumps(verify), flush=True)
    if not (min(planted["hit_rel_diff"].values()) > VERIFY_TOL
            >= planted["others_worst"]) or len(planted["hit_rel_diff"]) != 2:
        raise AssertionError(f"the planted layer swap does not read above "
                             f"{VERIFY_TOL} at exactly its layers: {planted}")
    torch.cuda.empty_cache()

    # (c) the VQ pair converted, load_runtime of the release with it
    t0 = time.time()
    vq_dir = checkpoints.vqvae_from_reference(
        files["vq_encoder"], files["vq_decoder"], work / "vqvae")
    convert_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rt = checkpoints.load_runtime(files["release"], vqvae_ckpt=str(vq_dir),
                                  device="cuda")
    torch.cuda.synchronize()
    load_s = time.time() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    rules = tc.trunk_rules(rel_cfg.n_layers, rel_cfg.n_layers_geom,
                           "structure")
    differ = held_differ(torch, rt.trunk, release_sd, rules)
    differ += held_differ(
        torch, rt.sigma_embedder,
        {tc.SIGMA_PREFIX + k: v for k, v in sigma_sd.items()},
        {k: tc.SIGMA_PREFIX + v for k, v in tc.sigma_embedder_rules().items()})
    differ += held_differ(torch, rt.decoder, dec_sd,
                          tc.vqvae_decoder_rules(rt.decoder.cfg.n_layers),
                          skip=tc.NO_SOURCE["vqvae_decoder"])
    del dec_sd
    if differ:
        raise AssertionError(f"load_runtime's tensors differ from the "
                             f"file's: {differ[:8]}")
    kernel = trunk_logits(torch, rt, {})
    rel, floor = kernel_vs_plain(
        torch, rt, {}, {(fa, "flash_attention"): fa.flash_attention_reference},
        {(fa, "flash_attention"): plain_attention_with_lengths})
    seq = rt.seq_tokenizer.encode(target_sequence(ROOT / TARGET))
    with torch.no_grad():
        oracle = tv.oracle_trunk_logits(
            release_sd, rel_cfg,
            torch.as_tensor(seq[None], dtype=torch.long, device="cuda"))[0]
    rel_oracle = ((kernel - oracle).norm() / oracle.norm()).item()
    del oracle
    runtime_numbers = {
        "vqvae_from_reference_s": convert_s, "load_s": load_s,
        "load_peak_gib": load_peak, "trunk_head_type":
            rt.trunk.cfg.head_type, "held_dtype": str(
                rt.trunk.transformer.blocks[1].attn.qkv.weight.dtype),
        "tensors_equal_file": len(rt.trunk.state_dict())
        + len(rt.sigma_embedder.state_dict()) + len(rt.decoder.state_dict())
        - len(tc.NO_SOURCE["vqvae_decoder"]),
        "trunk_logits_rel_l2_kernel_vs_oracle_fp32": rel_oracle,
        "trunk_logits_rel_l2_kernel_vs_plain": rel,
        "trunk_logits_rel_l2_plain_roundings": floor}
    numbers["runtime"] = runtime_numbers
    print("[weights runtime] " + json.dumps(runtime_numbers), flush=True)
    if not rel_oracle <= 2 * floor:
        raise AssertionError(f"converted trunk logits, kernel path (bf16) vs "
                             f"the oracle's float32 forward of the file: "
                             f"relative L2 {rel_oracle}, more than twice the "
                             f"two plain roundings' {floor}")

    # (d) ddpm over --ckpt --vqvae_ckpt, as the CLI ships it: one request
    # through the flags (the CLI loads the files), then each target timed
    # on the runtime the CLI's build_runtime gives for the same flags
    ckpt_flags = ["--ckpt", str(files["release"]), "--vqvae_ckpt",
                  str(vq_dir)]
    t0 = time.time()
    cli.main(["--input", str(ROOT / TARGET), "--output",
              str(work / "ddpm_flags"), "--mode", "ddpm", "--num_steps", "1",
              "--num_samples", "8", *ckpt_flags])
    flags_s = time.time() - t0
    dec_layers = rt.decoder.cfg.n_layers
    driven = drive(
        torch, rt, ops, "weights path, ddpm --ckpt",
        {key: (d, path_launches(rt.trunk.cfg, dec_layers, lws[key], False))
         for key, d in target_dirs.items()},
        work / "ddpm")
    ddpm = {"flags_request_s": flags_s}
    for key, n in driven.items():
        r = n["report"]
        plan = plan_batches(lws[key], NUM_SAMPLES, policy="single")
        ddpm[key] = {
            "L": r["L"], "batches": plan, "total_s": r["total_sec"],
            "conformations_per_s": NUM_SAMPLES / r["total_sec"],
            "ms_per_step": 1e3 * r["sampling_sec"]
            / (len(plan) * (NUM_STEPS + 1)),
            "default_path_conformations_per_s":
                default_targets[key]["conformations_per_s"],
            "default_path_ms_per_step": default_targets[key]["ms_per_step"],
            "peak_memory_gib": n["peak_memory_gib"],
            "launches": n["launches"]["flash_attention"]}
    numbers["ddpm"] = ddpm
    print("[weights ddpm] " + json.dumps(ddpm), flush=True)
    launches = sum(n["launches"]["flash_attention"] for n in driven.values())
    del rt, kernel
    torch.cuda.empty_cache()

    # (e) gibbs over the stock file: the head type read from it
    args = cli.get_argparser().parse_args(
        ["--ckpt", str(files["stock"]), "--vqvae_ckpt", str(vq_dir),
         "--mode", "gibbs"])
    t0 = time.time()
    stock_rt = cli.build_runtime(args)
    torch.cuda.synchronize()
    stock_load_s = time.time() - t0
    if stock_rt.trunk.cfg.head_type != "esm3":
        raise AssertionError(f"the stock file loaded with head type "
                             f"{stock_rt.trunk.cfg.head_type}")
    differ = held_differ(torch, stock_rt.trunk, stock_sd, tc.trunk_rules(
        stock_cfg.n_layers, stock_cfg.n_layers_geom, "esm3"))
    if differ:
        raise AssertionError(f"stock runtime's tensors differ from the "
                             f"file's: {differ[:8]}")
    del stock_sd
    n_plan = len(plan_batches(lws["bpti"], NUM_SAMPLES, policy="single"))
    g = drive(torch, stock_rt, ops, "weights path, gibbs --ckpt",
              {"bpti": (target_dirs["bpti"], path_launches(
                  stock_rt.trunk.cfg, dec_layers, lws["bpti"], False,
                  [GIBBS_STEPS] * n_plan))},
              work / "gibbs", mode="gibbs", num_steps=GIBBS_STEPS)["bpti"]
    r = g["report"]
    gibbs = {"load_s": stock_load_s, "L": r["L"], "total_s": r["total_sec"],
             "conformations_per_s": NUM_SAMPLES / r["total_sec"],
             "ms_per_step": 1e3 * r["sampling_sec"] / (n_plan * GIBBS_STEPS),
             "peak_memory_gib": g["peak_memory_gib"],
             "launches": g["launches"]["flash_attention"]}
    numbers["gibbs"] = gibbs
    print("[weights gibbs] " + json.dumps(gibbs), flush=True)
    launches += gibbs["launches"]
    del stock_rt
    torch.cuda.empty_cache()

    # (f) model.pretrained_ckpt: three unpacked steps of configs/mdlm.yaml
    # at full width from the release, on the train path's corpus
    cfg = load_config(str(ROOT / "configs/mdlm.yaml"))
    with torch.device("meta"):
        n_dense = sum(m.weight.numel() for m in
                      ESM3(train_loop.trunk_config(cfg)).modules()
                      if isinstance(m, Dense))
    init_equal = []

    def trunk_is_file(mdlm, _cfg):
        init_equal.append(not held_differ(torch, mdlm.net, release_sd, rules))

    with after_init(train_loop, trunk_is_file):
        tuned, steps, evals, fails = train_run(
            torch, fa, [f"data.path={corpus}", "data.pack_len=0",
                        "trainer.max_epochs=1", "trainer.limit_batches=0.2",
                        "trainer.log_every_n_steps=1",
                        f"model.pretrained_ckpt={files['release']}"],
            work / "finetune", n_dense)
    want = 2 * rel_cfg.n_layers - rel_cfg.n_layers_geom
    tuned["trunk_equals_file_after_init"] = init_equal == [True]
    tuned["flash_per_step_want"] = want
    numbers["finetune"] = tuned
    print("[weights finetune] " + json.dumps(tuned), flush=True)
    if fails or init_equal != [True] or len(steps) != 3 or \
            tuned["flash_per_train_step"] != [want]:
        raise AssertionError(f"model.pretrained_ckpt fine-tune: {fails}, "
                             f"trunk equal after init {init_equal}, "
                             f"{len(steps)} steps, flash a step "
                             f"{tuned['flash_per_train_step']} (want {want})")
    launches += sum(r["flash"] for r in steps + evals)
    shutil.rmtree(work / "finetune")
    del release_sd, sigma_sd
    torch.cuda.empty_cache()

    # (g) the function decoder at its default geometry: the card against
    # the CPU in float32, both converted from one fixture
    fcfg = FunctionDecoderConfig()
    fsd = tv.make_reference_function_decoder_state_dict(fcfg)
    outs = {}
    toks = torch.as_tensor(np.random.RandomState(0).randint(
        0, fcfg.function_token_vocab, (FD_BATCH, fcfg.function_token_depth)))
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            fd = FunctionTokenDecoder(fcfg).eval()
        tc.convert_function_decoder(fd, fsd)
        with torch.no_grad():
            outs[dev] = {k: v.cpu() for k, v in fd(toks.to(dev)).items()}
    fd_rel = {k: ((outs["cuda"][k] - outs["cpu"][k]).abs().max()
                  / outs["cpu"][k].abs().max()).item() for k in outs["cpu"]}
    fd_numbers = {"params": sum(t.numel() for t in fsd.values()),
                  "rel_max_card_vs_cpu": fd_rel,
                  "verify_worst_rel_diff": max(r["rel_diff"] for r in
                                               tv.verify_function_decoder(
                                                   fsd, fcfg, device="cuda"))}
    numbers["function_decoder"] = fd_numbers
    print("[weights function decoder] " + json.dumps(fd_numbers), flush=True)
    if max(fd_rel.values()) > 1e-5 or \
            fd_numbers["verify_worst_rel_diff"] > VERIFY_TOL:
        raise AssertionError(f"function decoder card vs CPU: {fd_numbers}")
    del fsd, outs

    # (h) the runbook's --fixture chain at tiny width (on the CPU: the tiny
    # trunk's Dh 16 is no flash shape)
    t0 = time.time()
    rwd = real_weight_day.main(["--fixture", "--device", "cpu", "--workdir",
                                str(work / "real_weight_day")])
    numbers["real_weight_day"] = {
        "s": time.time() - t0, "verify": rwd["verify"],
        "quant_argmax_agree_min": min(r["argmax_agree"]
                                      for r in rwd["quant_parity"])}
    shutil.rmtree(work)  # the corpus stays for the pipeline path
    numbers["launches"] = {"flash_attention": launches}
    numbers["phase_s"] = time.time() - t_phase
    return numbers, launches


# -- the pipeline path ---------------------------------------------------------

PIPELINE_DIR = ROOT / "output" / "chip_smoke_pipeline"
# what the pipeline path drives: the configs (the repo's), the device, the
# JLM's batch (16 does not fit: its plain attention keeps ~6 bytes of
# scores and probabilities a (head, query, key) for backward, ~77 GB at
# 16 rows of 1025 positions over 48 layers), the switch runs' steps, the
# chains dumped with embeddings (every second one: the whole corpus took
# ~100 s of the script's 1200 on an H100 80GB HBM3 at 700 W), the sweep's
# corpus, the preprocess workers, the AR samples
PIPELINE = {"configs": {"clm": "configs/clm.yaml", "jlm": "configs/jlm.yaml",
                        "mdlm": "configs/mdlm.yaml"},
            "device": "cuda", "jlm_batch": 8, "switch_steps": 6,
            "embed_every": 2,
            "sweep_chains": 32, "workers": 8, "ar_samples": 32}
CIF_TARGETS = ("apo", "codnas", "ped")
LOW_RES_EVERY = 47     # every 47th chain written at 6 A: resolution-filtered
POSITION_TOL = 5e-4    # A: the files' 3 decimals
GATE_ROWS = 2          # rows of the AR gate's batch (a float32 JLM forward)


def proteins_to_mmcif(chain_items, entry_id, resolution=1.8,
                      oligomeric="monomeric") -> str:
    """A minimal mmCIF of ``chain_items`` [(chain id, Protein)]: header
    (id, resolution, method, oligomeric details) and the atom_site loop,
    3 decimals, as tests/test_mmcif.py writes its fixtures."""
    from esmdiff_tpu_torch.core import residue_constants as rc

    lines = [f"data_{entry_id}", f"_entry.id {entry_id}",
             f"_refine.ls_d_res_high {resolution}",
             "_exptl.method 'X-RAY DIFFRACTION'", "#",
             f"_pdbx_struct_assembly.oligomeric_details {oligomeric}", "#",
             "loop_"]
    lines += [f"_atom_site.{c}" for c in (
        "group_PDB", "id", "label_atom_id", "label_alt_id", "label_comp_id",
        "auth_asym_id", "auth_seq_id", "pdbx_PDB_ins_code", "Cartn_x",
        "Cartn_y", "Cartn_z", "B_iso_or_equiv", "pdbx_PDB_model_num")]
    rts3 = [rc.restype_1to3[r] for r in rc.restypes] + ["UNK"]
    serial = 1
    for chain_id, prot in chain_items:
        for i in range(len(prot.aatype)):
            res3 = rts3[min(int(prot.aatype[i]), rc.restype_num)]
            for ai, name in enumerate(rc.atom_types):
                if prot.atom_mask[i, ai] < 0.5:
                    continue
                x, y, z = prot.atom_positions[i, ai]
                lines.append(
                    f"ATOM {serial} {name} . {res3} {chain_id} "
                    f"{int(prot.residue_index[i])} ? {x:.3f} {y:.3f} {z:.3f} "
                    f"{float(prot.b_factors[i, ai]):.2f} 1")
                serial += 1
    lines.append("#")
    return "\n".join(lines) + "\n"


def write_cif_corpus(work):
    """Every chain under data/targets/{apo,codnas,ped} as one mmCIF file
    (a third gzipped, every LOW_RES_EVERY-th at 6 A), a file that does
    not parse, and three two-chain complexes (consecutive chains, the
    second renumbered after the first).  Returns ({entry: (its PDB file,
    the parsed chain)}, the chain and complex directories)."""
    import gzip

    from esmdiff_tpu_torch.core import protein as protein_io

    chains, complexes = work / "cif", work / "cif_complex"
    chains.mkdir(parents=True)
    complexes.mkdir()
    pdbs = [f for d in CIF_TARGETS
            for f in sorted((ROOT / "data/targets" / d).glob("*.pdb"))]
    entries, prots = {}, []
    for i, pdb in enumerate(pdbs):
        prot = protein_io.from_pdb_file(pdb)
        prot = prot[0] if isinstance(prot, list) else prot
        prots.append(prot)
        entry = pdb.stem.replace(".", "_")
        entries[entry] = pdb, prot
        text = proteins_to_mmcif(
            [("A", prot)], entry,
            resolution=6.0 if i % LOW_RES_EVERY == LOW_RES_EVERY - 1 else 1.8)
        if i % 3 == 0:
            with gzip.open(chains / f"{entry}.cif.gz", "wt") as f:
                f.write(text)
        else:
            (chains / f"{entry}.cif").write_text(text)
    (chains / "broken.cif").write_text("data_broken\n#\n")
    for k in range(3):
        a, b = prots[2 * k], prots[2 * k + 1]
        b = dataclasses.replace(
            b, residue_index=b.residue_index - b.residue_index.min()
            + a.residue_index.max() + 10)
        (complexes / f"complex{k}.cif").write_text(
            proteins_to_mmcif([("A", a), ("B", b)], f"complex{k}"))
    return entries, chains, complexes


def pipeline_mmcif(torch, fa, work, failures):
    """(a): the mmCIF corpus through esmdiff-torch-preprocess --with_dssp
    (chain mode over the chains, complex mode over the complexes); the
    DSSP on the device against the CPU, the .npz positions against the
    PDB parser's.  Returns (numbers, {npz stem: its PDB file})."""
    import numpy as np

    from esmdiff_tpu_torch.cli import preprocess
    from esmdiff_tpu_torch.core import protein as protein_io
    from esmdiff_tpu_torch.core.secondary_structure import \
        assign_secondary_structure_batch

    t0 = time.time()
    entries, chains, complexes = write_cif_corpus(work)
    write_s = time.time() - t0
    out = {}
    # the three complexes in this process: a pool would start 8 workers
    # for 3 files
    for mode, src, workers in (("chain", chains, PIPELINE["workers"]),
                               ("complex", complexes, 1)):
        dssp = []
        t0 = time.time()
        with calls(torch, preprocess, "add_dssp", fa, dssp):
            rep = preprocess.main([
                str(src), str(work / f"npz_{mode}"), "--mode", mode,
                "--with_dssp", "--num_workers", str(workers),
                "--device", PIPELINE["device"]])
        s = time.time() - t0
        dssp_s = sum(r["s"] for r in dssp)
        statuses = {}
        for r in rep["rows"]:
            kind = r["status"].split(" ")[0].split(":")[0]
            statuses[kind] = statuses.get(kind, 0) + 1
        out[mode] = {"files": rep["files"], "s": s, "dssp_s": dssp_s,
                     "dssp_share": dssp_s / s, "statuses": statuses,
                     "rows": [r for r in rep["rows"] if r["status"] == "ok"]}
    rows = out["chain"]["rows"] + out["complex"]["rows"]
    # the DSSP strings the card wrote against the CPU's, every chain
    prots, d_max, stems = [], 0.0, {}
    for mode in out:
        for r in out[mode]["rows"]:
            with np.load(work / f"npz_{mode}" / f"{r['file']}.npz") as z:
                prots.append(protein_io.Protein(
                    z["atom_positions"], z["atom_mask"], z["aatype"],
                    z["residue_index"], np.zeros_like(z["atom_mask"])))
                if mode == "chain":
                    pdb, ref = entries[r["pdb_name"]]
                    stems[r["file"]] = pdb
                    if not np.array_equal(ref.atom_mask, z["atom_mask"]):
                        failures.append(f"mmcif {r['file']}: atom mask")
                    m = ref.atom_mask > 0.5
                    d_max = max(d_max, float(np.abs(
                        ref.atom_positions[m] - z["atom_positions"][m]).max()))
    t0 = time.time()
    cpu = assign_secondary_structure_batch(prots, "cpu")
    cpu_s = time.time() - t0
    differ = [r["file"] for r, s in zip(rows, cpu)
              if r["secondary_structure"] != s]
    n_low = sum(1 for i in range(len(entries))
                if i % LOW_RES_EVERY == LOW_RES_EVERY - 1)
    numbers = {
        "cif_files": out["chain"]["files"], "complex_files":
            out["complex"]["files"], "write_s": write_s,
        **{mode: {k: v for k, v in o.items() if k != "rows"}
           for mode, o in out.items()},
        "dssp_cpu_s": cpu_s, "dssp_chains": len(prots),
        "dssp_card_vs_cpu_differ": differ,
        "helix_strand_coil": [sum(r[f"frac_{k}"] * r["length"] for r in rows)
                              for k in ("helix", "sheet", "coil")],
        "npz_vs_pdb_max_abs_d": d_max}
    want = {"ok": len(entries) - n_low, "resolution_filtered": n_low,
            "parse_error": 1}
    if out["chain"]["statuses"] != want or \
            out["complex"]["statuses"] != {"ok": 3}:
        failures.append(f"preprocess statuses {out['chain']['statuses']} "
                        f"(want {want}), complex "
                        f"{out['complex']['statuses']}")
    if differ or d_max > POSITION_TOL:
        failures.append(f"mmcif: DSSP card vs CPU differ on {differ[:8]}, "
                        f"positions {d_max} A")
    return numbers, stems


def pipeline_dump(torch, fa, runtime, work, stems, failures):
    """(b): esmdiff-torch-dump --with_embeddings over every
    PIPELINE["embed_every"]-th preprocessed chain, its tokens against a
    dump of the same chains' PDB files, the trunk's flash launches (a layer
    a chain), the seconds of the trunk forwards and of the .npz writes."""
    import numpy as np

    from esmdiff_tpu_torch.cli import dump as dump_cli

    npz, pdbs = work / "npz_embed", work / "pdb_links"
    npz.mkdir()
    pdbs.mkdir()
    stems = dict(list(sorted(stems.items()))[::PIPELINE["embed_every"]])
    for stem, pdb in stems.items():
        (npz / f"{stem}.npz").symlink_to(work / "npz_chain" / f"{stem}.npz")
        (pdbs / f"{stem}.pdb").symlink_to(pdb)
    dump = work / "dump"
    fa.launches = 0
    forwards, writes = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    with calls(torch, runtime.trunk, "forward", fa, forwards), \
            calls(torch, np, "savez_compressed", fa, writes):
        n = dump_cli.main([str(npz), str(dump), "--with_embeddings"],
                          runtime=runtime)
    torch.cuda.synchronize()
    s = time.time() - t0
    flash = fa.launches
    t0 = time.time()
    dump_cli.main([str(pdbs), str(work / "dump_pdb")], runtime=runtime)
    ref_s = time.time() - t0
    differ, emb_bytes, lengths = [], 0, []
    for stem in stems:
        with np.load(dump / f"{stem}.npz") as z, \
                np.load(work / "dump_pdb" / f"{stem}.npz") as r:
            emb_bytes += z["embeddings"].nbytes
            lengths.append(len(z["structure_tokens"]) - 2)
            if not (np.array_equal(z["structure_tokens"],
                                   r["structure_tokens"])
                    and np.array_equal(z["sequence_tokens"],
                                       r["sequence_tokens"])):
                differ.append(stem)
    layers = runtime.trunk.cfg.n_layers
    want = n * layers if PIPELINE["device"] == "cuda" else 0
    numbers = {"chains": n, "of_chains": len(list(
                   (work / "npz_chain").glob("*.npz"))), "s": s,
               "trunk_forward_s": sum(r["s"] for r in forwards),
               "npz_write_s": sum(r["s"] for r in writes),
               "pdb_dump_s": ref_s,
               "embeddings_gib": emb_bytes / 2**30, "residues": sum(lengths),
               "max_L": max(lengths), "tokens_differ_from_pdb_dump": differ,
               "flash_launches": flash, "flash_launches_want": want}
    if n != len(stems) or differ or flash != want:
        failures.append(f"dump: {n} of {len(stems)} chains, tokens differ "
                        f"on {differ[:8]}, flash {flash} (want {want})")
    return numbers, dump, flash


def ar_train_gate(torch, task, cfg, corpus, emb_dim):
    """The first GATE_ROWS rows of one fixed batch, a fresh seeded net: the
    loss and gradient norm of
    the config's dtype (the trainer's), of the same net with every Dense
    product a float32 product of its bf16 operands (another rounding), and
    of the float32 net (the unrounded forward)."""
    from esmdiff_tpu_torch.nn.layers import Dense
    from esmdiff_tpu_torch.train import data as data_mod
    from esmdiff_tpu_torch.train import loop as train_loop

    dev = PIPELINE["device"]
    split, _ = data_mod.train_val_split(
        data_mod.EncodingDataset(cfg.data), cfg.data)
    batch = train_loop.to_device({k: v[:GATE_ROWS] for k, v in next(
        data_mod.batches(split, cfg.data, shuffle=True,
                         seed=cfg.seed)).items()}, dev)
    model, loss_fn = train_loop.build_task(cfg, dev, emb_dim=emb_dim)
    train_loop.init_task(model, cfg)
    f32_cfg = dataclasses.replace(cfg)
    f32_cfg.model = dataclasses.replace(cfg.model)
    setattr(f32_cfg.model, task, dataclasses.replace(
        getattr(cfg.model, task), dtype="float32"))
    f32, f32_loss = train_loop.build_task(f32_cfg, dev, emb_dim=emb_dim)
    f32.load_state_dict(model.state_dict())

    def run(net, fn):
        net.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, _ = fn(batch)
            loss.backward()
        grads = [p.grad.float() for p in net.parameters()
                 if p.grad is not None]
        return loss.item(), torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])).item()

    out = {"config": run(model, loss_fn), "float32": run(f32, f32_loss)}
    orig = Dense.forward
    Dense.forward = float32_product
    try:
        out["float32_products"] = run(model, loss_fn)
    finally:
        Dense.forward = orig
    del model, f32
    ref = out["float32"]
    gate = {"batch_shape": list(batch["mask"].shape), **{
        k: {"loss": v[0], "grad_norm": v[1]} for k, v in out.items()}}
    for i, name in enumerate(("loss", "grad_norm")):
        gate[f"{name}_rel_config"] = abs(out["config"][i] - ref[i]) / ref[i]
        gate[f"{name}_rel_floor"] = \
            abs(out["float32_products"][i] - ref[i]) / ref[i]
    return gate


def pipeline_ar_train(torch, fa, dump, card, failures):
    """(c): configs/clm.yaml and configs/jlm.yaml at full width, one epoch
    each on the dump (the JLM at PIPELINE["jlm_batch"]); the gate on one
    fixed batch.  Returns (numbers, {task: best step directory})."""
    import numpy as np

    from esmdiff_tpu_torch.cli import train as train_cli
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.config import load_config
    from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager

    with np.load(next(dump.glob("*.npz"))) as z:
        emb_dim = int(z["embeddings"].shape[-1])
    numbers, best = {}, {}
    for task in ("clm", "jlm"):
        run = PIPELINE_DIR / f"{task}_run"
        overrides = [f"data.path={dump}", "trainer.max_epochs=1",
                     "trainer.log_every_n_steps=1",
                     f"trainer.ckpt_dir={run}", "trainer.print_config=false"]
        if task == "jlm":
            overrides.append(f"data.batch_size={PIPELINE['jlm_batch']}")
        steps, evals, saves = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with stepped(torch, tstate, "train_step", fa, steps), \
                stepped(torch, tstate, "eval_step", fa, evals), \
                timed_saves(torch, CheckpointManager, saves):
            result = train_cli.main([
                "--config", str(ROOT / PIPELINE["configs"][task]),
                "--device", PIPELINE["device"], *overrides])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        warm = steps[1:]
        warm_s = sum(r["ms"] for r in warm) / 1e3
        losses = [r["loss"] for r in steps]
        q = max(1, len(losses) // 4)
        cfg = load_config(str(ROOT / PIPELINE["configs"][task]), overrides)
        gc.collect()
        torch.cuda.empty_cache()
        gate = ar_train_gate(torch, task, cfg, str(dump), emb_dim)
        numbers[task] = {
            "overrides": overrides, "steps": result["steps"], "wall_s": wall,
            "batch_shapes": sorted({tuple(r["shape"]) for r in steps}),
            "first_step_ms": steps[0]["ms"],
            "warm_ms_per_step": 1e3 * warm_s / max(1, len(warm)),
            "real_tokens_per_s": sum(r["real_tokens"] for r in warm)
            / warm_s,
            "padded_tokens_per_s": sum(r["padded_tokens"] for r in warm)
            / warm_s,
            "peak_gib": peak, "losses": losses,
            "grad_norms": [r["grad_norm"] for r in steps],
            "first_quarter_loss": float(np.mean(losses[:q])),
            "last_quarter_loss": float(np.mean(losses[-q:])),
            "val_loss": result["best_val_loss"], "saves": saves,
            "flash": sum(r["flash"] for r in steps + evals), "gate": gate}
        print(f"[pipeline {task} train] " + json.dumps(numbers[task]),
              flush=True)
        finite = [*losses, *numbers[task]["grad_norms"],
                  result["best_val_loss"]]
        if not all(math.isfinite(x) for x in finite) or len(steps) < 4 or \
                not numbers[task]["last_quarter_loss"] \
                < numbers[task]["first_quarter_loss"] or len(saves) != 1:
            failures.append(f"{task} training: finite {finite}, "
                            f"{len(steps)} steps, {len(saves)} saves")
        if numbers[task]["flash"]:
            failures.append(f"{task} training launched flash")
        for name in ("loss", "grad_norm"):
            if not gate[f"{name}_rel_config"] <= \
                    2 * gate[f"{name}_rel_floor"] + 1e-7:
                failures.append(f"{task} gate: {name} {gate}")
        best[task] = Path(json.loads(
            (run / "ckpt" / "index.json").read_text())[0]["path"])
        torch.cuda.empty_cache()
    return numbers, best


def pipeline_ar_sample(torch, fa, runtime, best, failures):
    """(d): esmdiff-torch-sample-ar --config configs/{clm,jlm}.yaml --ckpt
    <best step dir> on BPTI x PIPELINE["ar_samples"] (the runtime's trunk
    gives the embeddings, its decoder the structures): the net holds the
    run's tensors, finite PDBs, no special token; esmdiff-torch-analyze ped
    on the ensemble."""
    from esmdiff_tpu_torch.cli import analyze as analyze_cli
    from esmdiff_tpu_torch.cli import sample_ar
    from esmdiff_tpu_torch.convert import checkpoints
    from esmdiff_tpu_torch.utils.checkpoint import load_params

    n = PIPELINE["ar_samples"]
    numbers, flash = {}, 0
    for task, step_dir in best.items():
        out = PIPELINE_DIR / f"{task}_samples"
        saved = load_params(step_dir)
        equal = []
        orig = checkpoints.load_ar_params

        def load(path, model, orig=orig, saved=saved, equal=equal):
            model = orig(path, model)
            own = model.state_dict()
            equal.append(own.keys() == saved.keys() and all(
                torch.equal(own[k].cpu(), v) for k, v in saved.items()))
            return model

        checkpoints.load_ar_params = load
        before = fa.launches
        try:
            with recorded(sample_ar, f"{task}_generate") as batches:
                (report,) = sample_ar.main([
                    "--config", str(ROOT / PIPELINE["configs"][task]),
                    "--ckpt", str(step_dir), "--input", str(ROOT / TARGET),
                    "--output", str(out), "--n_samples", str(n),
                    "--seed", "0", "--device", PIPELINE["device"]],
                    runtime=runtime)
        finally:
            checkpoints.load_ar_params = orig
        launched = fa.launches - before
        flash += launched
        pdb = out / f"{report['target']}.pdb"
        check_pdb(pdb.read_text(), n, n * (report["L"] * 4 - 1), str(pdb))
        specials = sum(int((b >= 4096).sum()) for b in batches)
        t0 = time.time()
        analyze_cli.main(["ped", "--preds", str(pdb), "--targets",
                          str(ROOT / TARGET), "--output",
                          str(out / "ped"), "--device", PIPELINE["device"]])
        ped = json.loads((out / "ped" / "ped_metrics.json").read_text())
        ped.pop("name")
        values = [v for vs in ped.values() for v in vs]
        numbers[task] = {
            "L": report["L"], "n_samples": n, "total_s": report["total_sec"],
            "conformations_per_s": n / report["total_sec"],
            "tensors_equal_run": equal == [True], "specials": specials,
            "flash_launches": launched, "ped_s": time.time() - t0,
            "ped": ped}
        if equal != [True] or specials or not all(
                v is not None and math.isfinite(v) for v in values):
            failures.append(f"{task} sample: {numbers[task]}")
        shutil.rmtree(out)
    return numbers, flash


def switch_run(torch, fa, corpus, overrides, steps_n, want):
    """``steps_n`` unpacked steps of configs/mdlm.yaml with ``overrides``
    through the trainer's build, init and train step: ms a step (warm),
    peak GiB, flash launches a step; returns (numbers, the state, the loss
    function, the next batch)."""
    from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
    from esmdiff_tpu_torch.train import data as data_mod
    from esmdiff_tpu_torch.train import loop as train_loop
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.config import load_config

    dev = PIPELINE["device"]
    cfg = load_config(str(ROOT / PIPELINE["configs"]["mdlm"]),
                      [f"data.path={corpus}", "data.pack_len=0",
                       *overrides])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, loss_fn = train_loop.build_task(cfg, dev)
    train_loop.init_task(model, cfg)
    modules = train_loop.task_modules(model)
    state = tstate.create_train_state(modules, tstate.make_optimizer(
        modules.parameters(), lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay))
    split, _ = data_mod.train_val_split(
        data_mod.EncodingDataset(cfg.data), cfg.data)
    batches = data_mod.batches(split, cfg.data, shuffle=True, seed=cfg.seed)
    draws = GeneratorDraws(dev, seed=cfg.seed)
    records = []
    for _ in range(steps_n):
        batch = train_loop.to_device(next(batches), dev)
        torch.cuda.synchronize()
        before, t0 = fa.launches, time.perf_counter()
        m = tstate.train_step(state, loss_fn, batch, draws)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        records.append({"ms": 1e3 * (time.perf_counter() - t0),
                        "flash": fa.launches - before, "loss": loss,
                        "shape": list(batch["mask"].shape)})
    warm = records[1:]
    numbers = {"overrides": overrides, "steps": len(records),
               "first_step_ms": records[0]["ms"],
               "warm_ms_per_step": sum(r["ms"] for r in warm) / len(warm),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "losses": [r["loss"] for r in records],
               "batch_shapes": [r["shape"] for r in records],
               "flash_per_step": sorted({r["flash"] for r in records}),
               "flash_per_step_want": want,
               "flash": sum(r["flash"] for r in records),
               "param_dtypes": sorted({str(p.dtype).replace("torch.", "")
                                       for p in modules.parameters()})}
    return numbers, state, loss_fn, next(batches)


def pipeline_switches(torch, fa, corpus, train_numbers, failures):
    """(e): 6 unpacked steps of configs/mdlm.yaml on the train path's
    corpus under model.remat_policy=dots and under
    model.param_dtype=bfloat16; one batch's gradient under "dots" against
    "nothing" on the same weights and draws, gated by the train path's
    two plain roundings (its [train gate] plain version vs xla)."""
    from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
    from esmdiff_tpu_torch.models.esm3 import ESM3Config, remat_kwargs
    from esmdiff_tpu_torch.train import loop as train_loop

    tcfg = ESM3Config()
    want = (2 * tcfg.n_layers - tcfg.n_layers_geom
            if PIPELINE["device"] == "cuda" else 0)
    numbers, flash = {}, 0
    dots, state, loss_fn, batch = switch_run(
        torch, fa, corpus, ["model.remat_policy=dots"],
        PIPELINE["switch_steps"], want)
    flash += dots["flash"]
    # one batch, the same weights and draws, under both policies
    batch = train_loop.to_device(batch, PIPELINE["device"])
    stack = state.model["net"].transformer
    grads = {}
    for policy in ("nothing", "dots"):
        stack.remat_kwargs = remat_kwargs(policy)
        state.model.zero_grad(set_to_none=True)
        before = fa.launches
        with torch.enable_grad():
            loss, _ = loss_fn(batch, GeneratorDraws(PIPELINE["device"],
                                                    seed=0))
            loss.backward()
        flash += fa.launches - before
        grads[policy] = {n: p.grad.clone() if policy == "nothing"
                         else p.grad for n, p in
                         state.model.named_parameters() if p.grad is not None}
    diff2 = norm2 = 0.0
    worst = 0.0
    for n, g in grads["nothing"].items():
        d = (grads["dots"][n] - g).float()
        diff2 += d.norm().item() ** 2
        norm2 += g.float().norm().item() ** 2
        worst = max(worst, (d.norm() / g.float().norm().clamp_min(1e-30))
                    .item())
    floor = train_numbers["gate"]["plain_version"]["grad_rel_l2"]
    dots["grad_rel_l2_dots_vs_nothing"] = math.sqrt(diff2 / norm2)
    dots["grad_max_leaf_rel_l2_dots_vs_nothing"] = worst
    dots["grad_rel_l2_floor"] = floor
    del grads, state, loss_fn
    torch.cuda.empty_cache()
    numbers["dots"] = dots
    bf16, state, _, _ = switch_run(
        torch, fa, corpus, ["model.param_dtype=bfloat16"],
        PIPELINE["switch_steps"], want)
    opt_state = state.optimizer.adamw.state
    bf16["moment_dtypes"] = sorted({str(s["exp_avg"].dtype).replace(
        "torch.", "") for s in opt_state.values()})
    flash += bf16["flash"]
    del state
    torch.cuda.empty_cache()
    numbers["bf16_params"] = bf16
    base = train_numbers["unpacked"]
    numbers["nothing_float32_from_train_path"] = {
        "warm_ms_per_step": base["warm_ms_per_step"],
        "peak_gib": base["peak_gib"]}
    for name, run in (("dots", dots), ("bf16", bf16)):
        if run["flash_per_step"] != [want] or not all(
                math.isfinite(x) for x in run["losses"]):
            failures.append(f"{name} run: {run}")
    if not dots["grad_rel_l2_dots_vs_nothing"] <= floor:
        failures.append(f"dots vs nothing gradient {dots}")
    if bf16["param_dtypes"] != ["bfloat16", "float32"] or \
            bf16["moment_dtypes"] != ["bfloat16", "float32"]:
        failures.append(f"bf16 run dtypes {bf16}")
    return numbers, flash


def pipeline_sweep(torch, fa, dump, failures):
    """(f): esmdiff-torch-sweep --search sha at full width with bf16
    parameters, 2 trials over optim.lr, eta 2, min_epochs 1, on the first
    PIPELINE["sweep_chains"] chains of the dump: the promoted trial
    resumes from its own checkpoint, best.json names the best trial."""
    from esmdiff_tpu_torch.cli import sweep as sweep_cli
    from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager

    subset = PIPELINE_DIR / "sweep_corpus"
    subset.mkdir()
    for f in sorted(dump.glob("*.npz"))[:PIPELINE["sweep_chains"]]:
        (subset / f.name).symlink_to(f)
    space = PIPELINE_DIR / "space.yaml"
    space.write_text("space:\n  optim.lr: {type: loguniform, low: 1.0e-6, "
                     "high: 1.0e-4}\n")
    out = PIPELINE_DIR / "sweep"
    trials, saves = [], []
    before = fa.launches
    t0 = time.time()
    with calls(torch, sweep_cli, "_run_trial", fa, trials), \
            timed_saves(torch, CheckpointManager, saves):
        results = sweep_cli.main([
            "--config", str(ROOT / PIPELINE["configs"]["mdlm"]),
            "--space", str(space), "--n_trials", "2", "--search", "sha",
            "--eta", "2", "--min_epochs", "1", "--output", str(out),
            "--device", PIPELINE["device"], f"data.path={subset}",
            "model.param_dtype=bfloat16", "trainer.print_config=false"])
    wall = time.time() - t0
    best = json.loads((out / "best.json").read_text())
    rung0 = [r for r in results if r["rung"] == 0]
    rung1 = [r for r in results if r["rung"] == 1]
    numbers = {"s": wall, "trial_s": [r["s"] for r in trials],
               "results": results,
               "best": best, "saves": saves,
               "flash_launches": fa.launches - before}
    ok = (len(rung0) == 2 and len(rung1) == 1
          and all(r.get("val_loss") is not None for r in results))
    if ok:
        winner = min(rung0, key=lambda r: r["val_loss"])
        ok = (rung1[0]["trial"] == winner["trial"]
              and rung1[0]["steps"] == 2 * winner["steps"]
              and best["trial"] == min(results, key=lambda r: r["val_loss"])
              ["trial"])
    if not ok:
        failures.append(f"sweep: {numbers}")
    shutil.rmtree(out)
    return numbers


def pipeline_path(torch, ops, card, runtime, train_numbers, train_corpus):
    """The pipeline path (module docstring, phase 13): (a)-(f).  Returns
    (numbers, flash launches)."""
    t_phase = time.time()
    fa = ops["flash_attention"]
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    PIPELINE_DIR.mkdir(parents=True)
    gc.collect()
    torch.cuda.empty_cache()  # the JLM's batch peaks at ~76 of 80 GB (H100)
    failures, seconds = [], {}
    numbers = {"card": card, "resident_gib_at_start":
               torch.cuda.memory_allocated() / 2**30}

    def report(key, value, t0):
        seconds[key] = time.time() - t0
        numbers[key] = value
        print(f"[pipeline {key}] " + json.dumps(value), flush=True)
        if failures:
            raise AssertionError(f"pipeline path ({key}): "
                                 + "; ".join(failures))

    t0 = time.time()
    mm, stems = pipeline_mmcif(torch, fa, PIPELINE_DIR, failures)
    report("mmcif", mm, t0)
    t0 = time.time()
    dumped, dump, flash = pipeline_dump(torch, fa, runtime, PIPELINE_DIR,
                                        stems, failures)
    report("dump", dumped, t0)
    t0 = time.time()
    ar, best = pipeline_ar_train(torch, fa, dump, card, failures)
    report("ar train", {k: {"warm_ms_per_step": v["warm_ms_per_step"],
                            "peak_gib": v["peak_gib"]}
                        for k, v in ar.items()}, t0)
    t0 = time.time()
    sampled, f = pipeline_ar_sample(torch, fa, runtime, best, failures)
    flash += f
    for task in best:
        shutil.rmtree(PIPELINE_DIR / f"{task}_run")
    report("ar sample", sampled, t0)
    t0 = time.time()
    switches, f = pipeline_switches(torch, fa, train_corpus, train_numbers,
                                    failures)
    flash += f
    shutil.rmtree(train_corpus.parent)
    report("switches", switches, t0)
    t0 = time.time()
    swept = pipeline_sweep(torch, fa, dump, failures)
    flash += swept["flash_launches"]
    report("sweep", swept, t0)
    shutil.rmtree(PIPELINE_DIR)
    numbers["ar_train"] = ar
    numbers["seconds"] = seconds
    numbers["phase_s"] = time.time() - t_phase
    numbers["launches"] = {"flash_attention": flash}
    return numbers, flash


def target_sequence(directory):
    """The sequence of the one PDB of a target directory."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein

    return ESMProtein.from_pdb(next(Path(directory).glob("*.pdb"))).sequence


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from esmdiff_tpu_torch.api.generation import bucket_length, plan_batches
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
    from esmdiff_tpu_torch.ops.packing import pack_factor

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

    # 3. the default path, as the CLI ships it, on two targets: BPTI (L 60,
    # bucket 64: two rows share a device row, and packed rows take the
    # plain masked attention, so only the decoder runs the kernel) and a
    # 118-residue chain (bucket 128, pack 1: every trunk layer runs it)
    short = ROOT / "output" / "chip_smoke_targets" / L128_TARGET.stem
    short.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / L128_TARGET, short / L128_TARGET.name)
    target_dirs = {"bpti": ROOT / TARGET, L128_TARGET.stem: short}
    lws = {key: len(ESMProtein.from_pdb(next(d.glob("*.pdb"))).sequence) + 2
           for key, d in target_dirs.items()}
    dec_layers = runtime.decoder.cfg.n_layers
    n_params = sum(p.numel() for p in runtime.trunk.parameters())

    def path_numbers(driven):
        out = {}
        for key, n in driven.items():
            plan = plan_batches(lws[key], NUM_SAMPLES, policy="single")
            r = n["report"]
            out[key] = {
                "L": r["L"], "batches": plan,
                "packs": [pack_factor(b, bucket_length(lws[key]))
                          for b in plan],
                "sampling_s": r["sampling_sec"], "total_s": r["total_sec"],
                "conformations_per_s": NUM_SAMPLES / r["total_sec"],
                "ms_per_step": 1e3 * r["sampling_sec"]
                / (len(plan) * (NUM_STEPS + 1)),
                "peak_memory_gib": n["peak_memory_gib"],
                "launches": n["launches"]}
        return out

    def summed(driven):
        return {k: sum(n["launches"][k] for n in driven.values())
                for k in KERNELS}

    driven = drive(
        torch, runtime, ops, "default path",
        {key: (d, path_launches(trunk_cfg, dec_layers, lws[key], False))
         for key, d in target_dirs.items()},
        ROOT / "output" / "chip_smoke")
    launches = summed(driven)
    rel, floor = kernel_vs_plain(
        torch, runtime,
        {}, {(fa, "flash_attention"): fa.flash_attention_reference},
        {(fa, "flash_attention"): plain_attention_with_lengths})
    if not rel <= 2 * floor:
        raise AssertionError(f"full-width trunk logits, kernel vs plain "
                             f"version: relative L2 {rel}, more than twice "
                             f"the two plain roundings' {floor}")
    print("[main path] " + json.dumps({
        "card": card, "trunk_params": n_params, "init_s": init_s,
        "targets": path_numbers(driven), "launches": launches,
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
    f_driven = drive(
        torch, fused_rt, ops, "fused path",
        {key: (d, path_launches(trunk_cfg, dec_layers, lws[key], True))
         for key, d in target_dirs.items()},
        ROOT / "output" / "chip_smoke_fused")
    f_launches = summed(f_driven)

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
        "targets": path_numbers(f_driven), "launches": f_launches,
        "trunk_logits_rel_l2_kernel_vs_plain": f_rel,
        "trunk_logits_rel_l2_plain_roundings": f_floor}), flush=True)

    # 5. the gibbs path: the stock-head trunk through the CLI, gibbs and eb
    g_numbers, g_launches, stock_rt = gibbs_path(torch, runtime, ops,
                                                 target_dirs, lws, gen)
    print("[gibbs path] " + json.dumps({"card": card, **g_numbers}),
          flush=True)

    # 6. the serve path: the int8 runtime behind the port's HTTP server
    s_numbers, s_launches = serve_path(torch, runtime, ops, card, gen)
    print("[serve path] " + json.dumps(s_numbers), flush=True)

    # 7. the inpaint path: the encoder, --mask_ids/--filled_ids, the
    # server's priors, the trunk with coordinates, cli.dump
    i_numbers, i_launches = inpaint_path(torch, runtime, stock_rt, ops,
                                         target_dirs, lws, card)
    print("[inpaint path] " + json.dumps(i_numbers), flush=True)

    # 8. the train path: a corpus through cli.dump, an unpacked epoch and
    # a packed run of configs/mdlm.yaml at full width, kernel vs plain in
    # a train step, --ckpt through the sampling CLI
    t_numbers, t_launches, mdlm_ckpt = train_path(torch, runtime, ops, card)
    print("[train path] " + json.dumps(t_numbers), flush=True)

    # 9. the AR path: configs/clm.yaml and configs/jlm.yaml through
    # cli.sample_ar on the default runtime (its trunk and decoder), both
    # targets, int8 on BPTI; its --runtime_ckpt request follows phase 10
    a_numbers, a_flash = ar_path(torch, runtime, ops, card, target_dirs)

    # 10. the vqvae path: the tokenizer trained at full geometry through
    # esmdiff-torch-train-vqvae, kernel vs plain in a VQ step, the export,
    # --vqvae_ckpt with the train path's trunk; the earlier runtimes are
    # freed first (the encoder's activations need the room)
    del runtime, fused_rt, fused_trunk, stock_rt, layer0
    gc.collect()
    torch.cuda.empty_cache()
    v_numbers, v_launches, export = vqvae_path(torch, ops, card, gen,
                                               mdlm_ckpt)
    print("[vqvae path] " + json.dumps(v_numbers), flush=True)
    a_numbers["runtime_ckpt_vqvae_ckpt"], ckpt_flash = ar_ckpt_request(
        torch, ops, card, mdlm_ckpt, export)
    shutil.rmtree(export.parent)
    shutil.rmtree(mdlm_ckpt.parent)  # the run; the corpus beside it stays
    a_launches = {**dict.fromkeys(KERNELS, 0),
                  "flash_attention": a_flash + ckpt_flash}
    print("[ar path] " + json.dumps(a_numbers), flush=True)

    # 11. the eval path: esmdiff-torch-analyze bpti, apo and ped on the
    # default path's ensembles, on the card and against the CPU
    e_numbers, e_launches = eval_path(
        torch, ops, card, {key: ROOT / "output" / "chip_smoke" / key
                           / f"{key}.pdb" for key in target_dirs})
    print("[eval path] " + json.dumps(e_numbers), flush=True)

    # 12. the weights path: reference-layout files at full width through
    # esmdiff-torch-verify, load_runtime, --ckpt (ddpm and gibbs),
    # model.pretrained_ckpt on the train path's corpus, the function
    # decoder, the runbook
    w_numbers, w_flash = weights_path(
        torch, ops, card, target_dirs, lws, path_numbers(driven),
        ROOT / "output" / "chip_smoke_train" / "corpus")
    print("[weights path] " + json.dumps(w_numbers), flush=True)

    # 13. the pipeline path: an mmCIF corpus through esmdiff-torch-preprocess
    # (DSSP on the card), the dump with embeddings, CLM and JLM training,
    # sample-ar over the trained runs and ped analysis, the MDLM under
    # remat_policy=dots and bf16 parameters, the sweep
    t0 = time.time()
    p_runtime = ESM3Runtime.random_init(
        seed=0, trunk_cfg=ESM3Config(head_type="structure"), device="cuda")
    torch.cuda.synchronize()
    p_init_s = time.time() - t0
    p_numbers, p_flash = pipeline_path(
        torch, ops, card, p_runtime, t_numbers,
        ROOT / "output" / "chip_smoke_train" / "corpus")
    p_numbers["runtime_init_s"] = p_init_s
    del p_runtime
    gc.collect()
    torch.cuda.empty_cache()
    print("[pipeline path] " + json.dumps(p_numbers), flush=True)

    # 14. the kernels line (headline shape: the trunk's), the device line;
    # launches from the paths that run the kernel, fused_ffn's from its
    # phase (no model path runs it)
    by_path = {"default path": launches, "fused path": f_launches,
               "gibbs path": g_launches, "serve path": s_launches,
               "inpaint path": i_launches,
               "train path": {**dict.fromkeys(KERNELS, 0), **t_launches},
               "vqvae path": {**dict.fromkeys(KERNELS, 0), **v_launches},
               "ar path": a_launches, "eval path": e_launches,
               "weights path": {**dict.fromkeys(KERNELS, 0),
                                "flash_attention": w_flash},
               "pipeline path": {**dict.fromkeys(KERNELS, 0),
                                 "flash_attention": p_flash}}
    launches_from = {"flash_attention": ("default path", "inpaint path",
                                         "train path", "vqvae path",
                                         "ar path", "weights path",
                                         "pipeline path"),
                     "small_attention": ("fused path",),
                     "fused_qkv": ("fused path",)}
    entries = []
    for name in KERNELS:
        head = shapes[name][0]
        src = launches_from.get(name)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"esmdiff_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": (sum(by_path[p][name] for p in src) if src
                         else ffn_phase_launches),
            "launches_from": (" + ".join(src) if src
                              else "kernel phase: no model path runs it"),
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
