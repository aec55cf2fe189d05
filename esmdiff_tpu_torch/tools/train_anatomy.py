"""Where a full-width MDLM train step spends the card's time.

    python -m esmdiff_tpu_torch.tools.train_anatomy   # from the repo root

Builds the trainer's model from ``configs/mdlm.yaml`` (the 1.4B trunk,
float32 master weights, bf16 compute, remat, AdamW) with random weights
(seed 42) and one (16, 512) batch of random tokens from seed 0, then for
the unpacked step (no attention mask: the flash kernel in every layer)
and the packed one (four 128-token segments a row: the plain masked path)
runs two untimed steps and ``STEPS`` steps under ``torch.profiler``.  Per
layout it prints one JSON line: the host ms per step (synchronised), the
device ms per step summed over kernels (one stream, so the busy time) and
its share of the step, the device ms by kind of kernel (from the
kernel's name: the flash kernel, products, optimizer, copies and casts,
reductions, elementwise, other), and the kernels with the most device
time, each with its launches a step.  Token
values do not change the work, so random tokens stand in for a corpus.
Prints the card first and exits non-zero without one.
"""

import collections
import json
import subprocess
import sys
import time

import torch

from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.train.config import load_config
from esmdiff_tpu_torch.train.loop import build_task, init_params, mdlm_modules

STEPS, TOP = 3, 24
B, L, SEGMENT = 16, 512, 128


def batch(packed: bool, gen: torch.Generator) -> dict:
    """A (B, L) batch on the card: random codes and residues, every
    position valid; packed rows hold L // SEGMENT segments."""
    out = {"structure_tokens": torch.randint(0, 4096, (B, L), generator=gen),
           "sequence_tokens": torch.randint(4, 24, (B, L), generator=gen),
           "mask": torch.ones(B, L)}
    if packed:
        pos = torch.arange(L)
        out["segment_ids"] = (pos // SEGMENT).expand(B, L).clone()
        out["positions"] = (pos % SEGMENT).expand(B, L).clone()
    return {k: v.cuda() for k, v in out.items()}


# kernel-name patterns of each kind of device work, first match wins
KINDS = (("flash kernel", ("esmdiff_attn",)),
         ("products", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
         ("optimizer", ("multi_tensor", "foreach", "adam")),
         ("copies and casts", ("copy", "memcpy")),
         ("reductions", ("reduce", "softmax", "layer_norm", "norm")),
         ("elementwise", ("elementwise",)))


def kind(name: str) -> str:
    low = name.lower()
    return next((k for k, pats in KINDS if any(p in low for p in pats)),
                "other")


def anatomy(state, loss_fn, b) -> dict:
    draws = GeneratorDraws(b["mask"].device, seed=0)
    for _ in range(2):
        tstate.train_step(state, loss_fn, b, draws)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            tstate.train_step(state, loss_fn, b, draws)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    # the card's work: its kernels and copies (one stream, no overlap);
    # user annotations (the optimizer's step range) span kernels and are
    # left out
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            kernels[e.name][0] += e.time_range.elapsed_us()
            kernels[e.name][1] += 1
    device_ms = sum(us for us, _ in kernels.values()) / 1e3 / STEPS
    by_kind = collections.Counter()
    for name, (us, _) in kernels.items():
        by_kind[kind(name)] += us / 1e3 / STEPS
    return {"host_ms_per_step_profiled": host_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / host_ms,
            "device_ms_per_step_by_kind": dict(by_kind.most_common()),
            "top_kernels": [{"kernel": name[:120], "kind": kind(name),
                             "device_ms_per_step": us / 1e3 / STEPS,
                             "launches_per_step": n / STEPS}
                            for name, (us, n) in sorted(
                                kernels.items(), key=lambda kv: -kv[1][0])
                            [:TOP]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_anatomy: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    cfg = load_config("configs/mdlm.yaml")
    mdlm, loss_fn = build_task(cfg, "cuda")
    init_params(mdlm, cfg)
    modules = mdlm_modules(mdlm)
    state = tstate.create_train_state(modules, tstate.make_optimizer(
        modules.parameters(), lr=cfg.optim.lr,
        weight_decay=cfg.optim.weight_decay))
    gen = torch.Generator().manual_seed(0)
    for packed in (False, True):
        numbers = anatomy(state, loss_fn, batch(packed, gen))
        print(json.dumps({"layout": "packed" if packed else "unpacked",
                          "batch": [B, L], **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
