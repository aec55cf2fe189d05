"""Where the time of the fused_ffn kernel goes, on one CUDA card.

    python -m esmdiff_tpu_torch.tools.ffn_anatomy   # from the repo root

Two measurements at D 1536, H 4096 (the trunk's FFN), random weights from
seed 0, bf16:
  1. waves: kernel ms at M = 128 k rows for k = 1 .. 32 row tiles (one
     8-block cluster each).  Equal times up to k = W and a step after it
     show that W clusters run at once and that a tile's time does not
     depend on how many others share the card;
  2. slices: a copy of csrc/fused_ffn.cu with clock64 stamps at six points
     of every 64-deep slice (threads 0 and 128 of the first block, one per
     warpgroup), built beside the real library, swapped in for the
     wrapper's and held against the plain version; per kind of slice (up,
     the last up slice of a chunk, down) the mean SM cycles of: the wait
     for the stage (mbar), the wgmma issue (issue), the wait for the
     previous group (wait), the work up to the barrier (work), the barrier
     (bar) and the rest up to the next slice (tail: the refill, for thread
     0).  The products of a slice take 512 (up) or 768 (down) cycles at the
     bf16 tensor-core peak (4096 operations a cycle an SM).
Prints the card, one JSON line per measurement, and exits non-zero without
a card.  The stamps are observed, not guaranteed: the compiler may move
work across a clock read, so only each slice's total is exact.
"""

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops import fused_ffn as ff

D, H, TILE = 1536, 4096, 128
NK, SPC = D // 64, D // 64 + 8      # up slices, slices per chunk
POINTS = ("mbar", "issue", "wait", "work", "bar")
STAMPED = "fused_ffn_stamped"


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stamped_source(src: str) -> str:
    """csrc/fused_ffn.cu with the stamps; raises if an anchor is gone."""
    def insert_after(text, anchor, line, start):
        at = text.index(anchor, start)
        at = text.index("\n", at) + 1
        return text[:at] + line + text[at:], at

    src = src.replace(
        "namespace {\n", "__device__ long long g_stamps[2][8192][6];\n\n"
        "namespace {\n", 1)
    at = src.index("  int g = 0;\n")
    src = (src[:at] + "  const bool stamp = blockIdx.y == 0 && rank == 0 && "
           "(tid == 0 || tid == 128);\n  long long (*S)[6] = "
           "g_stamps[tid == 128];\n#define STAMP(k) if (stamp) S[g][k] = "
           "clock64();\n" + src[at:])
    for loop in ("for (int kt = 0; kt < NK; ++kt, ++g) {",
                 "for (int p = 0; p < CLUSTER; ++p, ++g) {"):
        k = src.index(loop)
        src, k = insert_after(src, "const int s = g % STAGES;",
                              "      STAMP(0)\n", k)
        src, k = insert_after(src, "mbar_wait(", "      STAMP(1)\n", k)
        src, k = insert_after(src, "wgmma.commit_group.sync.aligned",
                              "      STAMP(2)\n", k)
        end = src.index("consumer_sync();", k)
        waits = [m for m in range(k, end)
                 if src.startswith("fence_acc(acc_", m)]
        for m in reversed(waits):
            nl = src.index("\n", m) + 1
            src = src[:nl] + "      STAMP(3)\n" + src[nl:]
        end = src.index("consumer_sync();", k)
        src = (src[:end] + "STAMP(4)\n      consumer_sync();\n      STAMP(5)"
               + src[end + len("consumer_sync();"):])
    if src.count("STAMP(") != 14:
        raise RuntimeError("csrc/fused_ffn.cu changed: update the anchors")
    return src + ('\nextern "C" int esmdiff_ffn_stamps(void* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, "
                  "sizeof(g_stamps));\n}\n")


def build_stamped():
    """Build the stamped copy beside the real library; returns it."""
    csrc = _build.BUILD_DIR / "anatomy" / "csrc"
    csrc.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, csrc)
    (csrc / f"{STAMPED}.cu").write_text(
        stamped_source((_build.CSRC / "fused_ffn.cu").read_text()))
    saved = _build.CSRC, _build.BUILD_DIR
    _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent
    try:
        return _build._load(STAMPED)
    finally:
        _build.CSRC, _build.BUILD_DIR = saved


def slice_table(stamps):
    """Mean cycles per point for up, last-up and down slices."""
    n = stamps.shape[0]
    d = np.diff(stamps, axis=1)
    tail = np.append(stamps[1:, 0] - stamps[:-1, 5], 0)
    kind = np.arange(n) % SPC
    out = {"cycles": int(stamps[-1, 5] - stamps[0, 0])}
    for name, sel in (("up", kind < NK - 1), ("last_up", kind == NK - 1),
                      ("down", kind >= NK)):
        sel = sel & (np.arange(n) < n - 1)
        row = {p: float(d[sel, i].mean()) for i, p in enumerate(POINTS)}
        row["tail"] = float(tail[sel].mean())
        row["slice"] = float((stamps[1:, 0] - stamps[:-1, 0])[sel[:-1]].mean())
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ffn_anatomy: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    up = (torch.randn(2 * H, D, device="cuda", generator=gen)
          * D ** -0.5).to(torch.bfloat16)
    down = (torch.randn(D, H, device="cuda", generator=gen)
            * H ** -0.5).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    x = torch.randn(32 * TILE, D, device="cuda", dtype=torch.bfloat16,
                    generator=gen)
    args = (scale, up.t(), down.t())

    ms = [cuda_ms(lambda k=k: ff.fused_swiglu_ffn(x[:k * TILE], *args))
          for k in range(1, 33)]
    per_wave = max(k for k in range(1, 33) if ms[k - 1] < 1.1 * ms[0])
    print("[waves] " + json.dumps({
        "card": card, "D": D, "H": H, "rows_per_tile": TILE,
        "ms_by_tiles": [round(t, 4) for t in ms],
        "tiles_per_wave": per_wave}), flush=True)

    lib = build_stamped()
    lib.esmdiff_ffn_stamps.argtypes = [ctypes.c_void_p]
    real = _build._load("fused_ffn")
    _build._libs["fused_ffn"] = lib
    try:
        for tiles in (1, per_wave):
            xs = x[:tiles * TILE]
            out = ff.fused_swiglu_ffn(xs, *args)
            ref = ff.fused_swiglu_ffn_reference(xs, *args).float()
            err = ((out.float() - ref).abs() / ref.abs().clamp_min(1)).max()
            t = cuda_ms(lambda: ff.fused_swiglu_ffn(xs, *args))
            buf = np.zeros((2, 8192, 6), np.int64)
            if lib.esmdiff_ffn_stamps(buf.ctypes.data):
                raise RuntimeError("reading the stamps failed")
            total = H // 512 * SPC
            print("[slices] " + json.dumps({
                "card": card, "tiles": tiles, "ms": t,
                "max_rel_err": err.item(),
                "thread_0": slice_table(buf[0, :total]),
                "thread_128": slice_table(buf[1, :total])}), flush=True)
    finally:
        _build._libs["fused_ffn"] = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
