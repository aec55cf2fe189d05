"""Heads per block (G) against time for the attention kernels, on one card.

    python -m esmdiff_tpu_torch.tools.attention_groups   # from the repo root

At the main path's shapes, the trunk's (B 64, L 64, H 24) and the VQ
decoder's (B 32, L 64, H 20), bf16, unit-normal q, k, v from seed 0 and
random lengths with one empty row (as ``chip_smoke.py`` makes them), each
kernel (flash_attention, small_attention) is launched at every divisor G of
H and held against its plain version; per G it prints the blocks, the
blocks a full wave holds (SMs x ``BLOCKS_PER_SM``), the kernel ms and
the rate of the bytes the call must move (q read and o written in full, k
and v for the keys the lengths need, plus small_attention's tables once),
and which G ``pick_group`` takes.  Times are the device's
(``tools/timing.py``): at these shapes one call's host enqueue (~0.03 ms)
is longer than the kernel.  Prints the card first, one JSON line per
(kernel, shape), and exits non-zero without a card.
"""

import json
import subprocess
import sys

import torch

from esmdiff_tpu_torch.nn.rotary import rotary_tables
from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops import flash_attention as fa
from esmdiff_tpu_torch.ops import small_attention as sa
from esmdiff_tpu_torch.tools.timing import device_ms

SHAPES = {"trunk": (64, 64, 24), "decoder": (32, 64, 20)}


def launch(name, q, k, v, lengths, tables, G):
    """One launch of ``name``'s kernel with G heads a block (the wrapper
    takes ``fa.heads_per_block``'s); q, k, v contiguous, lengths int32."""
    B, L, H, _ = q.shape
    out = torch.empty_like(q)
    _build.launch(
        name, f"esmdiff_{name}_fwd", fa.ARGTYPES[name], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), *(t.data_ptr() for t in tables), B, L, H, G,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_groups: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.set_grad_enabled(False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (B, L, H) in SHAPES.items():
        q, k, v = (torch.randn(B, L, H, 64, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=gen,
                                dtype=torch.int32)
        lengths[0] = 0
        cos, sin = rotary_tables(L, 64, device="cuda")
        keys = sum(n if n >= 1 else L for n in lengths.tolist())
        nbytes = (2 * q.numel() + 2 * keys * H * 64) * 2
        for name, plain, tables in (
                ("flash_attention", fa.flash_attention_reference, ()),
                ("small_attention", sa.small_attention_reference,
                 (cos, sin))):
            ref = plain(q, k, v, *tables, lengths).float()
            slots = (torch.cuda.get_device_properties(0).multi_processor_count
                     * fa.BLOCKS_PER_SM[name])
            extra = 2 * cos.numel() * 4 if tables else 0
            rows = []
            for G in (g for g in range(1, H + 1) if H % g == 0):
                def call(G=G):
                    return launch(name, q, k, v, lengths, tables, G)
                err = (call().float() - ref).abs().max().item()
                ms = device_ms(call)
                rows.append({"G": G, "blocks": B * H // G, "ms": ms,
                             "GB_per_s": (nbytes + extra) / ms / 1e6,
                             "max_abs_err": err})
            print("[groups] " + json.dumps({
                "card": card, "kernel": name, "shape": shape, "B": B, "L": L,
                "H": H, "wave_blocks": slots,
                "picked_G": fa.heads_per_block(name, B, L, H, q.device),
                "by_G": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
