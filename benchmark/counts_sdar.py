"""The yardstick's arithmetic for SDAR's experts: what the expert products
of a forward must move and compute, counted from the routing alone
(``moe.experts_hit``: the experts that got at least one token, summed over
layers and forwards; ``moe.tokens_routed``: the token-expert pairs),
whatever implements the products.

Each expert that got a token reads its weights once: gate and up
(2 I x D) and down (D x I), bf16.  Each pair reads its token's D inputs,
writes and reads back the 2 I of gate and up, writes and reads back the
I of the activation, and writes D outputs, bf16 (the activation's
elementwise pass, between the two products, is counted with them).  Each
pair takes 2 x 3 D I FLOPs.  The least time is the larger of the bytes
over the HBM bandwidth and the FLOPs over the bf16 peak
(``counts.PEAK_*``): at these token counts, the bytes.
"""

from __future__ import annotations

from benchmark import counts

BF16 = 2


def expert_bytes(cfg: dict, experts_hit: int, tokens_routed: int) -> float:
    d, i = cfg["hidden_size"], cfg["moe_intermediate_size"]
    weights = experts_hit * 3 * d * i * BF16
    pairs = tokens_routed * (d + 2 * i + 2 * i + i + i + d) * BF16
    return float(weights + pairs)


def expert_flops(cfg: dict, tokens_routed: int) -> float:
    return 6.0 * cfg["hidden_size"] * cfg["moe_intermediate_size"] \
        * tokens_routed


def expert_bound_s(cfg: dict, experts_hit: int, tokens_routed: int) -> float:
    return max(expert_bytes(cfg, experts_hit, tokens_routed)
               / counts.PEAK_HBM_BYTES_PER_S,
               expert_flops(cfg, tokens_routed) / counts.PEAK_BF16_FLOPS)


def traced_counts(found) -> dict:
    """The program's counters over a traced window: the sum over its root
    spans (``program.spans``' records)."""
    out: dict = {}
    for _, _, _, s in found or ():
        if s["parent"] is None:
            for k, v in (s.get("counters") or {}).items():
                out[k] = out.get(k, 0) + v
    return out
