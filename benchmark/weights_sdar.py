"""Seeded SDAR weights in the published layout (``sdar_moe``: Qwen3-MoE's
names), one part at a time: the top-level tensors (embedding, final norm,
head) and each layer, each part from a seed of its own, so that a 61 GB
model is filled, and checked, one part's float32 tensors at a time.
Values as ``weights.make`` draws them: products N(0, 1/fan_in), the
embedding N(0, 1/rows), norms 1 + 0.1 N(0, 1).
"""

from __future__ import annotations

from benchmark import harness, weights


def top_shapes(cfg: dict) -> dict:
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    return {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,),
            "lm_head.weight": (v, d)}


def layer_shapes(cfg: dict, i: int) -> dict:
    d, dh, h = cfg["hidden_size"], cfg["head_dim"], cfg["num_attention_heads"]
    kv, e, f = (cfg["num_key_value_heads"], cfg["num_experts"],
                cfg["moe_intermediate_size"])
    p = f"model.layers.{i}."
    shapes = {p + "input_layernorm.weight": (d,),
              p + "self_attn.q_proj.weight": (h * dh, d),
              p + "self_attn.k_proj.weight": (kv * dh, d),
              p + "self_attn.v_proj.weight": (kv * dh, d),
              p + "self_attn.o_proj.weight": (d, h * dh),
              p + "self_attn.q_norm.weight": (dh,),
              p + "self_attn.k_norm.weight": (dh,),
              p + "post_attention_layernorm.weight": (d,),
              p + "mlp.gate.weight": (e, d)}
    for j in range(e):
        q = f"{p}mlp.experts.{j}."
        shapes.update({q + "gate_proj.weight": (f, d),
                       q + "up_proj.weight": (f, d),
                       q + "down_proj.weight": (d, f)})
    return shapes


def part_seeds(seed: int, cfg: dict) -> list[int]:
    """One seed for the top-level tensors, then one a layer."""
    return harness.seeds(seed, cfg["num_hidden_layers"] + 1)


def make_top(cfg: dict, seed: int, device) -> dict:
    return weights.make(top_shapes(cfg), part_seeds(seed, cfg)[0], device)


def make_layer(cfg: dict, i: int, seed: int, device) -> dict:
    return weights.make(layer_shapes(cfg, i), part_seeds(seed, cfg)[1 + i],
                        device)
