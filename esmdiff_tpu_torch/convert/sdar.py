"""The published SDAR layout (``sdar_moe``, Qwen3-MoE's names) into
``models/sdar.py``, strictly: every key the named parts need, no other,
each of its shape.

    model.embed_tokens.weight         -> embed_tokens.weight
    model.layers.{i}.{input,post_attention}_layernorm.weight,
      .self_attn.{o_proj,q_norm,k_norm}.weight, .mlp.gate.weight
                                      -> layers.{i}.<the same>
    model.layers.{i}.self_attn.{q,k,v}_proj.weight
                                      -> layers.{i}.self_attn.qkv_proj
                                         (stacked in that order)
    model.layers.{i}.mlp.experts.{e}.{gate,up}_proj.weight
                                      -> layers.{i}.mlp.experts.w_gate_up[e]
    model.layers.{i}.mlp.experts.{e}.down_proj.weight
                                      -> layers.{i}.mlp.experts.w_down[e]
    model.norm.weight, lm_head.weight -> norm.weight, lm_head.weight

``load`` takes the whole checkpoint, or (``layers=``, ``top=``) some of
its layers and the top-level tensors, so that a caller can fill a 61 GB
model one layer's tensors at a time.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import torch

_LAYER = ("input_layernorm.weight", "post_attention_layernorm.weight",
          "self_attn.o_proj.weight", "self_attn.q_norm.weight",
          "self_attn.k_norm.weight", "mlp.gate.weight")
_QKV = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
        "self_attn.v_proj.weight")
_TOP = {"model.embed_tokens.weight": "embed_tokens.weight",
        "model.norm.weight": "norm.weight", "lm_head.weight": "lm_head.weight"}
_EXPERT = ("gate_proj", "up_proj", "down_proj")


def published_keys(cfg, layers: Optional[Iterable[int]] = None,
                   top: bool = True) -> list[str]:
    """The published keys of ``layers`` (default all) and, with ``top``,
    of the embedding, the final norm and the head."""
    layers = range(cfg.num_hidden_layers) if layers is None else layers
    keys = list(_TOP) if top else []
    for i in layers:
        p = f"model.layers.{i}."
        keys += [p + k for k in _LAYER + _QKV]
        keys += [f"{p}mlp.experts.{e}.{w}.weight"
                 for e in range(cfg.num_experts) for w in _EXPERT]
    return keys


@torch.no_grad()
def load(model, state_dict: Mapping[str, torch.Tensor],
         layers: Optional[Iterable[int]] = None, top: bool = True) -> None:
    """Copy ``state_dict`` (published names) into ``model``; raises
    KeyError on a missing or unexpected key, ValueError on a shape."""
    cfg = model.cfg
    layers = list(range(cfg.num_hidden_layers) if layers is None else layers)
    want = set(published_keys(cfg, layers, top))
    missing, extra = want - set(state_dict), set(state_dict) - want
    if missing or extra:
        raise KeyError(f"SDAR checkpoint: missing {sorted(missing)[:5]} "
                       f"({len(missing)}), unexpected {sorted(extra)[:5]} "
                       f"({len(extra)})")
    own = dict(model.named_parameters())

    def put(name, value):
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: expected {tuple(own[name].shape)}, "
                             f"got {tuple(value.shape)}")
        own[name].copy_(value)

    if top:
        for src, dst in _TOP.items():
            put(dst, state_dict[src])
    for i in layers:
        p = f"model.layers.{i}."
        for k in _LAYER:
            put(f"layers.{i}.{k}", state_dict[p + k])
        put(f"layers.{i}.self_attn.qkv_proj.weight",
            torch.cat([state_dict[p + k] for k in _QKV]))

        def stacked(w, i=i, p=p):
            return torch.stack([state_dict[f"{p}mlp.experts.{e}.{w}.weight"]
                                for e in range(cfg.num_experts)])

        model.layers[i].mlp.experts.load(
            torch.cat([stacked("gate_proj"), stacked("up_proj")], dim=1),
            stacked("down_proj"))
