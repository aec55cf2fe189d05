"""Seeded weights in the published checkpoints' layout.

The names are ESM3's (the public esm-3.0.4 module tree, as the port's
``convert/torch_ckpt.py`` rule tables read them): the trunk of
``esm3_sm_open_v1`` with its stock heads or the fine-tune's structure
head, an ESMDiff release's ``sigma_embedder.mlp.{0,2}``, and
``esm3_structure_decoder_v0``.  Every tensor is a view of one float32
buffer drawn on the device by one ``torch.randn`` call from the seed, then
scaled in place: products N(0, 1/fan_in), embedding tables
N(0, 1/rows), LayerNorm scales 1 + 0.1 N(0, 1), biases 0.02 N(0, 1).  The
same seed gives the same values on the same device, so the reference draws
them again instead of taking anything the program holds.
"""

from __future__ import annotations

import torch

# ESM3's token tables (esm.utils.constants.esm3)
SEQUENCE_EMBED = 64
STRUCTURE_VOCAB = 4101
SS8_VOCAB = 11
SASA_VOCAB = 19
FUNCTION_VOCAB, FUNCTION_DEPTH = 260, 8
RESIDUE_VOCAB = 1481
STOCK_HEADS = {"sequence_head": SEQUENCE_EMBED, "structure_head": 4096,
               "ss8_head": SS8_VOCAB, "sasa_head": SASA_VOCAB,
               "function_head": FUNCTION_VOCAB * FUNCTION_DEPTH,
               "residue_head": RESIDUE_VOCAB}


def _head(p: str, d: int, out: int) -> dict:
    return {f"{p}.0.weight": (d, d), f"{p}.0.bias": (d,),
            f"{p}.2.weight": (d,), f"{p}.2.bias": (d,),
            f"{p}.3.weight": (out, d), f"{p}.3.bias": (out,)}


def _blocks(p: str, d: int, hidden: int, n_layers: int, n_geom: int = 0,
            v_heads: int = 0) -> dict:
    shapes = {f"{p}.norm.weight": (d,)}
    for i in range(n_layers):
        b = f"{p}.blocks.{i}"
        shapes.update({
            f"{b}.attn.layernorm_qkv.0.weight": (d,),
            f"{b}.attn.layernorm_qkv.1.weight": (3 * d, d),
            f"{b}.attn.q_ln.weight": (d,), f"{b}.attn.k_ln.weight": (d,),
            f"{b}.attn.out_proj.weight": (d, d),
            f"{b}.ffn.0.weight": (d,), f"{b}.ffn.1.weight": (2 * hidden, d),
            f"{b}.ffn.3.weight": (d, hidden)})
        if i < n_geom:
            shapes.update({
                f"{b}.geom_attn.s_norm.weight": (d,),
                f"{b}.geom_attn.proj.weight": (v_heads * 15, d),
                f"{b}.geom_attn.out_proj.weight": (d, v_heads * 3),
                f"{b}.geom_attn.distance_scale_per_head": (v_heads,),
                f"{b}.geom_attn.rotation_scale_per_head": (v_heads,)})
    return shapes


def trunk_shapes(t: dict) -> dict:
    """{ESM3 key: shape} of a trunk config (``configs/*.json``'s
    ``trunk``)."""
    d = t["d_model"]
    shapes = {
        "encoder.sequence_embedding.weight": (SEQUENCE_EMBED, d),
        "encoder.structure_tokens_embedding.weight": (STRUCTURE_VOCAB, d),
        "encoder.ss8_embedding.weight": (SS8_VOCAB, d),
        "encoder.sasa_embedding.weight": (SASA_VOCAB, d),
        "encoder.plddt_projection.weight": (d, 16),
        "encoder.structure_per_res_plddt_projection.weight": (d, 16),
        "encoder.function_embeddings.weight":
            (FUNCTION_VOCAB * FUNCTION_DEPTH, d // FUNCTION_DEPTH),
        "encoder.residue_embedding.weight": (RESIDUE_VOCAB, d)}
    shapes.update(_blocks("transformer", d, t["ffn_hidden"], t["n_layers"],
                          t["n_layers_geom"], t["v_heads"]))
    heads = (STOCK_HEADS if t["head"] == "esm3"
             else {"structure_head": t["n_structure_heads"]})
    for name, out in heads.items():
        shapes.update(_head(f"output_heads.{name}", d, out))
    return shapes


def sigma_shapes(t: dict) -> dict:
    d, f = t["d_model"], t["sigma_frequency_size"]
    return {"sigma_embedder.mlp.0.weight": (d, f),
            "sigma_embedder.mlp.0.bias": (d,),
            "sigma_embedder.mlp.2.weight": (d, d),
            "sigma_embedder.mlp.2.bias": (d,)}


def decoder_shapes(dec: dict) -> dict:
    d = dec["d_model"]
    shapes = {"embed.weight": (STRUCTURE_VOCAB, d),
              "affine_output_projection.ffn1.weight": (d, d),
              "affine_output_projection.ffn1.bias": (d,),
              "affine_output_projection.norm.weight": (d,),
              "affine_output_projection.norm.bias": (d,),
              "affine_output_projection.proj.weight": (9, d),
              "affine_output_projection.proj.bias": (9,)}
    shapes.update(_blocks("decoder_stack", d, dec["ffn_hidden"],
                          dec["n_layers"]))
    shapes.update(_head("plddt_head", d, dec["plddt_bins"]))
    return shapes


def _scale(name: str, shape: tuple) -> tuple[float, float]:
    """(std, mean) of a tensor's values."""
    if name.endswith(".bias"):
        return 0.02, 0.0
    if len(shape) == 1:                       # LayerNorm scales, per head
        return 0.1, 1.0
    if "embed" in name:                       # token tables
        return shape[0] ** -0.5, 0.0
    return shape[1] ** -0.5, 0.0              # products: (out, in)


@torch.no_grad()
def make(shapes: dict, seed: int, device) -> dict:
    """{key: float32 tensor} on ``device``: one ``torch.randn`` of the
    whole size from ``seed``, each key a scaled view of it."""
    total = sum(_numel(s) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = _numel(shape)
        std, mean = _scale(name, shape)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def port_names(t: dict) -> dict:
    """{the trainer's parameter name: ESM3 key} of an MDLM (trunk under
    ``net.``, the sigma embedder under ``sigma_embedder.``), the inverse of
    the published layout's names, written out here so that the judge of a
    training step does not take the program's own map."""
    names = {"net.encoder.sequence_embed.weight":
             "encoder.sequence_embedding.weight",
             "net.encoder.structure_tokens_embed.weight":
             "encoder.structure_tokens_embedding.weight",
             "net.encoder.ss8_embed.weight": "encoder.ss8_embedding.weight",
             "net.encoder.sasa_embed.weight": "encoder.sasa_embedding.weight",
             "net.encoder.average_plddt_proj.weight":
             "encoder.plddt_projection.weight",
             "net.encoder.per_res_plddt_proj.weight":
             "encoder.structure_per_res_plddt_projection.weight",
             "net.encoder.function_embed.weight":
             "encoder.function_embeddings.weight",
             "net.encoder.residue_embed.weight":
             "encoder.residue_embedding.weight",
             "net.transformer.norm.scale": "transformer.norm.weight",
             "sigma_embedder.fc1.weight": "sigma_embedder.mlp.0.weight",
             "sigma_embedder.fc1.bias": "sigma_embedder.mlp.0.bias",
             "sigma_embedder.fc2.weight": "sigma_embedder.mlp.2.weight",
             "sigma_embedder.fc2.bias": "sigma_embedder.mlp.2.bias"}
    block = {"attn.ln.scale": "attn.layernorm_qkv.0.weight",
             "attn.qkv.weight": "attn.layernorm_qkv.1.weight",
             "attn.q_ln.scale": "attn.q_ln.weight",
             "attn.k_ln.scale": "attn.k_ln.weight",
             "attn.out.weight": "attn.out_proj.weight",
             "ffn.ln.scale": "ffn.0.weight", "ffn.up.weight": "ffn.1.weight",
             "ffn.down.weight": "ffn.3.weight"}
    geom = {"geom_attn.ln.scale": "geom_attn.s_norm.weight",
            "geom_attn.proj.weight": "geom_attn.proj.weight",
            "geom_attn.out.weight": "geom_attn.out_proj.weight",
            "geom_attn.distance_scale": "geom_attn.distance_scale_per_head",
            "geom_attn.rotation_scale": "geom_attn.rotation_scale_per_head"}
    for i in range(t["n_layers"]):
        own = {**block, **(geom if i < t["n_layers_geom"] else {})}
        for a, b in own.items():
            names[f"net.transformer.blocks.{i}.{a}"] = \
                f"transformer.blocks.{i}.{b}"
    heads = (STOCK_HEADS if t["head"] == "esm3" else ("structure_head",))
    for h in heads:
        for a, b in (("dense.weight", "0.weight"), ("dense.bias", "0.bias"),
                     ("ln.scale", "2.weight"), ("ln.bias", "2.bias"),
                     ("out.weight", "3.weight"), ("out.bias", "3.bias")):
            names[f"net.output_heads.{h}.{a}"] = f"output_heads.{h}.{b}"
    return names
