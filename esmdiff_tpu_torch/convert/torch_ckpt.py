"""Reference PyTorch checkpoints into the port's modules: port of
``esmdiff_tpu/convert/torch_to_jax.py``.

Converts the ESM3-family state dicts the reference loads into the port's
modules: the ESM3 trunk (``esm3_sm_open_v1``: ``head_type="esm3"``; the
ESMDiff fine-tune: ``head_type="structure"``), the VQ-VAE encoder and
decoder (``esm3_structure_{encoder,decoder}_v0``), the function-token
decoder, and the sigma embedder of an ESMDiff release checkpoint.  Files
come in the layouts the reference writes (slm/utils/checkpoint_utils.py:
7-75): a bare state dict, Lightning's ``state_dict``, DeepSpeed's
consolidated ``module``, with ``_forward_module.``/``module.``/``model.``
key prefixes, and the MDLM's ``net.`` (trunk) and ``sigma_embedder.``.

A rule table maps each of the port's parameter names to the reference
key.  Both sides are PyTorch layout, so no value is transposed; the JAX
package's scan-stacked layers are per-layer modules here, one rule a
layer.  Conversion is strict: a parameter of the port with no rule
("unmapped"), a key the rules name that the file lacks ("missing"), a
shape that differs, or layers in the file that the module lacks raise,
naming the keys.  The only parameters left as they were are those with no
reference source by design (``NO_SOURCE``: the VQ decoder's low-rank
``pae_q``/``pae_k``), which the report lists.  (The JAX package converts
with ``strict=False`` and keeps random values behind a printed count.)

Hooks, as in JAX: ``key_overrides`` ({reference key: the key a file
carries}, merged over the module-wide ``KEY_OVERRIDES``) patches naming
drift without touching the tables; ``value_transforms`` ({key: fn}) is
applied to a tensor as it is read (e.g. a geometric-attention projection
packed in another per-head channel order).

Assumption: the reference's ``TimestepEmbedder`` (slm/models/net.py:
486-522) is taken to keep DiT's layout, ``mlp.0`` (frequency -> hidden)
and ``mlp.2`` (hidden -> hidden) of an ``nn.Sequential`` with a SiLU
between; a file that names them otherwise is patched through
``key_overrides``.  The other names follow the public esm-3.0.4 module
tree, as the JAX package's tables do.
"""

from __future__ import annotations

import dataclasses
import re
import zipfile
from typing import Callable, Mapping, Optional

import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C

# canonical reference key -> the key a file carries; empty: every table
# follows the esm-3.0.4 naming
KEY_OVERRIDES: dict[str, str] = {}
# port parameters with no reference source, by module: they keep their
# initial values and the report lists them
NO_SOURCE = {"vqvae_decoder": ("pae_q.weight", "pae_q.bias", "pae_k.weight",
                               "pae_k.bias")}
SIGMA_PREFIX, NET_PREFIX = "sigma_embedder.", "net."

Rules = dict[str, str]


# ---------------------------------------------------------------------------
# loading and unwrapping
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """``torch.load`` + layout unwrap: a bare state dict, DeepSpeed's
    consolidated ``module``, or Lightning's ``state_dict``; the
    ``_forward_module.``, ``module.`` and ``model.`` key prefixes are
    dropped and every tensor becomes float32 on the CPU (a float32 file
    is memory-mapped, not copied)."""
    obj = torch.load(path, map_location="cpu", weights_only=False,
                     mmap=zipfile.is_zipfile(path))
    if isinstance(obj, dict) and isinstance(obj.get("module"), dict):
        obj = obj["module"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        if not hasattr(v, "detach"):
            continue
        k = re.sub(r"^(_forward_module\.)", "", k)
        k = re.sub(r"^(module\.)", "", k)
        k = re.sub(r"^(model\.)", "", k)
        out[k] = v.detach().float().cpu()
    return out


def strip_prefix(sd: dict, prefix: str) -> dict:
    """The entries under ``prefix``, with it removed; the others dropped."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def unwrap_net(sd: dict) -> dict:
    """The trunk's entries of an MDLM file (``net.*``), or ``sd`` itself
    when no key carries the prefix (a bare trunk)."""
    if any(k.startswith(NET_PREFIX) for k in sd):
        return strip_prefix(sd, NET_PREFIX)
    return sd


# ---------------------------------------------------------------------------
# rule tables: port parameter name -> reference key
# ---------------------------------------------------------------------------

_EMBED_RULES: Rules = {
    "encoder.sequence_embed.weight": "encoder.sequence_embedding.weight",
    "encoder.structure_tokens_embed.weight":
        "encoder.structure_tokens_embedding.weight",
    "encoder.ss8_embed.weight": "encoder.ss8_embedding.weight",
    "encoder.sasa_embed.weight": "encoder.sasa_embedding.weight",
    "encoder.average_plddt_proj.weight": "encoder.plddt_projection.weight",
    "encoder.per_res_plddt_proj.weight":
        "encoder.structure_per_res_plddt_projection.weight",
    "encoder.function_embed.weight": "encoder.function_embeddings.weight",
    "encoder.residue_embed.weight": "encoder.residue_embedding.weight",
}
TRUNK_HEADS = {"esm3": ("sequence_head", "structure_head", "ss8_head",
                        "sasa_head", "function_head", "residue_head"),
               "structure": ("structure_head", "sequence_head")}


def _block_rules(port: str, ref: str, geom: bool = False) -> Rules:
    """One transformer block (+ geometric attention)."""
    rules = {
        f"{port}.attn.ln.scale": f"{ref}.attn.layernorm_qkv.0.weight",
        f"{port}.attn.qkv.weight": f"{ref}.attn.layernorm_qkv.1.weight",
        f"{port}.attn.q_ln.scale": f"{ref}.attn.q_ln.weight",
        f"{port}.attn.k_ln.scale": f"{ref}.attn.k_ln.weight",
        f"{port}.attn.out.weight": f"{ref}.attn.out_proj.weight",
        f"{port}.ffn.ln.scale": f"{ref}.ffn.0.weight",
        f"{port}.ffn.up.weight": f"{ref}.ffn.1.weight",
        f"{port}.ffn.down.weight": f"{ref}.ffn.3.weight",
    }
    if geom:
        rules.update({
            f"{port}.geom_attn.ln.scale": f"{ref}.geom_attn.s_norm.weight",
            f"{port}.geom_attn.proj.weight": f"{ref}.geom_attn.proj.weight",
            f"{port}.geom_attn.out.weight": f"{ref}.geom_attn.out_proj.weight",
            f"{port}.geom_attn.distance_scale":
                f"{ref}.geom_attn.distance_scale_per_head",
            f"{port}.geom_attn.rotation_scale":
                f"{ref}.geom_attn.rotation_scale_per_head",
        })
    return rules


def _stack_rules(port: str, ref: str, n_layers: int,
                 n_layers_geom: int = 0) -> Rules:
    rules = {f"{port}.norm.scale": f"{ref}.norm.weight"}
    for i in range(n_layers):
        rules.update(_block_rules(f"{port}.blocks.{i}", f"{ref}.blocks.{i}",
                                  geom=i < n_layers_geom))
    return rules


def _regression_head_rules(port: str, ref: str) -> Rules:
    """Dense -> GELU -> LayerNorm -> Dense, ``nn.Sequential`` indices."""
    return {f"{port}.dense.weight": f"{ref}.0.weight",
            f"{port}.dense.bias": f"{ref}.0.bias",
            f"{port}.ln.scale": f"{ref}.2.weight",
            f"{port}.ln.bias": f"{ref}.2.bias",
            f"{port}.out.weight": f"{ref}.3.weight",
            f"{port}.out.bias": f"{ref}.3.bias"}


def trunk_rules(n_layers: int, n_layers_geom: int = 1,
                head_type: str = "esm3") -> Rules:
    """The ESM3 trunk (``models/esm3.py``)."""
    rules = dict(_EMBED_RULES)
    rules.update(_stack_rules("transformer", "transformer", n_layers,
                              n_layers_geom))
    for head in TRUNK_HEADS[head_type]:
        rules.update(_regression_head_rules(f"output_heads.{head}",
                                            f"output_heads.{head}"))
    return rules


def vqvae_decoder_rules(n_layers: int = 30) -> Rules:
    """StructureTokenDecoder: embed, stack, 6D-rotation head, pLDDT head
    (``pae_q``/``pae_k``: ``NO_SOURCE``)."""
    rules = {"embed.weight": "embed.weight",
             "affine_output_projection.ffn1.weight":
                 "affine_output_projection.ffn1.weight",
             "affine_output_projection.ffn1.bias":
                 "affine_output_projection.ffn1.bias",
             "affine_output_projection.ln.scale":
                 "affine_output_projection.norm.weight",
             "affine_output_projection.ln.bias":
                 "affine_output_projection.norm.bias",
             "affine_output_projection.proj.weight":
                 "affine_output_projection.proj.weight",
             "affine_output_projection.proj.bias":
                 "affine_output_projection.proj.bias"}
    rules.update(_stack_rules("decoder_stack", "decoder_stack", n_layers))
    rules.update(_regression_head_rules("plddt_head", "plddt_head"))
    return rules


def vqvae_encoder_rules(n_layers: int = 2) -> Rules:
    """StructureTokenEncoder: relative-position table, the stack (block 0
    geometric), pre-VQ projection, codebook."""
    rules = {"relative_position_embed.weight":
                 "relative_positional_embedding.embedding.weight",
             "pre_vq_proj.weight": "pre_vq_proj.weight",
             "pre_vq_proj.bias": "pre_vq_proj.bias",
             "codebook": "codebook.embeddings"}
    rules.update(_stack_rules("transformer", "transformer", n_layers, 1))
    return rules


def function_decoder_rules(n_layers: int = 3) -> Rules:
    """FunctionTokenDecoder (``models/function_decoder.py``): the
    depth-offset embedding, the stack, the InterPro and keyword heads
    (the ``ESM3_function_decoder_v0`` slot, reference net.py:27,350)."""
    rules = {"embed.weight": "embedding.weight"}
    rules.update(_stack_rules("decoder", "decoder", n_layers))
    rules.update(_regression_head_rules("interpro_head",
                                        "heads.interpro_logits"))
    rules.update(_regression_head_rules("keyword_head",
                                        "heads.keyword_logits"))
    return rules


def sigma_embedder_rules() -> Rules:
    """TimestepEmbedder, keys relative to ``sigma_embedder.`` (DiT's
    ``mlp.0``/``mlp.2``: an assumption, see the module docstring)."""
    return {"fc1.weight": "mlp.0.weight", "fc1.bias": "mlp.0.bias",
            "fc2.weight": "mlp.2.weight", "fc2.bias": "mlp.2.bias"}


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def merged_overrides(key_overrides=None) -> dict:
    """``key_overrides`` over the module-wide ``KEY_OVERRIDES``."""
    return {**KEY_OVERRIDES, **(key_overrides or {})}


_LAYER = re.compile(r"^(.*)\.blocks\.(\d+)\.")


@torch.no_grad()
def fill_module(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                rules: Rules, key_overrides: Optional[Mapping[str, str]] = None,
                value_transforms: Optional[Mapping[str, Callable]] = None,
                no_source=(), what: Optional[str] = None) -> dict:
    """Copy into ``module``'s parameters (each keeps its dtype and device)
    the tensors of ``state_dict`` that ``rules`` name, strictly (see the
    module docstring); nothing is copied unless every check passes.
    Returns the report: the count converted and the ``no_source``
    parameters left as they were."""
    what = what or type(module).__name__
    own = module.state_dict()
    overrides = merged_overrides(key_overrides)
    transforms = value_transforms or {}
    unmapped = sorted(n for n in own if n not in rules and n not in no_source)
    keys = {n: overrides.get(rules[n], rules[n]) for n in own if n in rules}
    missing = sorted(k for k in keys.values() if k not in state_dict)
    if unmapped or missing:
        raise KeyError(f"{what}: the checkpoint does not fill the port's "
                       f"module: {len(missing)} missing {missing[:8]}, "
                       f"{len(unmapped)} unmapped {unmapped[:8]}")
    # layers of the file's stacks past the module's depth
    layers = {m.group(0) for k in keys.values() if (m := _LAYER.match(k))}
    stacks = {layer.rsplit(".blocks.", 1)[0] for layer in layers}
    deeper = sorted({m.group(0) for k in state_dict
                     if (m := _LAYER.match(k)) and m.group(1) in stacks
                     and m.group(0) not in layers})
    if deeper:
        raise KeyError(f"{what}: the checkpoint has layers the port's module "
                       f"lacks: {deeper[:8]}")
    converted = {}
    for name, key in keys.items():
        value = torch.as_tensor(state_dict[key])
        if key in transforms:
            value = torch.as_tensor(transforms[key](value))
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{what}: {name} <- {key}: checkpoint shape "
                             f"{tuple(value.shape)} vs port "
                             f"{tuple(own[name].shape)}")
        converted[name] = value
    for name, value in converted.items():
        own[name].copy_(value)
    return {"converted": len(converted),
            "no_source": sorted(n for n in own if n in no_source)}


def convert_trunk(trunk, state_dict, key_overrides=None,
                  value_transforms=None) -> dict:
    """Fill an ``ESM3`` from a trunk state dict (``net.`` unwrapped);
    the rules follow the trunk's own config (depth, head type)."""
    cfg = trunk.cfg
    return fill_module(trunk, unwrap_net(state_dict),
                       trunk_rules(cfg.n_layers, cfg.n_layers_geom,
                                   cfg.head_type),
                       key_overrides, value_transforms, what="trunk")


def convert_vqvae_decoder(decoder, state_dict, key_overrides=None,
                          value_transforms=None) -> dict:
    return fill_module(decoder, unwrap_net(state_dict),
                       vqvae_decoder_rules(decoder.cfg.n_layers),
                       key_overrides, value_transforms,
                       no_source=NO_SOURCE["vqvae_decoder"],
                       what="VQ decoder")


def convert_vqvae_encoder(encoder, state_dict, key_overrides=None,
                          value_transforms=None) -> dict:
    return fill_module(encoder, unwrap_net(state_dict),
                       vqvae_encoder_rules(encoder.cfg.n_layers),
                       key_overrides, value_transforms, what="VQ encoder")


def convert_function_decoder(decoder, state_dict, key_overrides=None,
                             value_transforms=None) -> dict:
    return fill_module(decoder, unwrap_net(state_dict),
                       function_decoder_rules(decoder.cfg.n_layers),
                       key_overrides, value_transforms,
                       what="function decoder")


def has_sigma_embedder(state_dict, key_overrides=None) -> bool:
    """Whether an MDLM file carries any of the sigma embedder's keys."""
    overrides = merged_overrides(key_overrides)
    keys = {overrides.get(SIGMA_PREFIX + k, SIGMA_PREFIX + k)
            for k in sigma_embedder_rules().values()}
    return any(k in state_dict for k in keys)


def convert_sigma_embedder(sigma_embedder, state_dict,
                           key_overrides=None) -> dict:
    """Fill a ``TimestepEmbedder`` from an MDLM file's
    ``sigma_embedder.*`` (keys of ``state_dict`` as loaded, prefix
    included)."""
    rules = {k: SIGMA_PREFIX + v for k, v in sigma_embedder_rules().items()}
    return fill_module(sigma_embedder, state_dict, rules, key_overrides,
                       what="sigma embedder")


_BLOCK = re.compile(r"^transformer\.blocks\.(\d+)\.")
_GEOM_BLOCK = re.compile(r"^transformer\.blocks\.(\d+)\.geom_attn\.")


def trunk_width(state_dict, key_overrides=None) -> int:
    """d_model of a trunk state dict (``net.`` unwrapped): the width of
    its sequence embedding."""
    sd = unwrap_net(state_dict)
    key = _EMBED_RULES["encoder.sequence_embed.weight"]
    key = merged_overrides(key_overrides).get(key, key)
    if key not in sd:
        raise KeyError(f"the checkpoint has no {key}: not an ESM3 trunk")
    return int(sd[key].shape[1])


def infer_trunk_config(state_dict, base, key_overrides=None):
    """``base`` (an ``ESM3Config``) with every width a trunk state dict
    (``net.`` unwrapped) encodes: d_model (the sequence embedding), the
    depth (``transformer.blocks.N``), the geometric blocks and their
    v_heads (``geom_attn.distance_scale_per_head``), and the head: the
    rows of ``output_heads.structure_head.3.weight``, 4096 for the stock
    multi-track heads (``"esm3"``), else the fine-tune's structure head
    (``"structure"``, 4101 rows, plus a sequence head when the file has
    one).  ``base`` gives what no shape encodes (n_heads, dtype, the
    backends).  Raises KeyError on a file that is not an ESM3 trunk."""
    sd = unwrap_net(state_dict)
    overrides = merged_overrides(key_overrides)

    def rows(head):
        key = f"output_heads.{head}.3.weight"
        key = overrides.get(key, key)
        return None if key not in sd else int(sd[key].shape[0])

    blocks = {int(m.group(1)) for k in sd if (m := _BLOCK.match(k))}
    geom = {int(m.group(1)) for k in sd if (m := _GEOM_BLOCK.match(k))}
    n_structure = rows("structure_head")
    if not blocks or n_structure is None:
        raise KeyError("the checkpoint has no transformer.blocks.* or no "
                       "output_heads.structure_head.3.weight: not an ESM3 "
                       "trunk")
    kw = {"d_model": trunk_width(sd, key_overrides),
          "n_layers": max(blocks) + 1, "n_layers_geom": len(geom)}
    if geom:
        key = f"transformer.blocks.{min(geom)}.geom_attn." \
              "distance_scale_per_head"
        key = overrides.get(key, key)
        if key in sd:
            kw["v_heads"] = int(sd[key].shape[0])
    if n_structure == C.VQVAE_CODEBOOK_SIZE:
        return dataclasses.replace(base, head_type="esm3", **kw)
    return dataclasses.replace(base, head_type="structure",
                               n_structure_heads=n_structure,
                               n_sequence_heads=rows("sequence_head") or 0,
                               **kw)


@torch.no_grad()
def convert_mdlm(trunk, sigma_embedder, state_dict,
                 key_overrides=None) -> dict:
    """Fill a trunk and its sigma embedder from a reference MDLM file
    (``net.*`` and, in an ESMDiff release, ``sigma_embedder.*``) or a bare
    trunk, strictly.  A stock ESM3 file (the 4096-way multi-track heads)
    into a trunk with the fine-tune's structure heads fills all but the
    output heads, which keep their values and are reported: the reference
    fine-tunes ESM3 with new structure heads in place of the stock ones.
    The sigma embedder is filled when the file carries one, else left as
    it was.  Returns the trunk's report with ``"sigma"``: whether the file
    filled the sigma embedder."""
    trunk_sd = unwrap_net(state_dict)
    cfg = trunk.cfg
    if (cfg.head_type == "structure" and infer_trunk_config(
            trunk_sd, cfg, key_overrides).head_type == "esm3"):
        heads = [k for k in trunk.state_dict()
                 if k.startswith("output_heads.")]
        rules = {k: v for k, v in trunk_rules(
            cfg.n_layers, cfg.n_layers_geom, "esm3").items()
            if not k.startswith("output_heads.")}
        report = fill_module(trunk, trunk_sd, rules, key_overrides,
                             no_source=heads, what="trunk")
    else:
        report = convert_trunk(trunk, trunk_sd, key_overrides)
    report["sigma"] = has_sigma_embedder(state_dict, key_overrides)
    if report["sigma"]:
        convert_sigma_embedder(sigma_embedder, state_dict, key_overrides)
    return report


def export_reference_state_dict(params, rules: Rules) -> dict:
    """The inverse of conversion: {reference key: float32 CPU tensor} from
    a module or a state dict in the port's names (entries with no rule
    are left out)."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    return {rules[name]: torch.as_tensor(t).detach().float().cpu().clone()
            for name, t in sd.items() if name in rules}
