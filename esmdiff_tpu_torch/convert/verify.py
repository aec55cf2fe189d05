"""Per-layer activation diffs of a converted reference checkpoint:
port of ``esmdiff_tpu/convert/verify.py`` (``esmdiff-torch-verify``).

  - ``make_reference_*_state_dict`` synthesize state dicts whose keys and
    shapes follow the public esm-3.0.4 module tree (the trunk, the VQ
    decoder and encoder, the function decoder) or, for the AR nets, are an
    actual random HF T5 / GPT-2 state dict plus the reference's adapters.
    They are written independently of ``convert/torch_ckpt.py``'s tables,
    and for a seed they give the JAX package's arrays bit for bit.
  - Pure-torch oracles recompute each layer straight from the state
    dict's tensors (LN + QKV packing, QK-layernorm, rotary, SwiGLU,
    geometric attention, regression heads, the 6D-rotation head, DiT's
    timestep MLP); for the CLM and JLM the oracle is HF ``transformers``
    itself.  ``verify_*`` feed one probe through the oracle and through the
    port's modules filled by ``torch_ckpt`` (strictly: a missing key
    raises), in float32 on ``device`` with the plain attention path, and
    report each layer's max-abs and relative diff: a layout or permutation
    error in conversion explodes the diff at the layer it hits.

``key_overrides`` are applied by the conversion as ``load_runtime``
applies them; the oracle reads a canonical key from the file itself when
the file has it and through the override only when it does not (a
rename).  So an override that points a key the file does have at another
tensor (two layers swapped) shows as a diff at the layers it moves.

    esmdiff-torch-verify <ckpt.pt> [--component trunk] [--layers 0:4]
    esmdiff-torch-verify --fixture --scale tiny --device cpu  # self-check
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.clm import CLM, CLMConfig
from esmdiff_tpu_torch.models.esm3 import ESM3, ESM3Config, esm3_tiny
from esmdiff_tpu_torch.models.function_decoder import (FunctionDecoderConfig,
                                                       FunctionTokenDecoder)
from esmdiff_tpu_torch.models.jlm import JLM, JLMConfig
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder,
                                            StructureTokenEncoder,
                                            nearest_code)
from esmdiff_tpu_torch.nn.geometric import build_affine3d_from_coordinates
from esmdiff_tpu_torch.nn.layers import (MultiHeadAttention, TimestepEmbedder,
                                         swiglu_hidden_dim)
from esmdiff_tpu_torch.nn.rotary import rotary_tables

from . import torch_ckpt
from .checkpoints import convert_ar

PROBE_B, PROBE_L = 2, 16
TOL = 1e-3          # the CLI's gate on the worst relative diff


def _record_into(rows):
    """One row recorder for every report: max |port - oracle| and that
    over max |oracle|."""
    def record(name, port_out, oracle_out):
        a = torch.as_tensor(port_out).detach().float().cpu()
        b = torch.as_tensor(oracle_out).detach().float().cpu()
        d = float((a - b).abs().max())
        rows.append({"layer": name, "max_abs_diff": d,
                     "rel_diff": d / max(1e-12, float(b.abs().max()))})
    return record


def report(rows, label: str) -> float:
    """Print the rows and the verdict at ``TOL``; return the worst
    relative diff."""
    print(f"{'layer':<20} {'max_abs_diff':>14} {'rel_diff':>12}")
    worst = 0.0
    for r in rows:
        print(f"{r['layer']:<20} {r['max_abs_diff']:>14.3e} "
              f"{r['rel_diff']:>12.3e}")
        worst = max(worst, r["rel_diff"])
    print(f"[verify] {label}: {len(rows)} rows, worst rel diff {worst:.3e} "
          f"-> {'OK' if worst <= TOL else 'MISMATCH'}")
    return worst


# ---------------------------------------------------------------------------
# reference-layout fixtures (the public esm-3.0.4 module tree)
# ---------------------------------------------------------------------------

def _block_specs(p: str, d: int, h: int) -> dict:
    return {f"{p}.attn.layernorm_qkv.0.weight": (d,),
            f"{p}.attn.layernorm_qkv.1.weight": (3 * d, d),
            f"{p}.attn.q_ln.weight": (d,),
            f"{p}.attn.k_ln.weight": (d,),
            f"{p}.attn.out_proj.weight": (d, d),
            f"{p}.ffn.0.weight": (d,),
            f"{p}.ffn.1.weight": (2 * h, d),
            f"{p}.ffn.3.weight": (d, h)}


def _geom_specs(p: str, d: int, H: int) -> dict:
    return {f"{p}.geom_attn.s_norm.weight": (d,),
            f"{p}.geom_attn.proj.weight": (H * 15, d),
            f"{p}.geom_attn.out_proj.weight": (d, H * 3),
            f"{p}.geom_attn.distance_scale_per_head": (H,),
            f"{p}.geom_attn.rotation_scale_per_head": (H,)}


def _head_specs(p: str, d: int, out: int) -> dict:
    return {f"{p}.0.weight": (d, d), f"{p}.0.bias": (d,),
            f"{p}.2.weight": (d,), f"{p}.2.bias": (d,),
            f"{p}.3.weight": (out, d), f"{p}.3.bias": (out,)}


def _trunk_body_specs(cfg) -> dict:
    """Everything of the trunk but its output heads, in file order."""
    d, H = cfg.d_model, cfg.v_heads
    specs = {
        "encoder.sequence_embedding.weight": (C.SEQUENCE_EMBED_SIZE, d),
        "encoder.structure_tokens_embedding.weight":
            (C.STRUCTURE_VOCAB_SIZE, d),
        "encoder.ss8_embedding.weight": (C.SS8_VOCAB_SIZE, d),
        "encoder.sasa_embedding.weight": (C.SASA_VOCAB_SIZE, d),
        "encoder.plddt_projection.weight": (d, 16),
        "encoder.structure_per_res_plddt_projection.weight": (d, 16),
        "encoder.function_embeddings.weight":
            (C.FUNCTION_VOCAB_SIZE * C.FUNCTION_TOKEN_DEPTH,
             d // C.FUNCTION_TOKEN_DEPTH),
        "encoder.residue_embedding.weight":
            (C.RESIDUE_ANNOTATION_VOCAB_SIZE, d),
        "transformer.norm.weight": (d,),
    }
    for i in range(cfg.n_layers):
        p = f"transformer.blocks.{i}"
        specs.update(_block_specs(p, d, cfg.ffn_hidden))
        if i < cfg.n_layers_geom:
            specs.update(_geom_specs(p, d, H))
    return specs


def _trunk_head_specs(cfg) -> dict:
    d = cfg.d_model
    if cfg.head_type == "esm3":
        dims = {"sequence_head": 64, "structure_head": C.VQVAE_CODEBOOK_SIZE,
                "ss8_head": C.SS8_VOCAB_SIZE, "sasa_head": C.SASA_VOCAB_SIZE,
                "function_head":
                    C.FUNCTION_VOCAB_SIZE * C.FUNCTION_TOKEN_DEPTH,
                "residue_head": C.RESIDUE_ANNOTATION_VOCAB_SIZE}
    else:
        dims = {"structure_head": cfg.n_structure_heads}
        if cfg.n_sequence_heads:
            dims["sequence_head"] = cfg.n_sequence_heads
    specs = {}
    for name, out in dims.items():
        specs.update(_head_specs(f"output_heads.{name}", d, out))
    return specs


def _trunk_tensor_specs(cfg) -> dict:
    return {**_trunk_body_specs(cfg), **_trunk_head_specs(cfg)}


_UNIT_SUFFIXES = (".0.weight", "norm.weight", "q_ln.weight", "k_ln.weight",
                  "s_norm.weight", ".2.weight")


def _draw(rng, specs: dict, scale: float, unit_suffixes) -> dict:
    """Seeded values in spec order: 1-D scales near 1 (LayerNorm weights),
    everything else N(0, scale^2); float32 tensors."""
    sd = {}
    for name, shape in specs.items():
        if len(shape) == 1 and name.endswith(unit_suffixes):
            arr = 1.0 + rng.randn(*shape) * 0.02
        else:
            arr = rng.randn(*shape) * scale
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return sd


def make_reference_trunk_state_dict(cfg, seed: int = 0,
                                    scale: float = 0.05) -> dict:
    """Random state dict of an ESM3 trunk in the reference layout."""
    return make_reference_trunk_state_dicts([cfg], seed, scale)[0]


def make_reference_trunk_state_dicts(cfgs, seed: int = 0,
                                     scale: float = 0.05) -> list[dict]:
    """``make_reference_trunk_state_dict`` of each config of ``cfgs``,
    which differ in their heads only: the body, drawn first, is drawn
    once and shared (the same tensors), and each config's heads are drawn
    from the generator's state after it."""
    body = _trunk_body_specs(cfgs[0])
    if any(_trunk_body_specs(c) != body for c in cfgs[1:]):
        raise ValueError("the configs differ in more than their heads")
    rng = np.random.RandomState(seed)
    shared = _draw(rng, body, scale, _UNIT_SUFFIXES)
    state = rng.get_state()
    out = []
    for cfg in cfgs:
        rng.set_state(state)
        out.append({**shared, **_draw(rng, _trunk_head_specs(cfg), scale,
                                      _UNIT_SUFFIXES)})
    return out


def make_reference_sigma_embedder_state_dict(d_model: int, seed: int = 0,
                                             scale: float = 0.05,
                                             frequency_size: int = 256
                                             ) -> dict:
    """Random ``sigma_embedder`` of an ESMDiff release (DiT's ``mlp.0``,
    ``mlp.2``; keys without the ``sigma_embedder.`` prefix)."""
    rng = np.random.RandomState(seed)
    return _draw(rng, {"mlp.0.weight": (d_model, frequency_size),
                       "mlp.0.bias": (d_model,),
                       "mlp.2.weight": (d_model, d_model),
                       "mlp.2.bias": (d_model,)}, scale, ())


def release_checkpoint(trunk_sd: dict, sigma_sd: Optional[dict] = None
                       ) -> dict:
    """The object an ESMDiff release file holds: Lightning's
    ``state_dict`` of the MDLM module, ``net.*`` (the trunk) and
    ``sigma_embedder.*``."""
    sd = {torch_ckpt.NET_PREFIX + k: v for k, v in trunk_sd.items()}
    for k, v in (sigma_sd or {}).items():
        sd[torch_ckpt.SIGMA_PREFIX + k] = v
    return {"state_dict": sd, "epoch": 0}


def _decoder_tensor_specs(cfg) -> dict:
    d = cfg.d_model
    specs = {
        "embed.weight": (C.STRUCTURE_VOCAB_SIZE, d),
        "decoder_stack.norm.weight": (d,),
        "affine_output_projection.ffn1.weight": (d, d),
        "affine_output_projection.ffn1.bias": (d,),
        "affine_output_projection.norm.weight": (d,),
        "affine_output_projection.norm.bias": (d,),
        "affine_output_projection.proj.weight": (9, d),
        "affine_output_projection.proj.bias": (9,),
        **_head_specs("plddt_head", d, cfg.plddt_bins),
    }
    for i in range(cfg.n_layers):
        specs.update(_block_specs(f"decoder_stack.blocks.{i}", d,
                                  swiglu_hidden_dim(d)))
    return specs


def make_reference_decoder_state_dict(cfg, seed: int = 0,
                                      scale: float = 0.05) -> dict:
    """Random StructureTokenDecoder state dict in the reference layout."""
    return _draw(np.random.RandomState(seed), _decoder_tensor_specs(cfg),
                 scale, (".0.weight", "norm.weight", "q_ln.weight",
                         "k_ln.weight"))


def _encoder_tensor_specs(cfg) -> dict:
    d = cfg.d_model
    specs = {
        "relative_positional_embedding.embedding.weight":
            (2 * cfg.rel_pos_bins + 2, d),
        "pre_vq_proj.weight": (cfg.d_out, d),
        "pre_vq_proj.bias": (cfg.d_out,),
        "codebook.embeddings": (cfg.n_codes, cfg.d_out),
        "transformer.norm.weight": (d,),
    }
    for i in range(cfg.n_layers):
        p = f"transformer.blocks.{i}"
        specs.update(_block_specs(p, d, swiglu_hidden_dim(d)))
        if i == 0:  # the stack's one geometric block
            specs.update(_geom_specs(p, d, cfg.v_heads))
    return specs


def make_reference_encoder_state_dict(cfg, seed: int = 0,
                                      scale: float = 0.05) -> dict:
    """Random StructureTokenEncoder state dict in the reference layout."""
    return _draw(np.random.RandomState(seed), _encoder_tensor_specs(cfg),
                 scale, (".0.weight", "norm.weight", "q_ln.weight",
                         "k_ln.weight", "s_norm.weight"))


def _function_decoder_tensor_specs(cfg) -> dict:
    d = cfg.d_model
    specs = {"embedding.weight":
                 (cfg.function_token_depth * cfg.function_token_vocab, d),
             "decoder.norm.weight": (d,)}
    for i in range(cfg.n_layers):
        specs.update(_block_specs(f"decoder.blocks.{i}", d,
                                  swiglu_hidden_dim(d)))
    specs.update(_head_specs("heads.interpro_logits", d,
                             cfg.interpro_classes))
    specs.update(_head_specs("heads.keyword_logits", d, cfg.keyword_vocab))
    return specs


def make_reference_function_decoder_state_dict(cfg, seed: int = 0,
                                               scale: float = 0.05) -> dict:
    """Random FunctionTokenDecoder state dict in the reference layout."""
    return _draw(np.random.RandomState(seed),
                 _function_decoder_tensor_specs(cfg), scale,
                 (".0.weight", "norm.weight", "q_ln.weight", "k_ln.weight"))


def function_decoder_config(sd, base=None):
    """``FunctionDecoderConfig`` with the widths, depth and head sizes of a
    state dict (the head count is not in the shapes: ``base``'s)."""
    base = base or FunctionDecoderConfig()
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("decoder.blocks."))
    return dataclasses.replace(
        base, d_model=int(sd["decoder.norm.weight"].shape[0]),
        n_layers=n_layers,
        interpro_classes=int(sd["heads.interpro_logits.3.weight"].shape[0]),
        keyword_vocab=int(sd["heads.keyword_logits.3.weight"].shape[0]))


# ---------------------------------------------------------------------------
# torch oracles (layer math straight from the state dict)
# ---------------------------------------------------------------------------

def _getter(sd, device):
    return lambda k: torch.as_tensor(sd[k], dtype=torch.float32,
                                     device=device)


def _oracle_ln(x, weight, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight


def _oracle_rotary(x, base=10000.0):
    """x: (B, L, H, Dh); GPT-NeoX half rotation."""
    B, L, H, Dh = x.shape
    half = Dh // 2
    inv = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half))
    freqs = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb)[None, :, None, :]
    sin = torch.sin(emb)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _oracle_attn(t, prefix, x, n_heads):
    B, L, D = x.shape
    dh = D // n_heads
    h = _oracle_ln(x, t(f"{prefix}.attn.layernorm_qkv.0.weight"))
    q, k, v = (h @ t(f"{prefix}.attn.layernorm_qkv.1.weight").T).chunk(
        3, dim=-1)
    q = _oracle_rotary(_oracle_ln(q, t(f"{prefix}.attn.q_ln.weight"))
                       .reshape(B, L, n_heads, dh))
    k = _oracle_rotary(_oracle_ln(k, t(f"{prefix}.attn.k_ln.weight"))
                       .reshape(B, L, n_heads, dh))
    v = v.reshape(B, L, n_heads, dh)
    probs = torch.softmax(
        torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(dh), dim=-1)
    o = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, D)
    return o @ t(f"{prefix}.attn.out_proj.weight").T


def _oracle_ffn(t, prefix, x):
    a, b = (_oracle_ln(x, t(f"{prefix}.ffn.0.weight"))
            @ t(f"{prefix}.ffn.1.weight").T).chunk(2, dim=-1)
    return (F.silu(a) * b) @ t(f"{prefix}.ffn.3.weight").T


def oracle_block(sd, prefix: str, x, n_heads: int, scale: float):
    """One pre-norm block (attention + SwiGLU), full length, no mask: esm's
    UnifiedTransformerBlock."""
    t = _getter(sd, x.device)
    x = x + _oracle_attn(t, prefix, x, n_heads) / scale
    return x + _oracle_ffn(t, prefix, x) / scale


def oracle_geom_attn(sd, prefix: str, x, rot, trans, affine_mask,
                     v_heads: int):
    """Geometric attention with the per-head [qr|kr|qd|kd|val] packing
    (a checkpoint packed otherwise is un-permuted by value_transforms)."""
    t = _getter(sd, x.device)
    B, L, D = x.shape
    H = v_heads
    ns = _oracle_ln(x, t(f"{prefix}.geom_attn.s_norm.weight"))
    proj = (ns @ t(f"{prefix}.geom_attn.proj.weight").T).reshape(B, L, H, 15)
    qr, kr, qd, kd, val = torch.split(proj, [3, 3, 3, 3, 3], dim=-1)

    def _r(vv):
        return torch.einsum("blij,blhj->blhi", rot, vv)

    qr_g, kr_g, val_g = _r(qr), _r(kr), _r(val)
    qd_g = _r(qd) + trans[:, :, None]
    kd_g = _r(kd) + trans[:, :, None]
    rs = F.softplus(t(f"{prefix}.geom_attn.rotation_scale_per_head"))
    ds = F.softplus(t(f"{prefix}.geom_attn.distance_scale_per_head"))
    rot_term = torch.einsum("blhc,bmhc->bhlm", qr_g, kr_g) / math.sqrt(3.0)
    diff = qd_g[:, :, None] - kd_g[:, None, :]          # (B, L, L, H, 3)
    dist = torch.sqrt((diff * diff).sum(-1).clamp_min(1e-8)).permute(
        0, 3, 1, 2)
    logits = rot_term * rs[None, :, None, None] \
        - dist * ds[None, :, None, None]
    logits = logits.masked_fill(~affine_mask[:, None, None, :], -1e9)
    o_g = torch.einsum("bhlm,bmhc->blhc", torch.softmax(logits, dim=-1),
                       val_g)
    o_local = torch.einsum("blji,blhj->blhi", rot, o_g).reshape(B, L, H * 3)
    out = o_local @ t(f"{prefix}.geom_attn.out_proj.weight").T
    return out * affine_mask[..., None]


def oracle_block_with_geom(sd, prefix: str, x, n_heads: int, v_heads: int,
                           scale: float, rot, trans, mask):
    """The geometric block: attention, geometric attention, SwiGLU."""
    t = _getter(sd, x.device)
    x = x + _oracle_attn(t, prefix, x, n_heads) / scale
    x = x + oracle_geom_attn(sd, prefix, x, rot, trans, mask, v_heads) / scale
    return x + _oracle_ffn(t, prefix, x) / scale


def oracle_regression_head(sd, prefix: str, x):
    t = _getter(sd, x.device)
    h = F.gelu(x @ t(f"{prefix}.0.weight").T + t(f"{prefix}.0.bias"))
    h = _oracle_ln(h, t(f"{prefix}.2.weight")) + t(f"{prefix}.2.bias")
    return h @ t(f"{prefix}.3.weight").T + t(f"{prefix}.3.bias")


def oracle_dim6rot_head(sd, prefix: str, x, trans_scale: float):
    t = _getter(sd, x.device)
    h = F.gelu(x @ t(f"{prefix}.ffn1.weight").T + t(f"{prefix}.ffn1.bias"))
    h = _oracle_ln(h, t(f"{prefix}.norm.weight")) + t(f"{prefix}.norm.bias")
    p = h @ t(f"{prefix}.proj.weight").T + t(f"{prefix}.proj.bias")
    v1, v2, trans = p[..., 0:3], p[..., 3:6], p[..., 6:9]
    e1 = v1 / v1.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    u2 = v2 - e1 * (e1 * v2).sum(-1, keepdim=True)
    e2 = u2 / u2.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    rot = torch.stack([e1, e2, torch.cross(e1, e2, dim=-1)], dim=-1)
    ideal = torch.as_tensor(np.stack(
        [rc.IDEALIZED_N, rc.IDEALIZED_CA, rc.IDEALIZED_C]),
        dtype=torch.float32, device=x.device)
    return torch.einsum("...ij,aj->...ai", rot, ideal) \
        + (trans * trans_scale)[..., None, :]


def oracle_sigma_embedder(sd, t_values, frequency_size: int = 256,
                          max_period: float = 10000.0):
    """DiT's TimestepEmbedder: [cos | sin] of t * exp(-ln(P) k / half),
    then Linear, SiLU, Linear (keys ``mlp.0``/``mlp.2``)."""
    t = _getter(sd, t_values.device)
    half = frequency_size // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t_values.device) / half)
    args = t_values.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    h = F.silu(emb @ t("mlp.0.weight").T + t("mlp.0.bias"))
    return h @ t("mlp.2.weight").T + t("mlp.2.bias")


_TIED = ((C.SEQUENCE_BOS_TOKEN, C.STRUCTURE_BOS_TOKEN),
         (C.SEQUENCE_PAD_TOKEN, C.STRUCTURE_PAD_TOKEN),
         (C.SEQUENCE_EOS_TOKEN, C.STRUCTURE_EOS_TOKEN),
         (C.SEQUENCE_CHAINBREAK_TOKEN, C.STRUCTURE_CHAINBREAK_TOKEN))


def oracle_trunk_logits(sd, cfg, sequence_tokens):
    """Structure logits of the trunk's float32 forward on ``sequence_tokens``
    (B, L) alone, every other track at its default (structure masked but
    for the specials tied to the sequence's, pLDDT 1 on average and 0 per
    residue, pads elsewhere), every position attending to every other:
    esm's EncodeInputs, the blocks (geometric attention skipped without
    coordinates), the final norm and the structure head."""
    dev = sequence_tokens.device
    t = _getter(sd, dev)
    seq = sequence_tokens.long()
    st = torch.full_like(seq, C.STRUCTURE_MASK_TOKEN)
    for s_tok, st_tok in _TIED:
        st = torch.where(seq == s_tok, st_tok, st)

    def rbf(v):  # a constant track: v everywhere
        centers = torch.linspace(0.0, 1.0, 16, device=dev)
        return torch.exp(-((v - centers) * 16.0) ** 2)

    D = cfg.d_model
    fn_rows = (C.INTERPRO_PAD_TOKEN + C.FUNCTION_VOCAB_SIZE * torch.arange(
        C.FUNCTION_TOKEN_DEPTH, device=dev))
    const = (rbf(1.0) @ t("encoder.plddt_projection.weight").T
             + rbf(0.0) @ t(
                 "encoder.structure_per_res_plddt_projection.weight").T
             + t("encoder.ss8_embedding.weight")[C.SS8_PAD_TOKEN]
             + t("encoder.sasa_embedding.weight")[C.SASA_PAD_TOKEN]
             + t("encoder.function_embeddings.weight")[fn_rows].reshape(D))
    x = (t("encoder.sequence_embedding.weight")[seq]
         + t("encoder.structure_tokens_embedding.weight")[st] + const)
    scale = cfg.residue_scaling_factor
    for i in range(cfg.n_layers):
        x = oracle_block(sd, f"transformer.blocks.{i}", x, cfg.n_heads, scale)
    x = _oracle_ln(x, t("transformer.norm.weight"))
    return oracle_regression_head(sd, "output_heads.structure_head", x)


# ---------------------------------------------------------------------------
# verification entry points
# ---------------------------------------------------------------------------

def _canonical(state_dict, specs, key_overrides=None, value_transforms=None):
    """The oracle's view: each canonical key read from the file itself,
    or, where the file lacks it, from the key ``key_overrides`` renames it
    to; ``value_transforms`` applied to what is read."""
    overrides = torch_ckpt.merged_overrides(key_overrides)
    transforms = value_transforms or {}
    canon = {}
    for name in specs:
        src = name if name in state_dict else overrides.get(name, name)
        if src not in state_dict:
            raise KeyError(f"the checkpoint has no {name} (nor an override "
                           "for it)")
        value = state_dict[src]
        canon[name] = transforms[src](value) if src in transforms else value
    return canon


def _plain_attention(module):
    """Point every attention of ``module`` at the plain path (float32
    probes: the kernels take bf16)."""
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_backend = "xla"
    return module


def _probe(rng, *shape, device):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                           device=device)


def _verify_blocks(record, blocks, sd, prefix: str, label: str, x,
                   n_heads: int, v_heads: int, scale: float, rot_cos,
                   rot_sin, affine=None, affine_mask=None, n_geom: int = 0):
    """Record each (layer index, block) of ``blocks`` against its oracle;
    the first ``n_geom`` layers own geometric attention."""
    for i, block in blocks:
        p = f"{prefix}.blocks.{i}"
        if i < n_geom:
            record(f"{label}{i}(geom)",
                   block(x, rot_cos, rot_sin, affine=affine,
                         affine_mask=affine_mask),
                   oracle_block_with_geom(sd, p, x, n_heads, v_heads, scale,
                                          affine.rot, affine.trans,
                                          affine_mask))
        else:
            record(f"{label}{i}", block(x, rot_cos, rot_sin),
                   oracle_block(sd, p, x, n_heads, scale))


@torch.no_grad()
def verify_trunk(state_dict: dict, cfg=None, layers: Optional[slice] = None,
                 key_overrides=None, value_transforms=None,
                 probe_seed: int = 7, device=None) -> list[dict]:
    """Fill an ESM3 trunk from ``state_dict`` (``net.`` unwrapped; at
    ``cfg``, by default the file's geometry with ESM3-open-small's head
    count, ``infer_trunk_config``) and diff each block, the final norm
    and every output head against the oracle on a fixed probe; an MDLM
    file's ``sigma_embedder.*`` too.
    Returns rows {layer, max_abs_diff, rel_diff}."""
    dev = resolve_device(device)
    trunk_sd = torch_ckpt.unwrap_net(state_dict)
    if cfg is None:
        cfg = torch_ckpt.infer_trunk_config(trunk_sd, ESM3Config(),
                                            key_overrides)
    # float32 throughout, plain attention: the diff shows layout, not bf16
    cfg = dataclasses.replace(cfg, dtype="float32", attn_backend="xla",
                              qkv_backend="xla", quant="none", remat=False)
    with torch.device(dev):
        trunk = ESM3(cfg).eval()
    torch_ckpt.convert_trunk(trunk, trunk_sd, key_overrides,
                             value_transforms)
    canon = _canonical(trunk_sd, _trunk_tensor_specs(cfg), key_overrides,
                       value_transforms)

    rng = np.random.RandomState(probe_seed)
    x = _probe(rng, PROBE_B, PROBE_L, cfg.d_model, device=dev)
    rot_cos, rot_sin = rotary_tables(PROBE_L, cfg.d_model // cfg.n_heads,
                                     device=dev)
    bb = _probe(rng, PROBE_B, PROBE_L, 3, 3, device=dev) * 3.0
    affine, affine_mask = build_affine3d_from_coordinates(bb)
    idx = range(cfg.n_layers)
    idx = idx if layers is None else idx[layers]
    rows: list[dict] = []
    record = _record_into(rows)
    blocks = trunk.transformer.blocks
    _verify_blocks(record, [(i, blocks[i]) for i in idx], canon,
                   "transformer", "block", x, cfg.n_heads, cfg.v_heads,
                   cfg.residue_scaling_factor, rot_cos, rot_sin, affine,
                   affine_mask, n_geom=cfg.n_layers_geom)
    record("final_norm", trunk.transformer.norm(x),
           _oracle_ln(x, canon["transformer.norm.weight"].to(dev)))
    for name, head in trunk.output_heads.named_children():
        if head is not None:
            record(name, head(x), oracle_regression_head(
                canon, f"output_heads.{name}", x))
    if torch_ckpt.has_sigma_embedder(state_dict, key_overrides):
        with torch.device(dev):
            sig = TimestepEmbedder(cfg.d_model, dtype=torch.float32)
        torch_ckpt.convert_sigma_embedder(sig, state_dict, key_overrides)
        sig_sd = torch_ckpt.strip_prefix(_canonical(
            state_dict, [torch_ckpt.SIGMA_PREFIX + k for k in
                         torch_ckpt.sigma_embedder_rules().values()],
            key_overrides), torch_ckpt.SIGMA_PREFIX)
        sigma = torch.as_tensor(rng.rand(PROBE_B * 4).astype(np.float32),
                                device=dev) * 10.0
        record("sigma_embedder", sig(sigma), oracle_sigma_embedder(sig_sd,
                                                                   sigma))
    return rows


@torch.no_grad()
def verify_vqvae_decoder(state_dict: dict, cfg=None, key_overrides=None,
                         value_transforms=None, probe_seed: int = 7,
                         device=None) -> list[dict]:
    """Per-layer diff of a filled StructureTokenDecoder: every block, the
    6D-rotation head and the pLDDT head."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or DecoderConfig(), dtype="float32",
                              quant="none", remat=False)
    with torch.device(dev):
        dec = _plain_attention(StructureTokenDecoder(cfg).eval())
    torch_ckpt.convert_vqvae_decoder(dec, state_dict, key_overrides,
                                     value_transforms)
    canon = _canonical(state_dict, _decoder_tensor_specs(cfg), key_overrides,
                       value_transforms)
    rng = np.random.RandomState(probe_seed)
    x = _probe(rng, PROBE_B, PROBE_L, cfg.d_model, device=dev)
    rot_cos, rot_sin = rotary_tables(PROBE_L, cfg.d_model // cfg.n_heads,
                                     device=dev)
    rows: list[dict] = []
    record = _record_into(rows)
    _verify_blocks(record, enumerate(dec.decoder_stack.blocks), canon,
                   "decoder_stack", "dec_block", x, cfg.n_heads, 0,
                   cfg.stack_config().residue_scaling_factor, rot_cos,
                   rot_sin)
    record("dim6rot_head", dec.affine_output_projection(x),
           oracle_dim6rot_head(canon, "affine_output_projection", x,
                               cfg.trans_scale))
    record("plddt_head", dec.plddt_head(x),
           oracle_regression_head(canon, "plddt_head", x))
    return rows


@torch.no_grad()
def verify_vqvae_encoder(state_dict: dict, cfg=None, key_overrides=None,
                         value_transforms=None, probe_seed: int = 7,
                         device=None) -> list[dict]:
    """Per-layer diff of a filled StructureTokenEncoder: the
    relative-position table, each block (block 0 geometric), the final
    norm, the pre-VQ projection, the codebook's distances and argmin."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or EncoderConfig(), dtype="float32")
    with torch.device(dev):
        enc = StructureTokenEncoder(cfg).eval()
    torch_ckpt.convert_vqvae_encoder(enc, state_dict, key_overrides,
                                     value_transforms)
    canon = _canonical(state_dict, _encoder_tensor_specs(cfg), key_overrides,
                       value_transforms)
    stack = cfg.stack_config()
    rng = np.random.RandomState(probe_seed)
    rot_cos, rot_sin = rotary_tables(PROBE_L, cfg.d_model // cfg.n_heads,
                                     device=dev)
    rows: list[dict] = []
    record = _record_into(rows)
    ids = torch.as_tensor(rng.randint(0, 2 * cfg.rel_pos_bins + 2,
                                      (PROBE_B, PROBE_L)), device=dev)
    record("relpos_embed", enc.relative_position_embed(ids),
           canon["relative_positional_embedding.embedding.weight"].to(dev)[
               ids])
    x = _probe(rng, PROBE_B, PROBE_L, cfg.d_model, device=dev)
    bb = _probe(rng, PROBE_B, PROBE_L, 3, 3, device=dev) * 3.0
    affine, affine_mask = build_affine3d_from_coordinates(bb)
    _verify_blocks(record, enumerate(enc.transformer.blocks), canon,
                   "transformer", "enc_block", x, cfg.n_heads, cfg.v_heads,
                   stack.residue_scaling_factor, rot_cos, rot_sin, affine,
                   affine_mask, n_geom=1)
    record("final_norm", enc.transformer.norm(x),
           _oracle_ln(x, canon["transformer.norm.weight"].to(dev)))
    t = _getter(canon, dev)
    record("pre_vq_proj", enc.pre_vq_proj(x),
           x @ t("pre_vq_proj.weight").T + t("pre_vq_proj.bias"))
    z = _probe(rng, PROBE_B, PROBE_L, cfg.d_out, device=dev)
    cb, cb_ref = enc.codebook.float(), t("codebook.embeddings")

    def d2(c):
        return (z * z).sum(-1, keepdim=True) - 2.0 * z @ c.T \
            + (c * c).sum(-1)

    record("codebook_d2", d2(cb), d2(cb_ref))
    agree = float((nearest_code(z, cb) == d2(cb_ref).argmin(-1)).float()
                  .mean())
    rows.append({"layer": "codebook_argmin", "max_abs_diff": 1.0 - agree,
                 "rel_diff": 1.0 - agree})
    return rows


@torch.no_grad()
def verify_function_decoder(state_dict: dict, cfg=None, key_overrides=None,
                            value_transforms=None, probe_seed: int = 7,
                            device=None) -> list[dict]:
    """Per-layer diff of a filled FunctionTokenDecoder: the depth-offset
    embedding, each block, the final norm, both heads on a pooled probe."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or FunctionDecoderConfig(), dtype="float32")
    with torch.device(dev):
        dec = FunctionTokenDecoder(cfg).eval()
    torch_ckpt.convert_function_decoder(dec, state_dict, key_overrides,
                                        value_transforms)
    canon = _canonical(state_dict, _function_decoder_tensor_specs(cfg),
                       key_overrides, value_transforms)
    D = cfg.function_token_depth
    rng = np.random.RandomState(probe_seed)
    rot_cos, rot_sin = rotary_tables(D, cfg.d_model // cfg.n_heads,
                                     device=dev)
    rows: list[dict] = []
    record = _record_into(rows)
    toks = rng.randint(0, cfg.function_token_vocab, (PROBE_B, D))
    flat = torch.as_tensor(toks + np.arange(D) * cfg.function_token_vocab,
                           device=dev)
    record("fn_embed", dec.embed(flat),
           canon["embedding.weight"].to(dev)[flat])
    x = _probe(rng, PROBE_B, D, cfg.d_model, device=dev)
    _verify_blocks(record, enumerate(dec.decoder.blocks), canon, "decoder",
                   "fn_block", x, cfg.n_heads, 0,
                   cfg.stack_config().residue_scaling_factor, rot_cos,
                   rot_sin)
    record("final_norm", dec.decoder.norm(x),
           _oracle_ln(x, canon["decoder.norm.weight"].to(dev)))
    pooled = x.mean(dim=-2)
    for name, ref in (("interpro_head", "heads.interpro_logits"),
                      ("keyword_head", "heads.keyword_logits")):
        record(name, getattr(dec, name)(pooled),
               oracle_regression_head(canon, ref, pooled))
    return rows


# ---------------------------------------------------------------------------
# CLM / JLM: the oracle is HF transformers' T5 / GPT-2
# ---------------------------------------------------------------------------

def _hf_t5(cfg):
    from transformers import T5Config, T5ForConditionalGeneration

    return T5ForConditionalGeneration(T5Config(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        d_kv=cfg.d_model // cfg.n_heads, d_ff=cfg.d_ff,
        num_layers=cfg.n_layers, num_heads=cfg.n_heads,
        relative_attention_num_buckets=cfg.rel_pos_buckets,
        relative_attention_max_distance=cfg.rel_pos_max_distance,
        dropout_rate=0.0, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False, pad_token_id=cfg.pad_token_id,
        decoder_start_token_id=cfg.decoder_start_token_id))


def _hf_gpt2(cfg):
    from transformers import GPT2Config, GPT2Model

    return GPT2Model(GPT2Config(
        vocab_size=8, n_positions=cfg.n_positions, n_embd=cfg.n_embd,
        n_layer=cfg.n_layers, n_head=cfg.n_heads, resid_pdrop=0.0,
        embd_pdrop=0.0, attn_pdrop=0.0, activation_function="gelu_new"))


def infer_clm_config(sd):
    """CLMConfig from a CustomedT5-layout state dict's shapes."""
    V, d = sd["decoder.embed_tokens.weight"].shape
    d_ff = sd["decoder.block.0.layer.2.DenseReluDense.wi_0.weight"].shape[0]
    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("decoder.block."))
    buckets, H = sd["decoder.block.0.layer.0.SelfAttention."
                    "relative_attention_bias.weight"].shape
    inner = sd["decoder.block.0.layer.0.SelfAttention.q.weight"].shape[0]
    if inner != d:
        raise ValueError(f"T5 inner dim {inner} != d_model {d} "
                         "(non-standard d_kv is not modeled)")
    return CLMConfig(vocab_size=int(V), d_model=int(d), d_ff=int(d_ff),
                     n_layers=int(n_layers), n_heads=int(H),
                     rel_pos_buckets=int(buckets),
                     cond_dim=int(sd["adapation_layer.weight"].shape[1]),
                     dtype="float32")


def make_reference_clm_state_dict(cfg, seed: int = 0) -> dict:
    """An actual random HF T5 state dict plus the CustomedT5 adapter (the
    keys and shapes come from transformers itself)."""
    torch.manual_seed(seed)
    sd = {k: v.detach() for k, v in _hf_t5(cfg).state_dict().items()}
    sd["adapation_layer.weight"] = torch.randn(cfg.d_model, cfg.cond_dim) * 0.1
    return sd


def infer_jlm_config(sd, n_heads=None):
    """JLMConfig from a CustomedGPT2-layout state dict's shapes; a GPT-2
    state dict does not encode the head count (``n_heads``, else the
    config's default)."""
    n_pos, d = sd["wpe.weight"].shape
    kw = dict(
        n_embd=int(d), n_positions=int(n_pos),
        n_layers=1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("h.")),
        struct_embed_dim=int(sd["structure_embed_tokens.weight"].shape[1]),
        cond_dim=int(sd["sequence_adapation_layer.weight"].shape[1]),
        seq_vocab=int(sd["sequence_head.weight"].shape[0]),
        struct_vocab=int(sd["structure_head.weight"].shape[0]),
        sep_strategy="position" if "sep_token" in sd else "sentence",
        dtype="float32")
    if n_heads is not None:
        kw["n_heads"] = int(n_heads)
    return JLMConfig(**kw)


def make_reference_jlm_state_dict(cfg, seed: int = 0) -> dict:
    """An actual random HF GPT2Model state dict plus the CustomedGPT2
    adapters, heads and separator."""
    torch.manual_seed(seed)
    sd = {k: v.detach() for k, v in _hf_gpt2(cfg).state_dict().items()}
    sd.update({
        "structure_embed_tokens.weight":
            torch.randn(cfg.struct_vocab, cfg.struct_embed_dim) * 0.1,
        "sequence_adapation_layer.weight":
            torch.randn(cfg.n_embd, cfg.cond_dim) * 0.1,
        "structure_adapation_layer.weight":
            torch.randn(cfg.n_embd, cfg.struct_embed_dim) * 0.1,
        "sequence_head.weight": torch.randn(cfg.seq_vocab, cfg.n_embd) * 0.1,
        "structure_head.weight":
            torch.randn(cfg.struct_vocab, cfg.n_embd) * 0.1,
    })
    if cfg.sep_strategy == "position":
        sd["sep_token"] = torch.randn(cfg.n_embd)
    return sd


@torch.no_grad()
def verify_clm(state_dict: dict, cfg=None, probe_seed: int = 7,
               device=None) -> list[dict]:
    """Fill the port's CLM from a CustomedT5 state dict and diff the
    encoder output, the logits and the loss against HF's T5."""
    dev = resolve_device(device)
    cfg = cfg or infer_clm_config(state_dict)
    with torch.device(dev):
        model = CLM(cfg).eval()
    convert_ar(model, state_dict)
    hf = _hf_t5(cfg).eval().to(dev)
    hf.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                        if k != "adapation_layer.weight"}, strict=False)
    B, L, LS = 2, 6, 7
    rng = np.random.RandomState(probe_seed)
    emb = _probe(rng, B, L, cfg.cond_dim, device=dev)
    labels = torch.as_tensor(rng.randint(0, min(4096, cfg.vocab_size),
                                         (B, LS)), device=dev)
    enc_in = emb @ torch.as_tensor(state_dict["adapation_layer.weight"],
                                   device=dev).T
    out_t = hf(inputs_embeds=enc_in, labels=labels)
    out = model(emb, labels)
    rows: list[dict] = []
    record = _record_into(rows)
    record("encoder", model.encode(emb),
           hf.encoder(inputs_embeds=enc_in).last_hidden_state)
    record("logits", out["logits"], out_t.logits)
    record("loss", out["loss"], out_t.loss)
    return rows


@torch.no_grad()
def verify_jlm(state_dict: dict, cfg=None, n_heads=None,
               probe_seed: int = 7, device=None) -> list[dict]:
    """Fill the port's JLM from a CustomedGPT2 state dict and diff both
    heads' logits against HF's GPT-2 (a head count that differs from the
    training config's cannot show here: both sides take the same)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = infer_jlm_config(state_dict, n_heads=n_heads)
        if n_heads is None:
            print(f"[verify] GPT-2 state dicts do not encode the head count; "
                  f"assuming n_heads={cfg.n_heads} (--heads to set it)")
    with torch.device(dev):
        model = JLM(cfg).eval()
    convert_ar(model, state_dict)
    gpt = _hf_gpt2(cfg).eval().to(dev)
    gpt.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()
                         if k.startswith(("h.", "wte", "wpe", "ln_f"))},
                        strict=False)
    t = _getter(state_dict, dev)
    B, L, LS = 2, 5, 6
    rng = np.random.RandomState(probe_seed)
    emb = _probe(rng, B, L, cfg.cond_dim, device=dev)
    st = torch.as_tensor(rng.randint(0, min(4096, cfg.struct_vocab),
                                     (B, LS)), device=dev)
    seq_part = emb @ t("sequence_adapation_layer.weight").T
    str_part = t("structure_embed_tokens.weight")[st] \
        @ t("structure_adapation_layer.weight").T
    if cfg.sep_strategy == "sentence":
        types = torch.cat([torch.zeros(B, L), torch.ones(B, LS)],
                          dim=1).long().to(dev)
        pos = torch.arange(L + LS, device=dev)[None].expand(B, -1)
        h = gpt(inputs_embeds=torch.cat([seq_part, str_part], dim=1),
                position_ids=pos, token_type_ids=types).last_hidden_state
        off = 0
    else:
        sep = t("sep_token")[None, None].expand(B, 1, cfg.n_embd)
        pos = torch.cat([torch.arange(L), torch.zeros(1).long(),
                         torch.arange(LS)]).to(dev)[None].expand(B, -1)
        h = gpt(inputs_embeds=torch.cat([seq_part, sep, str_part], dim=1),
                position_ids=pos).last_hidden_state
        off = 1
    out = model(emb, st)
    rows: list[dict] = []
    record = _record_into(rows)
    record("sequence_logits", out["sequence_logits"],
           h[:, :L] @ t("sequence_head.weight").T)
    record("structure_logits", out["structure_logits"],
           h[:, L + off:] @ t("structure_head.weight").T)
    return rows


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def fixture_configs(scale: str):
    """{component: config} at ``scale`` ("full": the reference geometry;
    "tiny": test widths), the JAX CLI's."""
    if scale == "tiny":
        return {"trunk": esm3_tiny(),
                "vqvae_encoder": EncoderConfig(d_model=64, n_heads=2,
                                               v_heads=8, n_layers=2,
                                               d_out=16, knn=8),
                "vqvae_decoder": DecoderConfig(d_model=64, n_heads=4,
                                               n_layers=3),
                "function_decoder": FunctionDecoderConfig(
                    d_model=64, n_heads=4, n_layers=2, interpro_classes=37,
                    keyword_vocab=53),
                "clm": CLMConfig(d_model=32, d_ff=64, n_layers=2, n_heads=4,
                                 cond_dim=48, dtype="float32"),
                "jlm": JLMConfig(n_embd=32, n_layers=2, n_heads=4,
                                 n_positions=64, cond_dim=48,
                                 struct_embed_dim=24, seq_vocab=33,
                                 dtype="float32")}
    return {"trunk": ESM3Config(), "vqvae_encoder": EncoderConfig(),
            "vqvae_decoder": DecoderConfig(),
            "function_decoder": FunctionDecoderConfig(),
            "clm": CLMConfig(dtype="float32"),
            "jlm": JLMConfig(dtype="float32")}


MAKERS = {"trunk": make_reference_trunk_state_dict,
          "vqvae_encoder": make_reference_encoder_state_dict,
          "vqvae_decoder": make_reference_decoder_state_dict,
          "function_decoder": make_reference_function_decoder_state_dict,
          "clm": make_reference_clm_state_dict,
          "jlm": make_reference_jlm_state_dict}


def run(component: str, sd: dict, cfg=None, layers=None, heads=None,
        device=None) -> list[dict]:
    """``verify_<component>`` of ``sd``; a file's config is read from its
    shapes where they give it (the trunk's head type; the function
    decoder's widths; the AR nets)."""
    if component == "trunk":
        return verify_trunk(sd, cfg, layers=layers, device=device)
    if component == "vqvae_decoder":
        return verify_vqvae_decoder(sd, cfg, device=device)
    if component == "vqvae_encoder":
        return verify_vqvae_encoder(sd, cfg, device=device)
    if component == "function_decoder":
        return verify_function_decoder(sd, function_decoder_config(sd, cfg),
                                       device=device)
    if component == "clm":
        return verify_clm(torch_ckpt.unwrap_net(sd), cfg, device=device)
    return verify_jlm(torch_ckpt.unwrap_net(sd), cfg, n_heads=heads,
                      device=device)


def check(argv=None) -> list[dict]:
    """The CLI's work: verify a file (or a fixture), print the report and
    return its rows; raises SystemExit above ``--tol``."""
    p = argparse.ArgumentParser(
        description="Per-layer diff of a converted reference checkpoint "
                    "against pure-torch oracles (PyTorch port).")
    p.add_argument("ckpt", nargs="?", default=None,
                   help="reference checkpoint (.pt/.ckpt); omit with "
                        "--fixture")
    p.add_argument("--fixture", action="store_true",
                   help="Verify a seeded reference-layout state dict (a "
                        "self-check of the tables and the oracles).")
    p.add_argument("--scale", type=str, default="full",
                   choices=["full", "tiny"],
                   help="Geometry of the fixture; for a file, its trunk's "
                        "head count (the other widths are the file's) and "
                        "the VQ-VAE's and function decoder's.")
    p.add_argument("--layers", type=str, default=None,
                   help="Trunk layer slice, e.g. 0:4")
    p.add_argument("--component", type=str, default="trunk",
                   choices=list(MAKERS))
    p.add_argument("--heads", type=int, default=None,
                   help="jlm: GPT-2 head count (not encoded in state dicts).")
    p.add_argument("--tol", type=float, default=TOL,
                   help="Exit with an error above this worst relative "
                        "diff.")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if not args.fixture and not args.ckpt:
        p.error("give a checkpoint or --fixture")
    cfg = fixture_configs(args.scale)[args.component]
    if args.fixture:
        sd = MAKERS[args.component](cfg)
        print("[verify] seeded reference-layout fixture")
    else:
        sd = torch_ckpt.load_torch_state_dict(args.ckpt)
        if args.component == "trunk":  # widths the file's, heads --scale's
            cfg = torch_ckpt.infer_trunk_config(sd, cfg)
        elif args.component in ("clm", "jlm"):
            cfg = None                 # the whole config is the file's
    layers = None
    if args.layers:
        a, _, b = args.layers.partition(":")
        layers = slice(int(a) if a else None, int(b) if b else None)
    rows = run(args.component, sd, cfg, layers=layers, heads=args.heads,
               device=args.device)
    worst = report(rows, args.component)
    if worst > args.tol:
        raise SystemExit(f"[verify] {args.component}: worst rel diff "
                         f"{worst:.3e} > {args.tol:.0e}")
    return rows


def main(argv=None) -> None:
    """``esmdiff-torch-verify``."""
    check(argv)


if __name__ == "__main__":
    main()
