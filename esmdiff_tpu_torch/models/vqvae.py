"""VQ-VAE structure tokenizer: geometric encoder + transformer decoder (port
of ``esmdiff_tpu/models/vqvae.py``).

encoder — for every residue, its k nearest residues by CA distance form a
local neighbourhood, encoded by a 2-layer stack whose only sequence
features are relative-position embeddings (geometry enters through block
0's geometric attention on the neighbours' frames); the centre residue's
output is projected to ``d_out`` and quantized against the codebook.

decoder — embeds 4101-way structure tokens, runs a 30-layer / 1280-wide
stack, and predicts backbone frames through a 6D-rotation head; pLDDT from
a 50-bin head, pTM from pairwise aligned-error logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.geometric import (Affine3D,
                                            build_affine3d_from_coordinates)
from esmdiff_tpu_torch.nn.layers import Dense, Embed, LayerNorm, RegressionHead
from .esm3 import ESM3Config, TransformerStack

_IDEAL = np.stack([rc.IDEALIZED_N, rc.IDEALIZED_CA, rc.IDEALIZED_C])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    d_model: int = 1024
    n_heads: int = 1
    v_heads: int = 128
    n_layers: int = 2
    d_out: int = 128
    n_codes: int = C.VQVAE_CODEBOOK_SIZE
    knn: int = 16
    rel_pos_bins: int = 32
    dtype: str = "float32"

    def stack_config(self) -> ESM3Config:
        # Plain attention, not the flash kernel: the stack's attention is
        # one head of Dh = d_model (1024) in float32 over knn (16) keys,
        # which JAX's "auto" also sends to its plain path (16 <
        # _FLASH_MIN_LEN), and the kernel takes only Dh 64 in bf16.
        return ESM3Config(d_model=self.d_model, n_heads=self.n_heads,
                          v_heads=self.v_heads, n_layers=self.n_layers,
                          n_layers_geom=1, dtype=self.dtype,
                          attn_backend="xla")


def knn_graph(ca, valid_mask, k: int):
    """The k nearest residues by CA distance, self first, nearest first,
    ties toward the lower index (as ``lax.top_k`` orders them; the stack
    puts rotary positions on this axis, so the order is part of the
    function).

    ca: (B, L, 3); valid_mask: (B, L) bool -> (idx (B, L, k), neigh_valid
    (B, L, k) bool).  Invalid neighbours map to the residue itself."""
    d2 = ((ca[:, :, None, :] - ca[:, None, :, :]) ** 2).sum(dim=-1)
    big = 1e9
    pair_ok = valid_mask[:, :, None] & valid_mask[:, None, :]
    d2 = torch.where(pair_ok, d2, big)
    L = ca.shape[1]
    eye = torch.eye(L, dtype=torch.bool, device=ca.device)[None]
    d2 = torch.where(eye, -1.0, d2)
    d_k, idx = torch.sort(d2, dim=-1, stable=True)
    d_k, idx = d_k[..., :k], idx[..., :k]
    neigh_valid = d_k < big / 2
    self_idx = torch.arange(L, device=ca.device)[None, :, None]
    return torch.where(neigh_valid, idx, self_idx), neigh_valid


def nearest_code(z, codebook):
    """(..., d) x (n, d) -> (...,) index of the nearest code: argmin of
    |z|^2 - 2 z.c + |c|^2 in float32, the first index on ties."""
    d2 = ((z * z).sum(dim=-1, keepdim=True) - 2.0 * (z @ codebook.t())
          + (codebook * codebook).sum(dim=-1))
    return d2.argmin(dim=-1)


class StructureTokenEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig = EncoderConfig()):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.relative_position_embed = Embed(2 * cfg.rel_pos_bins + 2,
                                             cfg.d_model, dtype=dt)
        self.transformer = TransformerStack(cfg.stack_config())
        self.pre_vq_proj = Dense(cfg.d_model, cfg.d_out, dtype=dt)
        self.codebook = nn.Parameter(torch.empty(cfg.n_codes, cfg.d_out))

    def forward(self, coords, residue_index=None, valid_mask=None,
                return_zq: bool = False):
        """coords: (B, L, 3, 3) N/CA/C (NaN/inf where unknown) -> (tokens
        (B, L) int64, z (B, L, d_out), valid (B, L) bool); invalid
        positions get STRUCTURE_MASK_TOKEN.

        return_zq=True also returns z_q = codebook[nearest code] (float32,
        (B, L, d_out)) for VQ-VAE training; invalid positions carry a code
        there too and must be masked by the caller through ``valid``."""
        cfg = self.cfg
        B, L = coords.shape[:2]
        K = min(cfg.knn, L)
        affine, affine_ok = build_affine3d_from_coordinates(coords)
        valid_mask = (affine_ok if valid_mask is None
                      else valid_mask & affine_ok)
        if residue_index is None:
            residue_index = torch.arange(L, device=coords.device).expand(B, L)

        idx, neigh_ok = knn_graph(affine.trans, valid_mask, K)
        b = torch.arange(B, device=coords.device)[:, None, None]
        rot_n, trans_n = affine.rot[b, idx], affine.trans[b, idx]
        rel = (residue_index[b, idx] - residue_index[:, :, None]).clamp(
            -cfg.rel_pos_bins, cfg.rel_pos_bins) + cfg.rel_pos_bins
        # invalid neighbours get a bucket of their own
        rel = torch.where(neigh_ok, rel, 2 * cfg.rel_pos_bins + 1)
        s = self.relative_position_embed(rel)          # (B, L, K, d)

        # the neighbourhoods fold into the batch axis: (B * L, K, ...)
        x, _ = self.transformer(
            s.reshape(B * L, K, cfg.d_model),
            affine=Affine3D(rot=rot_n.reshape(B * L, K, 3, 3),
                            trans=trans_n.reshape(B * L, K, 3)),
            affine_mask=neigh_ok.reshape(B * L, K))
        z = self.pre_vq_proj(x[:, 0, :].reshape(B, L, cfg.d_model))
        raw = nearest_code(z.float(), self.codebook.float())
        tokens = torch.where(valid_mask, raw, C.STRUCTURE_MASK_TOKEN)
        if return_zq:
            return tokens, z, valid_mask, self.codebook.float()[raw]
        return tokens, z, valid_mask


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    d_model: int = C.VQVAE_DECODER_D_MODEL  # 1280
    n_heads: int = 20
    n_layers: int = 30
    plddt_bins: int = 50
    pae_bins: int = 64
    trans_scale: float = 10.0
    predict_ptm: bool = True
    dtype: str = "bfloat16"
    # recompute every block in the backward: off for inference, on for the
    # VQ-VAE trainer's full geometry (activation memory)
    remat: bool = False
    quant: str = "none"  # "int8" = W8A8 stack projections (ops/quant.py)

    def stack_config(self) -> ESM3Config:
        return ESM3Config(d_model=self.d_model, n_heads=self.n_heads,
                          v_heads=0, n_layers=self.n_layers, n_layers_geom=0,
                          dtype=self.dtype, remat=self.remat,
                          quant=self.quant)


class Dim6RotStructureHead(nn.Module):
    """Per-residue frames as 6D rotations + scaled translations; places the
    idealized backbone (N, CA, C) through them -> (..., 3, 3)."""

    def __init__(self, d_model: int, trans_scale: float = 10.0,
                 dtype=torch.bfloat16):
        super().__init__()
        self.trans_scale = trans_scale
        self.ffn1 = Dense(d_model, d_model, dtype=dtype)
        self.ln = LayerNorm(d_model, use_bias=True)
        self.proj = Dense(d_model, 9, dtype=dtype)

    def forward(self, x):
        h = self.ln(F.gelu(self.ffn1(x)))
        p = self.proj(h).float()
        v1, v2, trans = p[..., 0:3], p[..., 3:6], p[..., 6:9]
        # Gram-Schmidt 6D -> rotation (columns e1, e2, e3)
        e1 = v1 / v1.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        u2 = v2 - e1 * (e1 * v2).sum(dim=-1, keepdim=True)
        e2 = u2 / u2.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        rot = torch.stack([e1, e2, e3], dim=-1)
        trans = trans * self.trans_scale
        ideal = torch.tensor(_IDEAL, device=p.device)           # (3, 3)
        return torch.einsum("...ij,aj->...ai", rot, ideal) + trans[..., None, :]


class StructureTokenDecoder(nn.Module):
    """embed=False builds the decoder without its token table: the VQ-VAE
    trainer (``train/vqvae.py``) always feeds ``inputs_embeds`` and
    materializes the table at export, so it never owns (or decays) one,
    as the JAX decoder never creates it in that mode."""

    def __init__(self, cfg: DecoderConfig = DecoderConfig(),
                 embed: bool = True):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.embed = (Embed(C.STRUCTURE_VOCAB_SIZE, cfg.d_model, dtype=dt)
                      if embed else None)
        self.decoder_stack = TransformerStack(cfg.stack_config())
        self.affine_output_projection = Dim6RotStructureHead(
            cfg.d_model, trans_scale=cfg.trans_scale, dtype=dt)
        self.plddt_head = RegressionHead(cfg.d_model, cfg.plddt_bins,
                                         dtype=dt)
        if cfg.predict_ptm:
            self.pae_q = Dense(cfg.d_model, cfg.pae_bins, dtype=dt)
            self.pae_k = Dense(cfg.d_model, cfg.pae_bins, dtype=dt)

    def forward(self, structure_tokens, compute_ptm: bool = True,
                lengths=None, inputs_embeds=None):
        """(B, L) int tokens -> dict(bb_pred (B, L, 3, 3), plddt (B, L)
        [, ptm (B,)]).

        inputs_embeds: optional (B, L, d_model) inputs in place of the
        token lookup (the VQ-VAE trainer's straight-through codes).

        lengths: optional (B,) valid prefix lengths.  Attention then masks
        keys past each row's length: for every valid query that is the key
        set the JAX decoder's segment mask gives, so valid positions compute
        the same function as an exact-length decode (pad positions are
        garbage and are stripped by the caller).
        """
        cfg = self.cfg
        x = (self.embed(structure_tokens) if inputs_embeds is None
             else inputs_embeds.to(torch_dtype(cfg.dtype)))
        x, _ = self.decoder_stack(x, lengths=lengths)
        out = {"bb_pred": self.affine_output_projection(x)}
        plddt_logits = self.plddt_head(x)
        centers = (torch.arange(cfg.plddt_bins, dtype=torch.float32,
                                device=x.device) + 0.5) / cfg.plddt_bins
        out["plddt"] = torch.softmax(plddt_logits, dim=-1) @ centers
        if cfg.predict_ptm and compute_ptm:
            # pairwise aligned-error logits from low-rank per-residue
            # features, pTM via the AlphaFold TM-score expectation
            q = self.pae_q(x).float()
            k = self.pae_k(x).float()
            pae_probs = torch.softmax(q[:, :, None, :] + k[:, None, :, :],
                                      dim=-1)                # (B, L, L, bins)
            L = structure_tokens.shape[1]
            bin_centers = (torch.arange(cfg.pae_bins, device=x.device) + 0.5) \
                * (31.0 / cfg.pae_bins)
            d0 = 1.24 * max(L - 15.0, 19.0) ** (1.0 / 3.0) - 1.8
            tm_per_bin = 1.0 / (1.0 + (bin_centers / d0) ** 2)
            out["ptm"] = (pae_probs @ tm_per_bin).mean(dim=(1, 2))
        return out


def decode_structure_tokens(decoder: StructureTokenDecoder, structure_tokens):
    """Tokens (with BOS/EOS) -> backbone coordinates and pLDDT with BOS/EOS
    stripped, and pTM, as the JAX package's ``decode_structure_tokens``."""
    out = decoder(structure_tokens)
    return {"bb_pred": out["bb_pred"][:, 1:-1],
            "plddt": out["plddt"][:, 1:-1], "ptm": out.get("ptm")}
