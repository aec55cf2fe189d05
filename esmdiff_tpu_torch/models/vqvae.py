"""VQ-VAE structure-token decoder (port of the decoder half of
``esmdiff_tpu/models/vqvae.py``): embeds 4101-way structure tokens, runs a
30-layer / 1280-wide stack, and predicts backbone frames through a
6D-rotation head; pLDDT from a 50-bin head, pTM from pairwise aligned-error
logits.  The encoder waits for a later slice of the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.layers import Dense, Embed, LayerNorm, RegressionHead
from .esm3 import ESM3Config, TransformerStack

_IDEAL = np.stack([rc.IDEALIZED_N, rc.IDEALIZED_CA, rc.IDEALIZED_C])


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
    quant: str = "none"  # "int8" = W8A8 stack projections (ops/quant.py)

    def stack_config(self) -> ESM3Config:
        return ESM3Config(d_model=self.d_model, n_heads=self.n_heads,
                          v_heads=0, n_layers=self.n_layers, n_layers_geom=0,
                          dtype=self.dtype, quant=self.quant)


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
    def __init__(self, cfg: DecoderConfig = DecoderConfig()):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.embed = Embed(C.STRUCTURE_VOCAB_SIZE, cfg.d_model, dtype=dt)
        self.decoder_stack = TransformerStack(cfg.stack_config())
        self.affine_output_projection = Dim6RotStructureHead(
            cfg.d_model, trans_scale=cfg.trans_scale, dtype=dt)
        self.plddt_head = RegressionHead(cfg.d_model, cfg.plddt_bins,
                                         dtype=dt)
        if cfg.predict_ptm:
            self.pae_q = Dense(cfg.d_model, cfg.pae_bins, dtype=dt)
            self.pae_k = Dense(cfg.d_model, cfg.pae_bins, dtype=dt)

    def forward(self, structure_tokens, compute_ptm: bool = True,
                lengths=None):
        """(B, L) int tokens -> dict(bb_pred (B, L, 3, 3), plddt (B, L)
        [, ptm (B,)]).

        lengths: optional (B,) valid prefix lengths.  Attention then masks
        keys past each row's length: for every valid query that is the key
        set the JAX decoder's segment mask gives, so valid positions compute
        the same function as an exact-length decode (pad positions are
        garbage and are stripped by the caller).
        """
        cfg = self.cfg
        x = self.embed(structure_tokens)
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
