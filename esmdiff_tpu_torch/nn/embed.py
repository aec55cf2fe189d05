"""Input-track embedding sum (ESM3 ``EncodeInputs``), port of
``esmdiff_tpu/nn/embed.py``: 8 token/scalar tracks, each embedded to d_model
and summed."""

from __future__ import annotations

import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from .layers import Dense, Embed


def rbf(values, v_min: float, v_max: float, n_bins: int):
    """Radial basis encoding of a scalar track, (...,) -> (..., n_bins)."""
    centers = torch.linspace(v_min, v_max, n_bins, dtype=torch.float32,
                             device=values.device)
    std = (v_max - v_min) / n_bins
    z = (values.float()[..., None] - centers) / std
    return torch.exp(-z * z)


class EncodeInputs(nn.Module):
    def __init__(self, d_model: int, dtype=torch.bfloat16):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.sequence_embed = Embed(C.SEQUENCE_EMBED_SIZE, d_model, dtype)
        self.structure_tokens_embed = Embed(C.STRUCTURE_VOCAB_SIZE, d_model,
                                            dtype)
        self.average_plddt_proj = Dense(16, d_model, use_bias=False,
                                        dtype=dtype)
        self.per_res_plddt_proj = Dense(16, d_model, use_bias=False,
                                        dtype=dtype)
        self.ss8_embed = Embed(C.SS8_VOCAB_SIZE, d_model, dtype)
        self.sasa_embed = Embed(C.SASA_VOCAB_SIZE, d_model, dtype)
        # function: depth-8 token stack, each depth embeds to d_model/8 and
        # the slices are concatenated
        self.function_embed = Embed(
            C.FUNCTION_VOCAB_SIZE * C.FUNCTION_TOKEN_DEPTH,
            d_model // C.FUNCTION_TOKEN_DEPTH, dtype)
        self.residue_embed = Embed(C.RESIDUE_ANNOTATION_VOCAB_SIZE, d_model,
                                   dtype)

    def forward(self, sequence_tokens, structure_tokens, average_plddt,
                per_res_plddt, ss8_tokens, sasa_tokens, function_tokens,
                residue_annotation_tokens):
        emb = self.sequence_embed(sequence_tokens)
        emb = emb + self.structure_tokens_embed(structure_tokens)
        emb = emb + self.average_plddt_proj(
            rbf(average_plddt, 0.0, 1.0, 16).to(self.dtype))
        emb = emb + self.per_res_plddt_proj(
            rbf(per_res_plddt, 0.0, 1.0, 16).to(self.dtype))
        emb = emb + self.ss8_embed(ss8_tokens)
        emb = emb + self.sasa_embed(sasa_tokens)
        depth = torch.arange(C.FUNCTION_TOKEN_DEPTH, device=function_tokens.device,
                             dtype=function_tokens.dtype)
        fn = self.function_embed(function_tokens
                                 + depth * C.FUNCTION_VOCAB_SIZE)
        emb = emb + fn.reshape(*fn.shape[:-2], self.d_model)
        # residue annotations: bag-of-annotations sum, pad rows excluded
        ra = self.residue_embed(residue_annotation_tokens)
        not_pad = residue_annotation_tokens != C.RESIDUE_PAD_TOKEN
        return emb + (ra * not_pad[..., None].to(ra.dtype)).sum(dim=-2)
