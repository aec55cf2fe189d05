"""Output heads for the ESM3 trunk (port of ``esmdiff_tpu/nn/heads.py``):
the stock multi-track ``OutputHeads`` and the fine-tune
``StructureOutputHeads``."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from .layers import RegressionHead


class ESMOutput(NamedTuple):
    sequence_logits: torch.Tensor
    structure_logits: torch.Tensor
    secondary_structure_logits: torch.Tensor
    sasa_logits: torch.Tensor
    function_logits: torch.Tensor
    residue_logits: torch.Tensor
    embeddings: torch.Tensor


class OutputHeads(nn.Module):
    """Stock ESM3 per-track regression heads (structure head is 4096-way)."""

    def __init__(self, d_model: int, dtype=torch.bfloat16):
        super().__init__()
        self.function_head = RegressionHead(
            d_model, C.FUNCTION_VOCAB_SIZE * C.FUNCTION_TOKEN_DEPTH,
            dtype=dtype)
        self.sequence_head = RegressionHead(d_model, C.SEQUENCE_EMBED_SIZE,
                                            dtype=dtype)
        self.structure_head = RegressionHead(d_model, C.VQVAE_CODEBOOK_SIZE,
                                             dtype=dtype)
        self.ss8_head = RegressionHead(d_model, C.SS8_VOCAB_SIZE, dtype=dtype)
        self.sasa_head = RegressionHead(d_model, C.SASA_VOCAB_SIZE, dtype=dtype)
        self.residue_head = RegressionHead(
            d_model, C.RESIDUE_ANNOTATION_VOCAB_SIZE, dtype=dtype)

    def forward(self, x, embed) -> ESMOutput:
        B, L, _ = x.shape
        fn_logits = self.function_head(x).reshape(
            B, L, C.FUNCTION_TOKEN_DEPTH, C.FUNCTION_VOCAB_SIZE)
        return ESMOutput(
            sequence_logits=self.sequence_head(x),
            structure_logits=self.structure_head(x),
            secondary_structure_logits=self.ss8_head(x),
            sasa_logits=self.sasa_head(x),
            function_logits=fn_logits,
            residue_logits=self.residue_head(x),
            embeddings=embed,
        )


class StructureOutputHeads(nn.Module):
    """Fine-tune replacement: 4101-way structure head (+ optional sequence
    head), zeros elsewhere."""

    def __init__(self, d_model: int,
                 n_structure_heads: int = C.STRUCTURE_VOCAB_SIZE,
                 n_sequence_heads: int = 0, dtype=torch.bfloat16):
        super().__init__()
        self.structure_head = RegressionHead(d_model, n_structure_heads,
                                             dtype=dtype)
        self.sequence_head = (RegressionHead(d_model, n_sequence_heads,
                                             dtype=dtype)
                              if n_sequence_heads else None)

    def forward(self, x, embed) -> ESMOutput:
        structure_logits = self.structure_head(x)
        dummy = torch.zeros_like(structure_logits)
        sequence_logits = (dummy if self.sequence_head is None
                           else self.sequence_head(x))
        return ESMOutput(
            sequence_logits=sequence_logits,
            structure_logits=structure_logits,
            secondary_structure_logits=dummy,
            sasa_logits=dummy,
            function_logits=dummy,
            residue_logits=dummy,
            embeddings=embed,
        )
