"""ESM3 trunk in PyTorch (port of ``esmdiff_tpu/models/esm3.py``).

Input-track embedding sum, pre-norm blocks (QK-layernorm + rotary attention,
SwiGLU FFN, geometric attention in block 0), residuals scaled by
1/sqrt(n_layers/36), final LayerNorm and swappable output heads.  The layers
are a plain ``ModuleList`` (``blocks[i]`` is layer i) where JAX scans over
stacked parameters; ``convert.py`` unstacks them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.embed import EncodeInputs
from esmdiff_tpu_torch.nn.geometric import GeometricAttention
from esmdiff_tpu_torch.nn.heads import (ESMOutput, OutputHeads,
                                        StructureOutputHeads)
from esmdiff_tpu_torch.nn.layers import (LayerNorm, MultiHeadAttention,
                                         SwiGLUFFN, swiglu_hidden_dim)
from esmdiff_tpu_torch.nn.rotary import rotary_tables


@dataclasses.dataclass(frozen=True)
class ESM3Config:
    d_model: int = C.ESM3_D_MODEL
    n_heads: int = C.ESM3_N_HEADS
    v_heads: int = C.ESM3_V_HEADS
    n_layers: int = C.ESM3_N_LAYERS
    n_layers_geom: int = 1
    expansion_ratio: float = 8 / 3
    # "esm3" = stock multi-track heads (4096-way structure); "structure" =
    # fine-tune replacement (4101-way + optional sequence head)
    head_type: str = "esm3"
    n_structure_heads: int = C.STRUCTURE_VOCAB_SIZE
    n_sequence_heads: int = 0
    dtype: str = "bfloat16"
    # "auto"/"flash" = flash kernel, "small" = rotary fused into the
    # attention kernel, "xla" = plain attention (nn/layers.py)
    attn_backend: str = "auto"
    qkv_backend: str = "xla"  # "fused" = LN + QKV + QK-LN kernel

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def residue_scaling_factor(self) -> float:
        return (self.n_layers / 36.0) ** 0.5

    @property
    def ffn_hidden(self) -> int:
        return swiglu_hidden_dim(self.d_model, self.expansion_ratio)


def esm3_open_small(**overrides) -> ESM3Config:
    """Geometry of esm3_sm_open_v1: d_model 1536, 24 heads, 48 layers."""
    return ESM3Config(**overrides)


def esm3_tiny(**overrides) -> ESM3Config:
    """A small config for tests: same topology, toy widths."""
    kw = dict(d_model=64, n_heads=4, v_heads=8, n_layers=4)
    kw.update(overrides)
    return ESM3Config(**kw)


class TransformerBlock(nn.Module):
    """Pre-norm block: attention + SwiGLU, residuals scaled by
    1/sqrt(n_layers/36).  Block 0 owns geometric attention's parameters;
    its compute runs only with coordinates, which the trunk does not take
    yet (``ESM3.embed`` raises), so the block never calls it."""

    def __init__(self, cfg: ESM3Config, use_geom_attn: bool = False):
        super().__init__()
        dt = cfg.torch_dtype
        self.scale = cfg.residue_scaling_factor
        self.attn = MultiHeadAttention(cfg.d_model, cfg.n_heads, dtype=dt,
                                       attn_backend=cfg.attn_backend,
                                       qkv_backend=cfg.qkv_backend)
        # owned, so checkpoints load strictly
        self.geom_attn = (GeometricAttention(cfg.d_model, cfg.v_heads,
                                             dtype=dt)
                          if use_geom_attn else None)
        self.ffn = SwiGLUFFN(cfg.d_model, cfg.ffn_hidden, dtype=dt)

    def forward(self, x, rot_cos, rot_sin, lengths=None):
        x = x + self.attn(x, rot_cos, rot_sin, lengths=lengths) / self.scale
        return x + self.ffn(x) / self.scale


class TransformerStack(nn.Module):
    def __init__(self, cfg: ESM3Config):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, use_geom_attn=i < cfg.n_layers_geom)
            for i in range(cfg.n_layers))
        self.norm = LayerNorm(cfg.d_model)

    def forward(self, x, lengths=None):
        """Returns (final-norm output, pre-norm output).  ``lengths``:
        optional (B,) prefix lengths (the kernel path).  The packed
        ``sequence_id`` form comes with sequence packing, in a later slice."""
        cfg = self.cfg
        rot_cos, rot_sin = rotary_tables(x.shape[1], cfg.d_model // cfg.n_heads,
                                         device=x.device)
        for block in self.blocks:
            x = block(x, rot_cos, rot_sin, lengths=lengths)
        return self.norm(x), x


class ESM3(nn.Module):
    """Trunk with the reference's conformation-generation forward: track
    defaults, structure/sequence special-token tying and auxiliary
    (time-conditioning) embeddings."""

    def __init__(self, cfg: ESM3Config):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.encoder = EncodeInputs(cfg.d_model, dtype=dt)
        self.transformer = TransformerStack(cfg)
        if cfg.head_type == "structure":
            self.output_heads = StructureOutputHeads(
                cfg.d_model, n_structure_heads=cfg.n_structure_heads,
                n_sequence_heads=cfg.n_sequence_heads, dtype=dt)
        else:
            self.output_heads = OutputHeads(cfg.d_model, dtype=dt)

    def embed(self, structure_tokens=None, sequence_tokens=None,
              ss8_tokens=None, sasa_tokens=None, function_tokens=None,
              residue_annotation_tokens=None, average_plddt=None,
              per_res_plddt=None, structure_coords=None,
              auxiliary_embeddings=None):
        """Everything before the transformer stack -> (B, L, d_model)."""
        if structure_coords is not None:
            raise NotImplementedError(
                "structure coordinates as trunk input (geometric attention) "
                "are not ported yet")
        ref = next(t for t in (sequence_tokens, structure_tokens, ss8_tokens,
                               sasa_tokens) if t is not None)
        B, L = ref.shape[0], ref.shape[1]
        dev = ref.device

        def default_tok(x, tok, shape=(B, L)):
            if x is not None:
                return x
            return torch.full(shape, tok, dtype=torch.long, device=dev)

        sequence_tokens = default_tok(sequence_tokens, C.SEQUENCE_MASK_TOKEN)
        structure_tokens = default_tok(structure_tokens,
                                       C.STRUCTURE_MASK_TOKEN)
        ss8_tokens = default_tok(ss8_tokens, C.SS8_PAD_TOKEN)
        sasa_tokens = default_tok(sasa_tokens, C.SASA_PAD_TOKEN)
        if average_plddt is None:
            average_plddt = torch.ones((B, L), device=dev)
        if per_res_plddt is None:
            per_res_plddt = torch.zeros((B, L), device=dev)
        function_tokens = default_tok(function_tokens, C.INTERPRO_PAD_TOKEN,
                                      (B, L, C.FUNCTION_TOKEN_DEPTH))
        residue_annotation_tokens = default_tok(
            residue_annotation_tokens, C.RESIDUE_PAD_TOKEN,
            (B, L, C.RESIDUE_ANNOTATION_DEPTH))

        # tie structure specials to the sequence specials
        st = structure_tokens
        st = torch.where(st == -1, C.STRUCTURE_MASK_TOKEN, st)
        for seq_tok, st_tok in (
                (C.SEQUENCE_BOS_TOKEN, C.STRUCTURE_BOS_TOKEN),
                (C.SEQUENCE_PAD_TOKEN, C.STRUCTURE_PAD_TOKEN),
                (C.SEQUENCE_EOS_TOKEN, C.STRUCTURE_EOS_TOKEN),
                (C.SEQUENCE_CHAINBREAK_TOKEN, C.STRUCTURE_CHAINBREAK_TOKEN)):
            st = torch.where(sequence_tokens == seq_tok, st_tok, st)

        x = self.encoder(sequence_tokens, st, average_plddt, per_res_plddt,
                         ss8_tokens, sasa_tokens, function_tokens,
                         residue_annotation_tokens)
        if auxiliary_embeddings is not None:
            x = x + auxiliary_embeddings.to(x.dtype)
        return x

    def forward(self, structure_tokens=None, sequence_tokens=None,
                ss8_tokens=None, sasa_tokens=None, function_tokens=None,
                residue_annotation_tokens=None, average_plddt=None,
                per_res_plddt=None, structure_coords=None, lengths=None,
                auxiliary_embeddings=None) -> ESMOutput:
        x = self.embed(
            structure_tokens=structure_tokens,
            sequence_tokens=sequence_tokens, ss8_tokens=ss8_tokens,
            sasa_tokens=sasa_tokens, function_tokens=function_tokens,
            residue_annotation_tokens=residue_annotation_tokens,
            average_plddt=average_plddt, per_res_plddt=per_res_plddt,
            structure_coords=structure_coords,
            auxiliary_embeddings=auxiliary_embeddings)
        # no coordinates: every frame is masked and geometric attention is
        # an exact no-op, so the stack skips it
        x, embedding = self.transformer(x, lengths=lengths)
        return self.output_heads(x, embedding)
