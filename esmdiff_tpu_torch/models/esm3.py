"""ESM3 trunk in PyTorch (port of ``esmdiff_tpu/models/esm3.py``).

Input-track embedding sum, pre-norm blocks (QK-layernorm + rotary attention,
SwiGLU FFN, geometric attention in block 0 over frames built from input
coordinates), residuals scaled by 1/sqrt(n_layers/36), final LayerNorm and
swappable output heads.  The layers are a plain ``ModuleList``
(``blocks[i]`` is layer i) where JAX scans over stacked parameters;
``convert`` unstacks them.  With ``remat`` (the default, as in JAX) the
blocks JAX scans are rematerialised in the backward while autograd records
(``torch.utils.checkpoint``, non-reentrant); block 0, with geometric
attention, is not, as in JAX.  ``remat_policy`` "nothing" recomputes the
whole block; "dots" (JAX's ``dots_saveable``) keeps the outputs of the
products (``mm``, ``addmm``, ``bmm``, ``_int_mm``) and recomputes the rest,
through a selective-checkpoint policy.  The attention kernel is no product
in JAX (a Pallas call) and none here (a ctypes launch inside an
``autograd.Function``, which the policy never sees as an op): it is
recomputed under both policies, so the flash launches of a train step are
the same.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.attention import sequence_id_mask
from esmdiff_tpu_torch.nn.embed import EncodeInputs
from esmdiff_tpu_torch.nn.geometric import (GeometricAttention,
                                            build_affine3d_from_coordinates)
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
    mask_and_zero_frameless: bool = True
    # "esm3" = stock multi-track heads (4096-way structure); "structure" =
    # fine-tune replacement (4101-way + optional sequence head)
    head_type: str = "esm3"
    n_structure_heads: int = C.STRUCTURE_VOCAB_SIZE
    n_sequence_heads: int = 0
    dtype: str = "bfloat16"
    # recompute blocks n_layers_geom.. in the backward (training only);
    # "nothing" = the whole block, "dots" = keep the products' outputs
    remat: bool = True
    remat_policy: str = "nothing"
    # "auto"/"flash" = flash kernel, "small" = rotary fused into the
    # attention kernel, "xla" = plain attention (nn/layers.py)
    attn_backend: str = "auto"
    qkv_backend: str = "xla"  # "fused" = LN + QKV + QK-LN kernel
    # "int8" = W8A8 attention/FFN projections (ops/quant.py), inference
    # only; weights converted by ops.quant.quantize_trunk_params
    quant: str = "none"

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
    """Pre-norm block: attention (+ geometric attention in the blocks that
    own it) + SwiGLU, residuals scaled by 1/sqrt(n_layers/36)."""

    def __init__(self, cfg: ESM3Config, use_geom_attn: bool = False):
        super().__init__()
        dt = cfg.torch_dtype
        self.scale = cfg.residue_scaling_factor
        self.attn = MultiHeadAttention(cfg.d_model, cfg.n_heads, dtype=dt,
                                       attn_backend=cfg.attn_backend,
                                       qkv_backend=cfg.qkv_backend,
                                       quant=cfg.quant)
        self.geom_attn = (GeometricAttention(
            cfg.d_model, cfg.v_heads,
            mask_and_zero_frameless=cfg.mask_and_zero_frameless, dtype=dt)
            if use_geom_attn else None)
        self.ffn = SwiGLUFFN(cfg.d_model, cfg.ffn_hidden, dtype=dt,
                             quant=cfg.quant)

    def forward(self, x, rot_cos, rot_sin, mask=None, lengths=None,
                affine=None, affine_mask=None, sequence_id=None,
                chain_id=None, skip_geom: bool = False):
        x = x + self.attn(x, rot_cos, rot_sin, mask=mask,
                          lengths=lengths) / self.scale
        if self.geom_attn is not None and not skip_geom:
            if affine is None or affine_mask is None:
                raise ValueError("geometric attention needs affine and "
                                 "affine_mask (or skip_geom=True)")
            x = x + self.geom_attn(x, affine, affine_mask, sequence_id,
                                   chain_id) / self.scale
        return x + self.ffn(x) / self.scale


# the products whose outputs "dots" keeps (jax.checkpoint_policies.
# dots_saveable: every dot_general)
SAVED_PRODUCTS = frozenset(
    getattr(torch.ops.aten, name).default
    for name in ("mm", "addmm", "bmm", "_int_mm"))
REMAT_POLICIES = ("nothing", "dots")


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_kwargs(policy: str) -> dict:
    """``torch.utils.checkpoint`` arguments of a ``remat_policy``."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    kw = dict(use_reentrant=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_saveable)
    return kw


class TransformerStack(nn.Module):
    def __init__(self, cfg: ESM3Config):
        super().__init__()
        self.remat_kwargs = remat_kwargs(cfg.remat_policy)
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, use_geom_attn=i < cfg.n_layers_geom)
            for i in range(cfg.n_layers))
        self.norm = LayerNorm(cfg.d_model)

    def forward(self, x, sequence_id=None, affine=None, affine_mask=None,
                chain_id=None, skip_geom: bool = False, lengths=None,
                positions=None):
        """Returns (final-norm output, pre-norm output).

        Masking, as in ``nn/attention.py``: ``lengths`` (B,) = prefix
        padding (the kernel path); ``sequence_id`` (B, L) = packed segments,
        a block-diagonal mask (the plain path).  Passing both raises.
        positions: rotary positions, (L,) or (B, L), for packed rows.
        affine, affine_mask, chain_id: the frames and chains of the blocks
        that own geometric attention, which run it unless ``skip_geom``."""
        if sequence_id is not None and lengths is not None:
            raise ValueError("pass either sequence_id or lengths, not both")
        cfg = self.cfg
        rot_cos, rot_sin = rotary_tables(x.shape[1], cfg.d_model // cfg.n_heads,
                                         device=x.device, positions=positions)
        mask = sequence_id_mask(sequence_id)
        if (sequence_id is None and lengths is not None
                and cfg.n_layers_geom and not skip_geom):
            # geometric attention keys off sequence_id; a prefix-length mask
            # is the equivalent 0/1 id pattern
            sequence_id = (torch.arange(x.shape[1], device=x.device)[None, :]
                           < lengths.to(x.device)[:, None]).int()
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if remat and i >= cfg.n_layers_geom:
                x = checkpoint(block, x, rot_cos, rot_sin, mask=mask,
                               lengths=lengths, **self.remat_kwargs)
                continue
            x = block(x, rot_cos, rot_sin, mask=mask, lengths=lengths,
                      affine=affine, affine_mask=affine_mask,
                      sequence_id=sequence_id, chain_id=chain_id,
                      skip_geom=skip_geom)
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
              per_res_plddt=None, structure_coords=None, chain_id=None,
              auxiliary_embeddings=None):
        """Everything before the transformer stack -> (x (B, L, d_model),
        affine, affine_mask, chain_id, skip_geom).

        structure_coords: optional (B, L, >=3, 3) coordinates whose first
        three atoms are N, CA, C (NaN/inf where unknown); they become block
        0's frames.  Without them every frame would be masked and geometric
        attention an exact no-op, so ``skip_geom`` is set and the frames are
        None."""
        ref = next(t for t in (sequence_tokens, structure_tokens, ss8_tokens,
                               sasa_tokens, structure_coords)
                   if t is not None)
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
        chain_id = default_tok(chain_id, 0)
        if average_plddt is None:
            average_plddt = torch.ones((B, L), device=dev)
        if per_res_plddt is None:
            per_res_plddt = torch.zeros((B, L), device=dev)
        function_tokens = default_tok(function_tokens, C.INTERPRO_PAD_TOKEN,
                                      (B, L, C.FUNCTION_TOKEN_DEPTH))
        residue_annotation_tokens = default_tok(
            residue_annotation_tokens, C.RESIDUE_PAD_TOKEN,
            (B, L, C.RESIDUE_ANNOTATION_DEPTH))
        skip_geom = structure_coords is None
        affine = affine_mask = None
        if not skip_geom:
            affine, affine_mask = build_affine3d_from_coordinates(
                structure_coords[..., :3, :])

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
        return x, affine, affine_mask, chain_id, skip_geom

    def forward(self, structure_tokens=None, sequence_tokens=None,
                ss8_tokens=None, sasa_tokens=None, function_tokens=None,
                residue_annotation_tokens=None, average_plddt=None,
                per_res_plddt=None, structure_coords=None, chain_id=None,
                sequence_id=None, lengths=None, positions=None,
                auxiliary_embeddings=None) -> ESMOutput:
        """The trunk's forward.  ``sequence_id``/``lengths``/``positions``
        as in ``TransformerStack.forward``; ``structure_coords`` and
        ``chain_id`` (default all 0) feed geometric attention."""
        x, affine, affine_mask, chain_id, skip_geom = self.embed(
            structure_tokens=structure_tokens,
            sequence_tokens=sequence_tokens, ss8_tokens=ss8_tokens,
            sasa_tokens=sasa_tokens, function_tokens=function_tokens,
            residue_annotation_tokens=residue_annotation_tokens,
            average_plddt=average_plddt, per_res_plddt=per_res_plddt,
            structure_coords=structure_coords, chain_id=chain_id,
            auxiliary_embeddings=auxiliary_embeddings)
        x, embedding = self.transformer(
            x, sequence_id=sequence_id, affine=affine,
            affine_mask=affine_mask, chain_id=chain_id, skip_geom=skip_geom,
            lengths=lengths, positions=positions)
        return self.output_heads(x, embedding)
