"""Joint language model over (sequence, structure) (GPT-2-style), in
PyTorch: port of ``esmdiff_tpu/models/jlm.py``.

A decoder-only transformer over the concatenation of adapted per-residue
ESM3 embeddings and adapted structure-token embeddings, with the two
separator strategies ('sentence': token-type embeddings; 'position': a
learned separator vector and structure positions restarted at 0), GPT-2
blocks (LayerNorm eps 1e-5 in float32, Dense layers with biases, tanh
GELU, float32 scores divided by sqrt(d_head)), two output heads and the
segment-aware shifted losses and accuracies.

Names follow flax (``block<i>`` becomes ``blocks.<i>``; ``sep_token`` and
``token_type`` keep theirs), so ``convert.load_flax_params`` carries a
flax tree over strictly.  Incremental decoding as in ``models/clm.py``:
``prefill`` writes cache rows 0..T-1 for the prompt (sequence part,
separator, first structure token), ``decode_step`` one row in place,
each attending over the whole preallocated cache masked causally.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.layers import Dense, Embed, LayerNorm
from esmdiff_tpu_torch.nn.layers import init_params as init_dense_params
from esmdiff_tpu_torch.ops.quant import QuantDense, quantize_named_denses

from .clm import attend, causal_table

SEP_STRATEGIES = ("sentence", "position")


@dataclasses.dataclass(frozen=True)
class JLMConfig:
    n_embd: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_positions: int = 2048
    seq_vocab: int = C.SEQUENCE_VOCAB_SIZE
    struct_vocab: int = C.STRUCTURE_VOCAB_SIZE
    cond_dim: int = C.ESM3_D_MODEL                    # 1536
    struct_embed_dim: int = C.VQVAE_DECODER_D_MODEL   # 1280
    sep_strategy: str = "sentence"    # 'sentence' | 'position'
    seq_loss_weight: float = 1.0
    dtype: str = "bfloat16"
    # "int8" = W8A8 block projections (ops/quant.py), inference only;
    # weights converted by quantize_jlm_params
    quant: str = "none"

    def __post_init__(self):
        if self.sep_strategy not in SEP_STRATEGIES:
            raise ValueError(f"sep_strategy must be one of {SEP_STRATEGIES}; "
                             f"got {self.sep_strategy!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def d_head(self) -> int:
        return self.n_embd // self.n_heads

    @property
    def offset(self) -> int:
        """Positions between the sequence part and the structure part."""
        return 0 if self.sep_strategy == "sentence" else 1


class GPT2Block(nn.Module):
    def __init__(self, cfg: JLMConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.n_embd, cfg.torch_dtype
        if cfg.quant == "int8":
            def dense(d_in, d_out):
                return QuantDense(d_in, d_out, use_bias=True, dtype=dt)
        else:
            def dense(d_in, d_out):
                return Dense(d_in, d_out, use_bias=True, dtype=dt)
        self.ln1 = LayerNorm(D, use_bias=True)
        self.qkv = dense(D, 3 * D)
        self.attn_out = dense(D, D)
        self.ln2 = LayerNorm(D, use_bias=True)
        self.mlp_up = dense(D, 4 * D)
        self.mlp_down = dense(4 * D, D)

    def forward(self, x, mask, cache=None, cache_index: Optional[int] = None):
        cfg = self.cfg
        B, Lq, _ = x.shape
        h = self.ln1(x).to(cfg.torch_dtype)
        q, k, v = (t.reshape(B, Lq, cfg.n_heads, cfg.d_head)
                   for t in self.qkv(h).chunk(3, dim=-1))
        if cache is not None:
            cache["k"][:, cache_index:cache_index + Lq] = k
            cache["v"][:, cache_index:cache_index + Lq] = v
            k, v = cache["k"], cache["v"]
        o = attend(q, k, v, mask=mask, scale=math.sqrt(float(cfg.d_head)))
        x = x + self.attn_out(o.reshape(B, Lq, cfg.n_embd))
        h = self.ln2(x).to(cfg.torch_dtype)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)


class JLM(nn.Module):
    def __init__(self, cfg: JLMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.structure_embed = Embed(cfg.struct_vocab, cfg.struct_embed_dim,
                                     dtype=dt)
        self.seq_adapter = Dense(cfg.cond_dim, cfg.n_embd, use_bias=False,
                                 dtype=dt)
        self.struct_adapter = Dense(cfg.struct_embed_dim, cfg.n_embd,
                                    use_bias=False, dtype=dt)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, dtype=dt)
        if cfg.sep_strategy == "sentence":
            self.token_type = Embed(2, cfg.n_embd, dtype=dt)
        else:
            self.sep_token = nn.Parameter(torch.empty(cfg.n_embd))
        self.blocks = nn.ModuleList(GPT2Block(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.n_embd, use_bias=True)
        # the heads stay floating point with quant="int8": they write the
        # logits
        self.sequence_head = Dense(cfg.n_embd, cfg.seq_vocab, use_bias=False,
                                   dtype=dt)
        self.structure_head = Dense(cfg.n_embd, cfg.struct_vocab,
                                    use_bias=False, dtype=dt)

    def _joint_embeds(self, sequence_embeddings, structure_tokens):
        """(B, L, cond_dim), (B, Ls) -> (B, L [+ 1] + Ls, D)."""
        cfg = self.cfg
        B, L = sequence_embeddings.shape[:2]
        Ls = structure_tokens.shape[1]
        dev = sequence_embeddings.device
        seq_part = self.seq_adapter(sequence_embeddings.to(cfg.torch_dtype))
        str_part = self.struct_adapter(self.structure_embed(structure_tokens))
        if cfg.sep_strategy == "sentence":
            x = torch.cat([seq_part, str_part], dim=1)
            types = torch.cat([
                torch.zeros(B, L, dtype=torch.long, device=dev),
                torch.ones(B, Ls, dtype=torch.long, device=dev)], dim=1)
            x = x + self.token_type(types)
            pos = torch.arange(L + Ls, device=dev)
        else:
            sep = self.sep_token.to(cfg.torch_dtype).expand(B, 1, cfg.n_embd)
            x = torch.cat([seq_part, sep, str_part], dim=1)
            pos = torch.cat([torch.arange(L, device=dev),
                             torch.zeros(1, dtype=torch.long, device=dev),
                             torch.arange(Ls, device=dev)])
        return x + self.wpe(pos)[None]

    def forward(self, sequence_embeddings, structure_tokens, labels=None,
                mask=None, count=None):
        """The training forward: {"sequence_logits", "structure_logits"},
        and with ``labels`` (B, L + Ls; -100 ignored) and ``mask`` (B, L)
        the per-segment nll and accuracy and the weighted loss.  Each
        segment's sums divide by ``count`` of its number of labels
        (default the number itself; ``RowShard.sum``: this batch's part of
        a global batch's means)."""
        cfg = self.cfg
        L = sequence_embeddings.shape[1]
        x = self._joint_embeds(sequence_embeddings, structure_tokens)
        T = x.shape[1]
        causal = causal_table(T, x.device)[None, None]
        for blk in self.blocks:
            x = blk(x, causal)
        h = self.ln_f(x).to(cfg.torch_dtype)
        seq_logits = self.sequence_head(h[:, :L]).float()
        str_logits = self.structure_head(h[:, L + cfg.offset:]).float()
        out = {"sequence_logits": seq_logits, "structure_logits": str_logits}
        if labels is None:
            return out
        if mask is None:
            raise ValueError("the losses need mask")
        loss = 0.0
        for name, logits, lab in (("sequence", seq_logits, labels[:, :L]),
                                  ("structure", str_logits, labels[:, L:])):
            if cfg.sep_strategy == "position" and name == "structure":
                # the separator predicts structure[0]: no shift
                shift_logits, shift_labels = logits[:, :-1], lab[:, :-1]
                lm = mask[:, :-1]
            else:
                shift_logits, shift_labels = logits[:, :-1], lab[:, 1:]
                lm = mask[:, 1:]
            lp = torch.log_softmax(shift_logits, dim=-1)
            safe = torch.where(shift_labels == -100, 0, shift_labels)
            nll = -lp.gather(-1, safe[..., None].long())[..., 0]
            valid = (shift_labels != -100).float() * lm
            denom = (valid.sum() if count is None
                     else count(valid.sum())).clamp_min(1.0)
            seg_loss = (nll * valid).sum() / denom
            pred = shift_logits.argmax(dim=-1)
            out[f"{name}_nll"] = seg_loss
            out[f"{name}_acc"] = ((pred == shift_labels) * valid).sum() / denom
            loss = loss + (seg_loss * cfg.seq_loss_weight
                           if name == "sequence" else seg_loss)
        out["loss"] = loss
        return out

    # -- incremental decoding -----------------------------------------------
    def init_cache(self, B: int, T_max: int) -> list[dict]:
        """Each layer's zeroed K/V cache (B, T_max, H, Dh), on the model's
        device, in the compute dtype."""
        cfg = self.cfg
        dev = self.structure_head.weight.device
        shape = (B, T_max, cfg.n_heads, cfg.d_head)
        return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                 "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}
                for _ in range(cfg.n_layers)]

    def prefill(self, sequence_embeddings, bos_structure_tokens, caches,
                causal: Optional[torch.Tensor] = None):
        """Run the prompt (sequence part [+ separator] + the first structure
        token) through the stack, writing cache rows 0..T-1 in place.
        Returns (next-token float32 structure logits (B, V), T).
        ``causal``: the (T_max, T_max) lower-triangular table, made here
        when not given."""
        x = self._joint_embeds(sequence_embeddings, bos_structure_tokens)
        T = x.shape[1]
        if causal is None:
            causal = causal_table(caches[0]["k"].shape[1], x.device)
        mask = causal[:T][None, None]
        for blk, cache in zip(self.blocks, caches):
            x = blk(x, mask, cache=cache, cache_index=0)
        h = self.ln_f(x[:, -1:]).to(self.cfg.torch_dtype)
        return self.structure_head(h)[:, 0].float(), T

    def decode_step(self, token, position: int, caches,
                    pos_id: Optional[int] = None,
                    causal: Optional[torch.Tensor] = None):
        """One step over the structure segment: token (B,) at the absolute
        cache row ``position``, wpe index ``pos_id`` (default
        ``position``; under 'position' the structure segment restarts at
        0) -> float32 structure logits (B, V); caches written in place."""
        cfg = self.cfg
        if pos_id is None:
            pos_id = position
        if causal is None:
            causal = causal_table(caches[0]["k"].shape[1], token.device)
        x = self.struct_adapter(self.structure_embed(token[:, None]))
        if cfg.sep_strategy == "sentence":
            x = x + self.token_type.weight[1].to(cfg.torch_dtype)
        x = x + self.wpe.weight[pos_id].to(cfg.torch_dtype)
        key_ok = causal[position][None, None, None, :]
        for blk, cache in zip(self.blocks, caches):
            x = blk(x, key_ok, cache=cache, cache_index=position)
        h = self.ln_f(x).to(cfg.torch_dtype)
        return self.structure_head(h)[:, 0].float()


# The Dense leaves JLMConfig(quant="int8") swaps to QuantDense: the GPT-2
# block projections, with their biases.  The adapters, embeddings,
# LayerNorms and output heads stay floating point.
JLM_QUANT_NAMES = frozenset({"qkv", "attn_out", "mlp_up", "mlp_down"})


def quantize_jlm_params(state_dict: dict) -> dict:
    """A float32 JLM state dict -> the JLMConfig(quant="int8") layout."""
    return quantize_named_denses(state_dict, JLM_QUANT_NAMES)


@torch.no_grad()
def init_params(model: JLM, generator: torch.Generator) -> None:
    """Random weights at flax's initialisers' scales (not JAX's bits):
    ``nn.layers.init_params`` for the Dense, Embed and LayerNorm
    parameters, ``sep_token`` N(0, 1)."""
    init_dense_params(model, generator)
    if model.cfg.sep_strategy == "position":
        model.sep_token.normal_(0.0, 1.0, generator=generator)
