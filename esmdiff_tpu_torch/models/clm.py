"""Conditional language model over structure tokens (T5-style
encoder-decoder), in PyTorch: port of ``esmdiff_tpu/models/clm.py``.

An encoder over per-residue ESM3 embeddings (a ``cond_dim -> d_model``
adapter) and an autoregressive decoder over structure tokens: RMSNorm
(float32, eps 1e-6), relative-position-bucket attention bias, no 1/sqrt(d)
score scale, gated-GELU FFN (tanh GELU, as flax's ``nn.gelu``), no biases.
Scores are float32 products of the float32-cast q and k, masked with -1e9,
and the probabilities are cast to v's dtype before the PV product, as in
JAX.  The variants ``decoder_only`` (no encoder stack: the adapter output
is the memory) and ``dec_add_input_emb`` (the decoder input adds the
memory at its position) are those of the JAX config.

Module and parameter names are the flax ones (``enc<i>``/``dec<i>`` become
``enc_blocks.<i>``/``dec_blocks.<i>``), so ``convert.load_flax_params``
carries a flax tree over strictly.

Incremental decoding: ``init_cache`` allocates each decoder layer's K/V
cache once, ``decode_step`` writes position ``pos`` in place and attends
over the whole preallocated cache masked by ``arange(L_max) <= pos``.
``decode_context`` computes, once per generate, what JAX recomputes every
step: the (L_max, L_max) relative bias table and each layer's
cross-attention K and V over the memory.  The attention is plain PyTorch
(matmul, softmax, ``where``), as JAX computes it outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.layers import Dense, Embed
from esmdiff_tpu_torch.nn.layers import init_params as init_dense_params
from esmdiff_tpu_torch.ops.quant import QuantDense, quantize_named_denses


@dataclasses.dataclass(frozen=True)
class CLMConfig:
    vocab_size: int = C.STRUCTURE_VOCAB_SIZE        # 4101
    d_model: int = 1024
    d_ff: int = 1024
    n_layers: int = 12
    n_heads: int = 16
    dropout: float = 0.1
    cond_dim: int = C.ESM3_D_MODEL                  # 1536 ESM3 embeddings
    pad_token_id: int = C.STRUCTURE_PAD_TOKEN       # 4099
    decoder_start_token_id: int = C.STRUCTURE_PAD_TOKEN
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    decoder_only: bool = False
    dec_add_input_emb: bool = False
    dtype: str = "bfloat16"
    # "int8" = W8A8 attention/FFN projections (ops/quant.py), inference
    # only; weights converted by quantize_clm_params
    quant: str = "none"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads


class RMSNorm(nn.Module):
    """T5 layer norm: no mean subtraction, no bias, float32 statistics;
    returns the input's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + 1e-6) * self.scale).to(x.dtype)


def relative_position_bucket(rel, bidirectional: bool, num_buckets: int,
                             max_distance: int):
    """T5 bucketing of ``rel`` = query_pos - key_pos (an integer tensor).

    HF buckets n = -rel: bidirectional puts future keys (n > 0) in the
    upper half of the table, causal buckets past keys by max(rel, 0).  The
    large-distance branch is float32 ``log(n / max_exact + 1e-6)``,
    truncated by an int32 cast, as in JAX."""
    ret = torch.zeros_like(rel, dtype=torch.int32)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = (-n).clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # float32 throughout, each constant rounded to float32 as JAX's weak
    # types round them
    ratio = torch.log(n.float() / np.float32(max_exact) + np.float32(1e-6))
    scaled = (ratio / np.float32(math.log(max_distance / max_exact))
              * np.float32(num_buckets - max_exact))
    val_if_large = max_exact + scaled.to(torch.int32)
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class RelPosBias(nn.Module):
    """The learned (buckets, H) table; ``forward(q_pos, k_pos)`` ->
    float32 bias (1, H, Lq, Lk)."""

    def __init__(self, cfg: CLMConfig, bidirectional: bool):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.weight = nn.Parameter(torch.empty(cfg.rel_pos_buckets,
                                               cfg.n_heads))

    def forward(self, q_pos, k_pos):
        buckets = relative_position_bucket(
            q_pos[:, None] - k_pos[None, :], self.bidirectional,
            self.cfg.rel_pos_buckets, self.cfg.rel_pos_max_distance)
        return self.weight.float()[buckets.long()].permute(2, 0, 1)[None]


def causal_table(L_max: int, device) -> torch.Tensor:
    """(L_max, L_max) bool: row p is ``arange(L_max) <= p``."""
    return torch.ones(L_max, L_max, dtype=torch.bool, device=device).tril()


def _dense(cfg, d_in: int, d_out: int):
    """A bias-free projection honouring ``cfg.quant``."""
    if cfg.quant == "int8":
        return QuantDense(d_in, d_out, use_bias=False, dtype=cfg.torch_dtype)
    return Dense(d_in, d_out, use_bias=False, dtype=cfg.torch_dtype)


def attend(q, k, v, bias=None, mask=None, scale: Optional[float] = None):
    """q (B, Lq, H, Dh), k and v (B, Lk, H, Dh) -> (B, Lq, H, Dh).  Float32
    scores of the float32-cast operands (divided by ``scale`` when given),
    plus ``bias``, masked to -1e9 where ``mask`` is False; the softmax's
    probabilities cast to v's dtype before the PV product."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    if scale is not None:
        s = s / scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = torch.where(mask, s, -1e9)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", p, v)


class T5Attention(nn.Module):
    def __init__(self, cfg: CLMConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.q, self.k, self.v, self.o = (_dense(cfg, D, D) for _ in range(4))

    def heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.cfg.n_heads,
                         self.cfg.d_head)

    def kv(self, memory):
        """(K, V) heads of ``memory`` (B, L, D)."""
        return self.heads(self.k(memory)), self.heads(self.v(memory))

    def forward(self, x, kv=None, bias=None, mask=None, cache=None,
                cache_index: Optional[int] = None, kv_heads=None):
        """Self-attention when ``kv`` and ``kv_heads`` are None,
        cross-attention over ``kv`` (B, Lk, D) otherwise, or over its
        precomputed ``kv_heads`` = ``self.kv(kv)``.  ``cache`` (dict of
        k, v (B, L_max, H, Dh)) is written at ``cache_index`` in place and
        attended whole."""
        q = self.heads(self.q(x))
        if kv_heads is not None:
            k, v = kv_heads
        else:
            k, v = self.kv(x if kv is None else kv)
        if cache is not None:
            L = k.shape[1]
            cache["k"][:, cache_index:cache_index + L] = k
            cache["v"][:, cache_index:cache_index + L] = v
            k, v = cache["k"], cache["v"]
        o = attend(q, k, v, bias=bias, mask=mask)
        return self.o(o.reshape(x.shape[0], x.shape[1], self.cfg.d_model))


class T5FFN(nn.Module):
    def __init__(self, cfg: CLMConfig):
        super().__init__()
        self.wi_0 = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.wi_1 = _dense(cfg, cfg.d_model, cfg.d_ff)
        self.wo = _dense(cfg, cfg.d_ff, cfg.d_model)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh")
                       * self.wi_1(x))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: CLMConfig):
        super().__init__()
        self.ln1, self.attn = RMSNorm(cfg.d_model), T5Attention(cfg)
        self.ln2, self.ffn = RMSNorm(cfg.d_model), T5FFN(cfg)

    def forward(self, x, bias, mask):
        x = x + self.attn(self.ln1(x), bias=bias, mask=mask)
        return x + self.ffn(self.ln2(x))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: CLMConfig):
        super().__init__()
        self.ln1, self.self_attn = RMSNorm(cfg.d_model), T5Attention(cfg)
        self.ln2, self.cross_attn = RMSNorm(cfg.d_model), T5Attention(cfg)
        self.ln3, self.ffn = RMSNorm(cfg.d_model), T5FFN(cfg)

    def forward(self, x, enc, self_bias, self_mask, cross_mask, cache=None,
                cache_index=None, cross_kv=None):
        x = x + self.self_attn(self.ln1(x), bias=self_bias, mask=self_mask,
                               cache=cache, cache_index=cache_index)
        x = x + self.cross_attn(self.ln2(x), kv=enc, mask=cross_mask,
                                kv_heads=cross_kv)
        return x + self.ffn(self.ln3(x))


@dataclasses.dataclass
class DecodeContext:
    """What every decode step of one generate shares: the (1, H, L_max,
    L_max) float32 relative bias, the (L_max, L_max) causal table (row
    ``pos`` is ``arange(L_max) <= pos``), the cross-attention mask and
    each decoder layer's cross-attention (K, V)."""

    bias: torch.Tensor
    causal: torch.Tensor
    cross_mask: Optional[torch.Tensor]
    cross_kv: list


class CLM(nn.Module):
    """Encoder-decoder over (ESM3 embeddings -> structure tokens)."""

    def __init__(self, cfg: CLMConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.adapter = Dense(cfg.cond_dim, cfg.d_model, use_bias=False,
                             dtype=dt)
        self.token_embed = Embed(cfg.vocab_size, cfg.d_model, dtype=dt)
        if not cfg.decoder_only:    # flax creates no encoder params then
            self.enc_blocks = nn.ModuleList(
                EncoderBlock(cfg) for _ in range(cfg.n_layers))
            self.enc_norm = RMSNorm(cfg.d_model)
            self.enc_relpos = RelPosBias(cfg, bidirectional=True)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(cfg) for _ in range(cfg.n_layers))
        self.dec_norm = RMSNorm(cfg.d_model)
        self.dec_relpos = RelPosBias(cfg, bidirectional=False)
        # stays floating point with quant="int8": it writes the logits
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False,
                             dtype=dt)

    def encode(self, inputs_embeds, attention_mask=None):
        """(B, L, cond_dim) -> the memory (B, L, d_model)."""
        x = self.adapter(inputs_embeds.to(self.cfg.torch_dtype))
        if self.cfg.decoder_only:
            return x
        pos = torch.arange(x.shape[1], device=x.device)
        bias = self.enc_relpos(pos, pos)
        mask = (None if attention_mask is None
                else attention_mask[:, None, None, :].bool())
        for blk in self.enc_blocks:
            x = blk(x, bias, mask)
        return self.enc_norm(x)

    def decode_train(self, decoder_input_ids, enc, enc_mask=None,
                     cond_embeds=None):
        """Teacher-forced decoder: (B, L) ids -> float32 logits (B, L, V)."""
        x = self.token_embed(decoder_input_ids)
        if self.cfg.dec_add_input_emb and cond_embeds is not None:
            x = x + cond_embeds.to(x.dtype)
        L = x.shape[1]
        pos = torch.arange(L, device=x.device)
        bias = self.dec_relpos(pos, pos)
        causal = causal_table(L, x.device)[None, None]
        cross_mask = (None if enc_mask is None
                      else enc_mask[:, None, None, :].bool())
        for blk in self.dec_blocks:
            x = blk(x, enc, bias, causal, cross_mask)
        return self.lm_head(self.dec_norm(x)).float()

    def forward(self, inputs_embeds, labels=None, attention_mask=None,
                decoder_input_ids=None, count=None):
        """The training forward: {"logits", "loss" when labels are given};
        labels -100 are ignored, the decoder input is the start token then
        the labels shifted right.  The loss is the sum of the labels'
        cross-entropies over ``count`` of their number (default the number
        itself: the batch's mean; ``RowShard.sum``: this batch's part of a
        global batch's mean)."""
        enc = self.encode(inputs_embeds, attention_mask)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("pass labels or decoder_input_ids")
            start = torch.full((labels.shape[0], 1),
                               self.cfg.decoder_start_token_id,
                               dtype=labels.dtype, device=labels.device)
            safe_labels = torch.where(labels == -100, self.cfg.pad_token_id,
                                      labels)
            decoder_input_ids = torch.cat([start, safe_labels[:, :-1]], 1)
        cond = enc if self.cfg.dec_add_input_emb else None
        logits = self.decode_train(decoder_input_ids, enc, attention_mask,
                                   cond_embeds=cond)
        out = {"logits": logits}
        if labels is not None:
            lp = torch.log_softmax(logits, dim=-1)
            safe = torch.where(labels == -100, 0, labels)
            nll = -lp.gather(-1, safe[..., None].long())[..., 0]
            valid = (labels != -100).float()
            n = valid.sum() if count is None else count(valid.sum())
            out["loss"] = (nll * valid).sum() / n.clamp_min(1.0)
        return out

    # -- incremental decoding -----------------------------------------------
    def init_cache(self, B: int, L_max: int) -> list[dict]:
        """Each decoder layer's zeroed K/V cache (B, L_max, H, Dh), on the
        model's device, in the compute dtype."""
        cfg = self.cfg
        dev = self.lm_head.weight.device
        shape = (B, L_max, cfg.n_heads, cfg.d_head)
        return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
                 "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}
                for _ in range(cfg.n_layers)]

    def decode_context(self, enc, L_max: int, enc_mask=None
                       ) -> DecodeContext:
        """The steps' shared tensors (``DecodeContext``) for memory ``enc``
        and caches of length ``L_max``."""
        pos = torch.arange(L_max, device=enc.device)
        return DecodeContext(
            bias=self.dec_relpos(pos, pos),
            causal=causal_table(L_max, enc.device),
            cross_mask=(None if enc_mask is None
                        else enc_mask[:, None, None, :].bool()),
            cross_kv=[blk.cross_attn.kv(enc) for blk in self.dec_blocks])

    def decode_step(self, token, position: int, enc, caches,
                    enc_mask=None, cond_embed=None,
                    context: Optional[DecodeContext] = None):
        """One decoder step: token (B,) at ``position`` -> float32 logits
        (B, V); the caches are written in place.  ``context`` (from
        ``decode_context``) is computed here when not given."""
        if context is None:
            context = self.decode_context(enc, caches[0]["k"].shape[1],
                                          enc_mask)
        x = self.token_embed(token[:, None])
        if self.cfg.dec_add_input_emb and cond_embed is not None:
            x = x + cond_embed[:, None].to(x.dtype)
        bias = context.bias[:, :, position:position + 1]
        key_ok = context.causal[position][None, None, None, :]
        for blk, cache, kv in zip(self.dec_blocks, caches,
                                  context.cross_kv):
            x = blk(x, enc, bias, key_ok, context.cross_mask, cache=cache,
                    cache_index=position, cross_kv=kv)
        return self.lm_head(self.dec_norm(x))[:, 0].float()


# The Dense leaves CLMConfig(quant="int8") swaps to QuantDense: each
# block's q/k/v/o projections (self- and cross-attention) and its gated-GELU
# FFN.  The adapter, embeddings, RMSNorms and lm_head stay floating point.
CLM_QUANT_NAMES = frozenset({"q", "k", "v", "o", "wi_0", "wi_1", "wo"})


def quantize_clm_params(state_dict: dict) -> dict:
    """A float32 CLM state dict -> the CLMConfig(quant="int8") layout."""
    return quantize_named_denses(state_dict, CLM_QUANT_NAMES)


@torch.no_grad()
def init_params(model: CLM, generator: torch.Generator) -> None:
    """Random weights at flax's initialisers' scales (not JAX's bits):
    ``nn.layers.init_params`` for the Dense and Embed weights, RMSNorm
    scales 1, relative-position tables N(0, 0.02)."""
    init_dense_params(model, generator)
    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.scale.fill_(1.0)
        elif isinstance(m, RelPosBias):
            m.weight.normal_(0.0, 0.02, generator=generator)
