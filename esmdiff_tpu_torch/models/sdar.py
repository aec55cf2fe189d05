"""SDAR (arXiv:2510.06303; ``sdar_moe``, converted from Qwen3-MoE): a
pre-norm decoder whose attention is causal across blocks of tokens and
bidirectional inside a block, so that it generates block by block with a
KV cache of the committed blocks and denoises each block by masked
diffusion (``diffusion/block.py``).

A layer (n = RMSNorm, float32 inside, scaled in the model's dtype):

    h = x + W_o Attn(RoPE(n_q(W_q n(x))), RoPE(n_k(W_k n(x))), W_v n(x))
    y = h + MoE(n(h))                                   (``nn/moe.py``)

with n_q and n_k RMSNorms over each head's 128 (Qwen3-MoE's q_norm and
k_norm), RoPE (theta 1e6) over the whole head, grouped-query attention
(32 query heads sharing 4 KV heads) at scale 1/sqrt(128), and position i
seeing position j iff blk(j) <= blk(i).  logits = lm_head(n(y_48)), all
151,936 of them.  Runs in bf16, with the norms and the router softmax in
float32, as Qwen3-MoE does.

Protein tokens take rows of the published vocabulary: structure ids
0-4100 rows 0-4100, sequence ids 0-32 rows 4101-4133
(``SEQUENCE_OFFSET``); the prompt ([BOS, residues, EOS]) is one block.

Attention is grouped-query (query head h reads KV head h // 8).  A
cacheless forward (``forward_full``, the prefill) goes through
``F.scaled_dot_product_attention`` with ``enable_gqa`` and the
block-causal boolean mask.  A block's forward against the cache
(``block``) puts its queries over the cache's first ``start`` positions
followed by the block's own fresh keys and values (its first ``valid``
ones): the cache is preallocated at a fixed length and read whole, the
positions from ``start`` on masked, the scores in float32, so that its
shapes do not depend on where the block lies and the forward can be
captured once as a CUDA graph (``diffusion/block.py``).  The cache
(``KVCache``) is (layers, B, KV heads, T, head dim) for k and for v,
zeroed once; only a forward with ``write=True`` (the prefill and a
block's commit) writes it.

Tracing: ``sdar.attend`` spans around the attention cores and, in
``nn/moe.py``, ``moe.route`` and ``moe.experts``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.moe import Experts, MoE, Router, f32_bmm
from esmdiff_tpu_torch.nn.rotary import apply_rotary, rotary_tables
from esmdiff_tpu_torch.utils import tracing

SEQUENCE_OFFSET = C.STRUCTURE_VOCAB_SIZE      # 4101: sequence id 0's row
STRUCTURE_CODES = C.VQVAE_CODEBOOK_SIZE       # 4096: the codes sampled
# the published config's keys this model reads (``SDARConfig.from_hf``)
HF_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
           "num_key_value_heads", "head_dim", "moe_intermediate_size",
           "num_experts", "num_experts_per_tok", "norm_topk_prob",
           "rms_norm_eps", "rope_theta", "vocab_size")


@dataclasses.dataclass(frozen=True)
class SDARConfig:
    """The published ``sdar_moe`` keys (JetLM/SDAR-30B-A3B-Chat) and the
    compute dtype."""

    hidden_size: int = 2048
    num_hidden_layers: int = 48
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: int = 128
    moe_intermediate_size: int = 768
    num_experts: int = 128
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    vocab_size: int = 151936
    dtype: str = "bfloat16"

    @classmethod
    def tiny(cls, **kw) -> "SDARConfig":
        """The test widths: d 64, 4 query and 2 KV heads of 16, 8
        experts of 32 top 2, 2 layers, vocabulary 4,200."""
        return cls(**{**dict(hidden_size=64, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             head_dim=16, moe_intermediate_size=32,
                             num_experts=8, num_experts_per_tok=2,
                             vocab_size=4200), **kw})

    @classmethod
    def from_hf(cls, config: dict, **kw) -> "SDARConfig":
        """From a published ``config.json`` (its ``HF_KEYS``)."""
        return cls(**{**{k: config[k] for k in HF_KEYS}, **kw})

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


class RMSNorm(nn.Module):
    """Qwen3's RMSNorm: normalised in float32, cast back, then scaled."""

    def __init__(self, dim: int, eps: float, dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x):
        return self.weight * norm(x, self.eps)


def norm(x, eps):
    """x / rms(x) over the last axis, in float32, back in x's dtype."""
    return F.rms_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """k and v of every layer, (layers, B, KV heads, T, head dim)."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def empty(cls, cfg: SDARConfig, rows: int, length: int, device):
        shape = (cfg.num_hidden_layers, rows, cfg.num_key_value_heads,
                 length, cfg.head_dim)
        kw = dict(dtype=cfg.torch_dtype, device=device)
        return cls(torch.zeros(shape, **kw), torch.zeros(shape, **kw))


@dataclasses.dataclass
class Pass:
    """What every layer of one forward shares: the rotary tables of its
    positions, and either the mask among its own positions (no cache
    read) or the cache, the block's ``start`` and its ``valid`` positions;
    ``write`` puts its keys and values in the cache at its positions;
    ``routes`` (layers, B, n, k), if given, takes every layer's expert
    ids."""

    cos: torch.Tensor
    sin: torch.Tensor
    positions: torch.Tensor
    mask: Optional[torch.Tensor] = None
    cache: Optional[KVCache] = None
    read: bool = False
    start: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    write: bool = False
    routes: Optional[torch.Tensor] = None


def block_causal_mask(block_ids):
    """(n,) block of each position -> (n, n) bool: i sees j iff
    blk(j) <= blk(i)."""
    return block_ids[None, :] <= block_ids[:, None]


def cached_attention(q, k, v, kc, vc, start, valid):
    """q (B, w, H, Dh), the block's own k, v (B, w, KV, Dh), the cache's
    kc, vc (B, KV, T, Dh) -> (B, w, H * Dh): each query over the cache's
    positions before ``start`` and the block's first ``valid`` keys.
    Scores and softmax in float32, the weighted sum in the cache's
    dtype."""
    B, w, H, Dh = q.shape
    KV, T = kc.shape[1], kc.shape[2]
    G = H // KV
    qg = q.view(B, w, KV, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B * KV, G * w, Dh)
    s = torch.cat([
        f32_bmm(qg, kc.reshape(B * KV, T, Dh).transpose(1, 2)),
        f32_bmm(qg, k.permute(0, 2, 3, 1).reshape(B * KV, Dh, w))],
        dim=-1) * Dh ** -0.5
    keep = torch.cat([torch.arange(T, device=q.device) < start,
                      torch.arange(w, device=q.device) < valid])
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1).to(
        vc.dtype)
    o = torch.bmm(p[..., :T], vc.reshape(B * KV, T, Dh)) + torch.bmm(
        p[..., T:], v.permute(0, 2, 1, 3).reshape(B * KV, w, Dh))
    return o.view(B, KV, G, w, Dh).permute(0, 3, 1, 2, 4).reshape(
        B, w, H * Dh)


class Attention(nn.Module):
    def __init__(self, cfg: SDARConfig):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.torch_dtype
        self.h, self.kv, self.dh = (cfg.num_attention_heads,
                                    cfg.num_key_value_heads, cfg.head_dim)
        self.eps = cfg.rms_norm_eps
        # q_proj, k_proj and v_proj stacked: one product
        self.qkv_proj = nn.Linear(d, (self.h + 2 * self.kv) * self.dh,
                                  bias=False, dtype=dt)
        self.o_proj = nn.Linear(self.h * self.dh, d, bias=False, dtype=dt)
        self.q_norm = RMSNorm(self.dh, cfg.rms_norm_eps, dt)
        self.k_norm = RMSNorm(self.dh, cfg.rms_norm_eps, dt)

    def forward(self, x, fw: Pass, layer: int):
        B, n, _ = x.shape
        h, kv, dh = self.h, self.kv, self.dh
        qkv = self.qkv_proj(x).view(B, n, h + 2 * kv, dh)
        # q_norm and k_norm, then RoPE, on the q and k heads at once
        scale = torch.cat([self.q_norm.weight.expand(h, dh),
                           self.k_norm.weight.expand(kv, dh)])
        qk = apply_rotary(scale * norm(qkv[:, :, :h + kv], self.eps),
                          fw.cos, fw.sin)
        q, k, v = qk[:, :, :h], qk[:, :, h:], qkv[:, :, h + kv:]
        cache = fw.cache
        if fw.write:
            cache.k[layer].index_copy_(2, fw.positions, k.transpose(1, 2))
            cache.v[layer].index_copy_(2, fw.positions, v.transpose(1, 2))
        with tracing.span("sdar.attend"):
            if fw.read:
                o = cached_attention(q, k, v, cache.k[layer],
                                     cache.v[layer], fw.start, fw.valid)
            else:
                o = F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=fw.mask, scale=dh ** -0.5,
                    enable_gqa=True).transpose(1, 2).reshape(B, n, h * dh)
        return self.o_proj(o)


class Layer(nn.Module):
    def __init__(self, cfg: SDARConfig):
        super().__init__()
        d, dt = cfg.hidden_size, cfg.torch_dtype
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps, dt)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps, dt)
        self.mlp = MoE(d, cfg.moe_intermediate_size, cfg.num_experts,
                       cfg.num_experts_per_tok, cfg.norm_topk_prob, dt)

    def forward(self, x, fw: Pass, layer: int):
        h = x + self.self_attn(self.input_layernorm(x), fw, layer)
        return h + self.mlp(self.post_attention_layernorm(h),
                            None if fw.routes is None else fw.routes[layer])


class SDAR(nn.Module):
    """The model (module docstring); parameter names are the published
    ones without ``model.``, the experts stacked per layer."""

    def __init__(self, cfg: SDARConfig = SDARConfig()):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=dt)
        self.layers = nn.ModuleList(Layer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dt)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02):
        """Random weights: N(0, std) products and embeddings (Qwen3's
        ``initializer_range``), norms 1."""
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
            elif isinstance(m, (nn.Linear, nn.Embedding, Router)):
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, Experts):
                m.load(*(torch.empty(getattr(m, n).shape,
                                     device=m.w_down.device)
                         .normal_(0.0, std, generator=generator)
                         for n in ("w_gate_up", "w_down")))
        return self

    def new_cache(self, rows: int, length: int) -> KVCache:
        return KVCache.empty(self.cfg, rows, length,
                             self.embed_tokens.weight.device)

    def _run(self, tokens, positions, fw_kw: dict, head: bool):
        cos, sin = rotary_tables(tokens.shape[1], self.cfg.head_dim,
                                 base=self.cfg.rope_theta,
                                 device=tokens.device, positions=positions)
        fw = Pass(cos, sin, positions, **fw_kw)
        x = self.embed_tokens(tokens)
        for i, layer in enumerate(self.layers):
            x = layer(x, fw, i)
        return self.lm_head(self.norm(x)) if head else None

    def forward_full(self, tokens, block_ids):
        """The cacheless forward over whole rows: (B, n) tokens, (n,)
        block ids -> logits (B, n, V), position i seeing j iff
        blk(j) <= blk(i)."""
        n = tokens.shape[1]
        return self._run(tokens, torch.arange(n, device=tokens.device),
                         {"mask": block_causal_mask(block_ids)}, True)

    def prefill(self, tokens, cache: KVCache) -> None:
        """The prompt (one block, seen whole) at positions 0..P-1: its keys
        and values written to the cache."""
        P = tokens.shape[1]
        self._run(tokens, torch.arange(P, device=tokens.device),
                  {"cache": cache, "write": True}, False)

    def block(self, tokens, start, cache: KVCache, write: bool = False,
              head: bool = True, valid=None, routes=None):
        """A block of (B, w) tokens at positions start..start+w-1 (``start``
        an int or a 0-d tensor) against the cache's first ``start``
        positions and its own first ``valid`` (default w) -> logits (B, w,
        V) in the model's dtype, or None with ``head=False``; ``write``
        puts its keys and values in the cache; ``routes`` (layers, B, w,
        k), if given, takes every layer's expert ids."""
        w = tokens.shape[1]
        dev = tokens.device
        start = torch.as_tensor(start, device=dev)
        valid = torch.as_tensor(w if valid is None else valid, device=dev)
        return self._run(tokens, start + torch.arange(w, device=dev),
                         {"cache": cache, "read": True, "start": start,
                          "valid": valid, "write": write, "routes": routes},
                         head)

    def take_experts_hit(self) -> Optional[int]:
        """The experts hit since the last call, summed over layers and
        forwards (one device read; None while the tracer was off)."""
        hits = [h for h in (layer.mlp.take_hits() for layer in self.layers)
                if h is not None]
        return int(torch.stack(hits).sum()) if hits else None
