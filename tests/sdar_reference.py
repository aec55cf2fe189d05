"""SDAR in plain float32 PyTorch: the forward over whole rows with the
block-causal mask and no cache, and the block sampler's update rule given
logits and uniforms.  Weights keyed by the published names
(``model.layers.{i}.mlp.experts.{e}.gate_proj.weight``, ...), the layer
equations of arXiv:2510.06303's ``sdar_moe`` (Qwen3-MoE's):

    h = x + W_o Attn(RoPE(n_q(W_q n(x))), RoPE(n_k(W_k n(x))), W_v n(x))
    y = h + sum_{e in top-k(p)} (p_e / sum_top-k p) W_down,e
            (silu(W_gate,e n(h)) * W_up,e n(h)),   p = softmax(W_router n(h))
    logits = W_head n(y_L)

It imports nothing of the port and no JAX; products run in float32 with
TF32 off (``set_precision``).  Departures from the published description:
none in the equations; the block structure (block 4, the prompt one block)
and the protein token rows are this repository's assumptions
(``models/sdar.py``), and the RoPE tables are computed in float32 from
float32 positions where Qwen3 casts them to the model's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MASK = 4096
CODES = 4096


def set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(positions, dim, theta):
    """(n,) positions -> cos, sin (n, dim): halves, NeoX style."""
    inv = 1.0 / theta ** (torch.arange(0, dim // 2, dtype=torch.float32,
                                       device=positions.device) / (dim // 2))
    f = positions.float()[:, None] * inv
    f = torch.cat([f, f], dim=-1)
    return f.cos(), f.sin()


def rotate(x, cos, sin):
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def attention(W, p, x, cos, sin, allowed, cfg):
    """x (B, n, D) normed; allowed (n, n) bool -> (B, n, D)."""
    B, n, _ = x.shape
    H, KV, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    q = (x @ W[p + "self_attn.q_proj.weight"].T).view(B, n, H, Dh)
    k = (x @ W[p + "self_attn.k_proj.weight"].T).view(B, n, KV, Dh)
    v = (x @ W[p + "self_attn.v_proj.weight"].T).view(B, n, KV, Dh)
    q = rotate(rms_norm(q, W[p + "self_attn.q_norm.weight"], eps),
               cos[:, None], sin[:, None])
    k = rotate(rms_norm(k, W[p + "self_attn.k_norm.weight"], eps),
               cos[:, None], sin[:, None])
    k = k.repeat_interleave(H // KV, dim=2)        # query head h: KV h // 8
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    s = s.masked_fill(~allowed, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return o.reshape(B, n, H * Dh) @ W[p + "self_attn.o_proj.weight"].T


def route(W, p, x, cfg):
    """x (T, D) normed -> (weights (T, k), ids (T, k), router logits)."""
    z = x @ W[p + "mlp.gate.weight"].T
    prob = torch.softmax(z, dim=-1)
    w, ids = torch.topk(prob, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return w, ids, z


def experts(W, p, x, w, ids):
    """The weighted sum of each token's experts: x (T, D), w and ids
    (T, k) -> (T, D)."""
    y = torch.zeros_like(x)
    for e in ids.unique().tolist():
        t, slot = (ids == e).nonzero(as_tuple=True)
        q = f"{p}mlp.experts.{e}."
        g = x[t] @ W[q + "gate_proj.weight"].T
        u = x[t] @ W[q + "up_proj.weight"].T
        o = (F.silu(g) * u) @ W[q + "down_proj.weight"].T
        y.index_add_(0, t, o * w[t, slot, None])
    return y


def moe(W, p, x, cfg):
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    w, ids, _ = route(W, p, x, cfg)
    return experts(W, p, x, w, ids).view(shape)


def forward(W, cfg, tokens, block_ids):
    """tokens (B, n) ids, block_ids (n,) -> float32 logits (B, n, V); i
    sees j iff blk(j) <= blk(i); positions 0..n-1."""
    n = tokens.shape[1]
    eps = cfg["rms_norm_eps"]
    cos, sin = rope(torch.arange(n, device=tokens.device), cfg["head_dim"],
                    cfg["rope_theta"])
    allowed = block_ids[None, :] <= block_ids[:, None]
    x = W["model.embed_tokens.weight"][tokens]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        x = x + attention(W, p, rms_norm(x, W[p + "input_layernorm.weight"],
                                         eps), cos, sin, allowed, cfg)
        x = x + moe(W, p, rms_norm(x, W[p + "post_attention_layernorm."
                                         "weight"], eps), cfg)
    return rms_norm(x, W["model.norm.weight"], eps) @ W["lm_head.weight"].T


def most_confident(conf, eligible, n_new):
    """Up to n_new of the most confident eligible positions by 30
    halvings of a per-row threshold, the row's most confident always
    included (the samplers' rule)."""
    c = torch.where(eligible, conf, -1e30)
    lo = torch.where(eligible, conf, torch.inf).amin(dim=-1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, 0.0) - 1.0
    hi = c.amax(dim=-1, keepdim=True)
    for _ in range(30):
        mid = (lo + hi) * 0.5
        over = (c >= mid).sum(dim=-1, keepdim=True) > n_new[:, None]
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    commit = eligible & (c >= hi)
    commit = commit | (eligible & (c >= c.amax(dim=-1, keepdim=True)))
    return commit & (n_new[:, None] > 0)


def block_update(x, logits, u, n_new, temperature=1.0):
    """x (B, m) the block (MASK where masked), logits (B, m, >= 4096), u
    (B, m, 4096) uniforms, n_new (B,) -> the block after one step:
    x^ = argmax(z / T + Gumbel(u)) over the codes, confidence p(x^) under
    softmax(z / T), the most confident masked positions committed."""
    z = logits[..., :CODES].float() / max(temperature, 1e-4)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    x_hat = (z + g).argmax(-1)
    conf = torch.softmax(z, -1).gather(-1, x_hat[..., None])[..., 0]
    commit = most_confident(conf, x == MASK, n_new)
    return torch.where(commit, x_hat, x)
