"""SDAR in plain float32 PyTorch, for the card: the benchmark's copy of the
repository's plain reference (``tests/sdar_reference.py``: the same layer
equations and the same block-sampler rule), arranged to judge the 30.5B
model one layer's float32 weights at a time.

    h = x + W_o Attn(RoPE(n_q(W_q n(x))), RoPE(n_k(W_k n(x))), W_v n(x))
    y = h + sum_{e in top-k(p)} (p_e / sum_top-k p) W_down,e
            (silu(W_gate,e n(h)) * W_up,e n(h)),   p = softmax(W_router n(h))
    logits = W_head n(y_L)

Weights keyed by the published names (``benchmark/weights_sdar.py``);
products in float32 with TF32 off (``model.set_precision``); nothing of the
port, no cache, no batching beyond the rows given.  ``forward`` takes the
weights as ``layer(i)`` (a dict for layer i, drawn on demand) and ``top``,
so that the whole model never sits on the card in float32.

Routing.  Where the program's top-k set differs from the reference's
only in experts whose router logits lie within ``margin`` of the
reference's k-th largest (rounding can order them either way), it is a
tie and the reference takes the program's set, weighted by its own
probabilities; any other difference is a mismatch (``route``).  The
stage checks compare routing so, from the program's own input to each
router.  The whole-row ``forward`` is given the program's sets for every
position and layer (``routes``) and takes them as they are: its input to
each router has drifted from the program's by the rounding of every layer
before it, so its own choice at a near tie says nothing of the program;
the logits it is compared on then measure the arithmetic, and the stage
checks the routing.

``Precision("fp8")`` (``model.py``'s) rounds both inputs of every
product, the attention's included, to float8 e4m3: the reference in the
precision below the configuration's bf16, the control of
``logits_rel_err``, and, on the router's product alone, of
``route_mismatch``.  ``W8A8`` rounds each row of both inputs to int8 by
its absolute maximum: on the expert products, per token and per output
channel (``ops/quant.py``'s scheme, written again here), the control of
``stage_err``.

Departures from the published description: none in the equations; the
RoPE tables are float32 (Qwen3 casts them to the model's dtype).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import Precision

MASK = 4096
F32 = Precision()
CODES = 4096


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


class W8A8:
    """Each row of a product's input rounded to int8 by its absmax / 127:
    the activations per token, the weights per output channel."""

    def __call__(self, x):
        s = (x.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-12)
        return torch.round(x / s).clamp(-127, 127) * s


def mm(x, w, prec=F32):
    """x @ w.T, both inputs rounded as ``prec`` says (float32: as given)."""
    return prec(x) @ prec(w).T


def qkv(W, p, x, cos, sin, cfg, prec=F32):
    """Normed x (B, n, D) -> q (B, n, H, Dh), k and v (B, n, KV, Dh), q and
    k normed per head and rotated."""
    B, n, _ = x.shape
    H, KV, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    eps = cfg["rms_norm_eps"]
    q = mm(x, W[p + "self_attn.q_proj.weight"], prec).view(B, n, H, Dh)
    k = mm(x, W[p + "self_attn.k_proj.weight"], prec).view(B, n, KV, Dh)
    v = mm(x, W[p + "self_attn.v_proj.weight"], prec).view(B, n, KV, Dh)
    q = rotate(rms_norm(q, W[p + "self_attn.q_norm.weight"], eps),
               cos[:, None], sin[:, None])
    k = rotate(rms_norm(k, W[p + "self_attn.k_norm.weight"], eps),
               cos[:, None], sin[:, None])
    return q, k, v


def attend(W, p, q, k, v, allowed, cfg, prec=F32):
    """q (B, n, H, Dh) over k, v (B, m, KV, Dh); allowed (n, m) bool or
    None -> the output projection's (B, n, D)."""
    B, n, H, Dh = q.shape
    k = k.repeat_interleave(H // k.shape[2], dim=2)   # query head h: KV h // 8
    v = v.repeat_interleave(H // v.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", prec(q), prec(k)) / math.sqrt(Dh)
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", prec(torch.softmax(s, -1)), prec(v))
    return mm(o.reshape(B, n, H * Dh), W[p + "self_attn.o_proj.weight"],
              prec)


def attention(W, p, x, cos, sin, allowed, cfg, prec=F32):
    """The cacheless attention of normed x (B, n, D)."""
    q, k, v = qkv(W, p, x, cos, sin, cfg, prec)
    return attend(W, p, q, k, v, allowed, cfg, prec)


def attention_after(W, p, x, cos, sin, k_before, v_before, cfg):
    """The attention of a block's normed x (B, n, D) at its positions
    (``cos``, ``sin``) over the keys and values of the positions before it
    (as the program's cache holds them) and its own."""
    q, k, v = qkv(W, p, x, cos, sin, cfg)
    return attend(W, p, q, torch.cat([k_before.float(), k], 1),
                  torch.cat([v_before.float(), v], 1), None, cfg)


def route(W, p, x, cfg, prog_ids=None, margin=None, prec=F32):
    """Normed x (T, D) -> (weights (T, k), ids (T, k), mismatches, ties):
    the reference's top-k of softmax(W_router x); given ``prog_ids``
    (T, k), the program's set where it ties within ``margin`` (module
    docstring), or everywhere when ``margin`` is None."""
    z = mm(x, W[p + "mlp.gate.weight"], prec)
    prob = torch.softmax(z, dim=-1)
    k = cfg["num_experts_per_tok"]
    ids = torch.topk(prob, k, dim=-1).indices
    mismatch = ties = 0
    if prog_ids is not None and margin is None:
        ids = prog_ids.to(ids.device).long()
    elif prog_ids is not None and prog_ids.shape[-1] != k:
        mismatch = int(prog_ids.shape[0])         # every set differs
    elif prog_ids is not None:
        prog_ids = prog_ids.to(ids.device)
        mine = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
        mine.scatter_(1, ids, True)
        theirs = torch.zeros_like(mine)
        theirs.scatter_(1, prog_ids.long(), True)
        differ = mine != theirs
        kth = z.gather(1, ids).amin(-1, keepdim=True)
        near = (z - kth).abs() <= margin
        tie = differ.any(-1) & ~(differ & ~near).any(-1)
        bad = differ.any(-1) & ~tie
        mismatch, ties = int(bad.sum()), int(tie.sum())
        ids = torch.where(tie[:, None], prog_ids.long(), ids)
    w = prob.gather(1, ids)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(-1, keepdim=True)
    return w, ids, mismatch, ties


def experts(W, p, x, w, ids, prec=F32):
    """The weighted sum of each token's experts: x (T, D), w and ids
    (T, k) -> (T, D)."""
    y = torch.zeros_like(x)
    for e in ids.unique().tolist():
        t, slot = (ids == e).nonzero(as_tuple=True)
        q = f"{p}mlp.experts.{e}."
        g = mm(x[t], W[q + "gate_proj.weight"], prec)
        u = mm(x[t], W[q + "up_proj.weight"], prec)
        o = mm(F.silu(g) * u, W[q + "down_proj.weight"], prec)
        y.index_add_(0, t, o * w[t, slot, None])
    return y


def moe(W, p, x, cfg, prog_ids=None, margin=None, prec=F32,
        expert_prec=None):
    """Normed x (..., D) -> (y, mismatches, ties); ``expert_prec``, if
    given, rounds the expert products' inputs in place of ``prec``."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    w, ids, bad, ties = route(W, p, x, cfg, prog_ids, margin, prec)
    return experts(W, p, x, w, ids, expert_prec or prec).view(shape), bad, \
        ties


def forward(layer, top, cfg, rows):
    """Whole rows through the model, each layer's weights drawn once
    (``layer(i)``): ``rows`` a list of (tokens (B, n) ids, block_ids (n,),
    routes or None) -> their float32 logits (B, n, V), position i seeing
    j iff blk(j) <= blk(i), positions 0..n-1; ``routes``: {i: the
    program's ids (B, n, k)}, taken as every position's experts."""
    eps = cfg["rms_norm_eps"]
    state = []
    for tokens, block_ids, routes in rows:
        n = tokens.shape[1]
        cos, sin = rope(torch.arange(n, device=tokens.device),
                        cfg["head_dim"], cfg["rope_theta"])
        state.append([top["model.embed_tokens.weight"][tokens], cos, sin,
                      block_ids[None, :] <= block_ids[:, None], routes])
    for i in range(cfg["num_hidden_layers"]):
        W, p = layer(i), f"model.layers.{i}."
        for s in state:
            x, cos, sin, allowed, routes = s
            x = x + attention(W, p, rms_norm(
                x, W[p + "input_layernorm.weight"], eps), cos, sin, allowed,
                cfg)
            prog = None if routes is None else routes[i].reshape(
                -1, routes[i].shape[-1])
            s[0] = x + moe(W, p, rms_norm(
                x, W[p + "post_attention_layernorm.weight"], eps), cfg,
                prog)[0]
        del W
    return [head(top, cfg, s[0]) for s in state]


def head(top, cfg, x, prec=F32):
    return mm(rms_norm(x, top["model.norm.weight"], cfg["rms_norm_eps"]),
              top["lm_head.weight"], prec)


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


def row_seed(request_seed: int, sample: int) -> int:
    return int(np.random.SeedSequence([int(request_seed), int(sample)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def block_uniforms(request_seed, samples, block_length, steps, device):
    """(steps, B, block_length, 4096): the uniforms of the first ``steps``
    steps (counted over the request) of the rows of ``samples``: one
    ``torch.Generator`` a row seeded by its (request seed, sample index),
    one (block_length, 4096) draw a step."""
    out = []
    for j in samples:
        gen = torch.Generator(device=device)
        gen.manual_seed(row_seed(request_seed, j))
        out.append(torch.stack([torch.rand((block_length, CODES),
                                           generator=gen, device=device)
                                for _ in range(steps)]))
    return torch.stack(out, dim=1)
