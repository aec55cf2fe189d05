"""Plain float32 PyTorch of the models the cells run, on weights keyed by
ESM3's names (``benchmark/weights.py``).

It follows ESM3's layer equations as the port's converter maps them: the
input tracks summed (sequence, structure with its specials tied to the
sequence's, the pLDDT RBF projections, SS8, SASA, the depth-8 function
table, residue annotations with pads left out), pre-norm blocks whose
residuals are scaled by 1/sqrt(n_layers/36) (LayerNorm -> QKV, q/k
LayerNorm over the full width, rotary on halves, softmax attention,
output projection; LayerNorm -> SwiGLU), a final LayerNorm, and regression
heads (Linear -> exact GELU -> LayerNorm -> Linear).  The VQ decoder is the
same stack at its own width without geometric attention, then a 6D
rotation head placing the idealised N, CA, C.  No kernel of the port, no
cache, no batching beyond the rows given.

Every product runs in float32 with TF32 off (``set_precision``).
``Precision("fp8")`` is the lower-precision control: both inputs of every
product, and q, k, v and the probabilities of attention, are rounded to
float8 e4m3 with one scale a tensor (a straight-through rounding, so the
backward runs too).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# ESM3's token ids (esm.utils.constants.esm3)
SEQ_VOCAB = ["<cls>", "<pad>", "<eos>", "<unk>", "L", "A", "G", "V", "S",
             "E", "R", "T", "I", "D", "P", "K", "Q", "N", "F", "Y", "M", "H",
             "W", "C", "X", "B", "U", "Z", "O", ".", "-", "|", "<mask>"]
SEQ_BOS, SEQ_PAD, SEQ_EOS, SEQ_UNK, SEQ_CHAINBREAK = 0, 1, 2, 3, 31
STRUCT_MASK, STRUCT_EOS, STRUCT_BOS, STRUCT_PAD, STRUCT_CHAINBREAK = (
    4096, 4097, 4098, 4099, 4100)
FUNCTION_VOCAB, FUNCTION_DEPTH = 260, 8
# the idealised backbone (N, CA, C) the decoder's frames place
IDEAL_BACKBONE = ((-0.5272, 1.3593, 0.0), (0.0, 0.0, 0.0), (1.5233, 0.0, 0.0))


def set_precision() -> None:
    """float32 products stay float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def encode_sequence(seq: str) -> list[int]:
    """ESM3's sequence tokens with BOS and EOS."""
    ids = {t: i for i, t in enumerate(SEQ_VOCAB)}
    return [SEQ_BOS] + [ids.get(c, SEQ_UNK) for c in seq] + [SEQ_EOS]


class Precision:
    """How the products round their inputs: "float32" (not at all) or
    "fp8" (e4m3, one scale a tensor)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x):
        if self.kind == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (q - x.detach())

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)


def layer_norm(x, w, b=None):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=1e-5)


def rotary(positions, head_dim: int):
    """cos, sin of shape positions.shape + (head_dim,): frequencies
    10000^(-i/half) repeated over both halves."""
    half = head_dim // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    f = positions.float()[..., None] * inv
    f = torch.cat([f, f], dim=-1)
    return f.cos(), f.sin()


def _rot(x, cos, sin):
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + turned * sin


def attention(q, k, v, allowed, prec: Precision):
    """q, k, v (B, L, H, Dh); allowed (B, 1, L, L) bool."""
    s = torch.einsum("blhd,bmhd->bhlm", prec(q), prec(k)) / math.sqrt(
        q.shape[-1])
    s = s.masked_fill(~allowed, -1e9)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", prec(p), prec(v))


def attn_sub(W, p, x, cos, sin, allowed, n_heads, prec):
    """A block's attention sublayer (before the residual's scale)."""
    B, L, d = x.shape
    h = layer_norm(x, W[f"{p}.attn.layernorm_qkv.0.weight"])
    q, k, v = prec.linear(h, W[f"{p}.attn.layernorm_qkv.1.weight"]).split(
        d, dim=-1)
    q = layer_norm(q, W[f"{p}.attn.q_ln.weight"])
    k = layer_norm(k, W[f"{p}.attn.k_ln.weight"])
    dh = d // n_heads
    q, k, v = (t.reshape(B, L, n_heads, dh) for t in (q, k, v))
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    o = attention(_rot(q, c, s), _rot(k, c, s), v, allowed, prec)
    return prec.linear(o.reshape(B, L, d), W[f"{p}.attn.out_proj.weight"])


def ffn_sub(W, p, x, prec):
    """A block's SwiGLU sublayer (before the residual's scale)."""
    h = layer_norm(x, W[f"{p}.ffn.0.weight"])
    a, g = prec.linear(h, W[f"{p}.ffn.1.weight"]).chunk(2, dim=-1)
    return prec.linear(F.silu(a) * g, W[f"{p}.ffn.3.weight"])


def block(W, p, x, cos, sin, allowed, n_heads, scale, prec):
    x = x + attn_sub(W, p, x, cos, sin, allowed, n_heads, prec) / scale
    return x + ffn_sub(W, p, x, prec) / scale


def stack(W, prefix, x, positions, allowed, n_heads, n_layers, prec,
          remat: bool = False):
    """The blocks and the final LayerNorm; ``remat`` recomputes each block
    in the backward (memory only: the same function)."""
    cos, sin = rotary(positions, x.shape[-1] // n_heads)
    scale = math.sqrt(n_layers / 36.0)
    for i in range(n_layers):
        args = (W, f"{prefix}.blocks.{i}", x, cos, sin, allowed, n_heads,
                scale, prec)
        x = (checkpoint(block, *args, use_reentrant=False) if remat
             else block(*args))
    return layer_norm(x, W[f"{prefix}.norm.weight"])


def head(W, p, x, prec):
    h = F.gelu(prec.linear(x, W[f"{p}.0.weight"], W[f"{p}.0.bias"]))
    h = layer_norm(h, W[f"{p}.2.weight"], W[f"{p}.2.bias"])
    return prec.linear(h, W[f"{p}.3.weight"], W[f"{p}.3.bias"])


def rbf(v, n_bins: int = 16):
    centers = torch.linspace(0.0, 1.0, n_bins, device=v.device)
    z = (v[..., None] - centers) / (1.0 / n_bins)
    return torch.exp(-z * z)


def embed(W, seq_tokens, struct_tokens, prec):
    """The summed input tracks, every track but sequence and structure at
    its default (pLDDT 1 on average, 0 per residue, pads elsewhere)."""
    B, L = seq_tokens.shape
    dev = seq_tokens.device
    st = torch.where(struct_tokens == -1, STRUCT_MASK, struct_tokens)
    for s_tok, st_tok in ((SEQ_BOS, STRUCT_BOS), (SEQ_PAD, STRUCT_PAD),
                          (SEQ_EOS, STRUCT_EOS),
                          (SEQ_CHAINBREAK, STRUCT_CHAINBREAK)):
        st = torch.where(seq_tokens == s_tok, st_tok, st)
    x = W["encoder.sequence_embedding.weight"][seq_tokens]
    x = x + W["encoder.structure_tokens_embedding.weight"][st]
    ones, zeros = (torch.full((B, L), v, device=dev) for v in (1.0, 0.0))
    x = x + prec.linear(rbf(ones), W["encoder.plddt_projection.weight"])
    x = x + prec.linear(rbf(zeros), W[
        "encoder.structure_per_res_plddt_projection.weight"])
    x = x + W["encoder.ss8_embedding.weight"][0]
    x = x + W["encoder.sasa_embedding.weight"][0]
    fn = W["encoder.function_embeddings.weight"]
    pad_rows = torch.arange(FUNCTION_DEPTH, device=dev) * FUNCTION_VOCAB
    x = x + fn[pad_rows].reshape(-1)          # depth slices concatenated
    return x                                  # residue annotations: all pad


def sigma_embed(W, sigma, prec, freq: int = 256):
    """DiT's timestep embedder on sigma: [cos, sin] of 256 frequencies,
    Linear -> SiLU -> Linear."""
    half = freq // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=sigma.device) / half)
    a = sigma.float()[:, None] * f[None]
    e = torch.cat([torch.cos(a), torch.sin(a)], dim=-1)
    h = F.silu(prec.linear(e, W["sigma_embedder.mlp.0.weight"],
                           W["sigma_embedder.mlp.0.bias"]))
    return prec.linear(h, W["sigma_embedder.mlp.2.weight"],
                       W["sigma_embedder.mlp.2.bias"])


def key_mask(lengths, L):
    """(B, 1, L, L) bool: every query attends keys < its row's length."""
    ok = torch.arange(L, device=lengths.device)[None, :] < lengths[:, None]
    return ok[:, None, None, :].expand(-1, 1, L, -1)


def segment_mask(segment_ids):
    """(B, 1, L, L) bool: tokens attend their own segment (pads, id -1,
    attend pads)."""
    return (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]


def trunk_logits(W, cfg, seq_tokens, struct_tokens, allowed, positions,
                 aux=None, prec: Precision = Precision(), remat=False):
    """Structure logits (B, L, V) of the trunk: ``aux`` (B, L, d) is added
    to the embedded tracks (the time conditioning)."""
    x = embed(W, seq_tokens, struct_tokens, prec)
    if aux is not None:
        x = x + aux
    x = stack(W, "transformer", x, positions, allowed, cfg["n_heads"],
              cfg["n_layers"], prec, remat=remat)
    return head(W, "output_heads.structure_head", x, prec)


def decode_backbone(W, cfg, tokens, prec: Precision = Precision()):
    """(B, L) structure tokens with BOS and EOS, every position valid ->
    (B, L, 3, 3) N, CA, C."""
    B, L = tokens.shape
    x = W["embed.weight"][tokens]
    pos = torch.arange(L, device=tokens.device).expand(B, L)
    allowed = torch.ones((B, 1, L, L), dtype=torch.bool,
                         device=tokens.device)
    x = stack(W, "decoder_stack", x, pos, allowed, cfg["n_heads"],
              cfg["n_layers"], prec)
    p = "affine_output_projection"
    h = F.gelu(prec.linear(x, W[f"{p}.ffn1.weight"], W[f"{p}.ffn1.bias"]))
    h = layer_norm(h, W[f"{p}.norm.weight"], W[f"{p}.norm.bias"])
    out = prec.linear(h, W[f"{p}.proj.weight"], W[f"{p}.proj.bias"])
    v1, v2, trans = out[..., 0:3], out[..., 3:6], out[..., 6:9]
    e1 = v1 / v1.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    u2 = v2 - e1 * (e1 * v2).sum(dim=-1, keepdim=True)
    e2 = u2 / u2.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    rot = torch.stack([e1, e2, torch.linalg.cross(e1, e2, dim=-1)], dim=-1)
    ideal = torch.tensor(IDEAL_BACKBONE, device=tokens.device)
    return (torch.einsum("...ij,aj->...ai", rot, ideal)
            + cfg["trans_scale"] * trans[..., None, :])
