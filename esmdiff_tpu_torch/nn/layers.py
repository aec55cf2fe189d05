"""Core transformer building blocks of the ESM3 trunk, in PyTorch.

Port of ``esmdiff_tpu/nn/layers.py``: both ``qkv_backend``s, every
``attn_backend``, and ``quant="int8"`` (W8A8 projections, ``ops/quant.py``,
with the pre-projection LayerNorm's gamma folded into the weights).  Submodule and parameter
names follow the flax modules (``ln``, ``qkv``, ``q_ln``, ...), and the
fused-QKV path owns the same parameters as the unfused one, so
``convert`` maps a flax tree made with either backend onto a state dict
by renaming leaves only.

Dtypes follow flax: parameters are held in float32 (``param_dtype``) and a
module casts them to its compute ``dtype`` at use; ``cast_matmul_weights``
stores matmul weights in the compute dtype once (the same values the
per-use cast gives) so an inference forward does not re-cast them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.ops import fused_qkv as qkv_ops
from esmdiff_tpu_torch.ops import qk_norm_rotary as qkr_ops
from esmdiff_tpu_torch.ops import small_attention as small_ops
from esmdiff_tpu_torch.ops.quant import QuantDense

from .attention import dot_product_attention, kernel_op
from .rotary import apply_rotary

# the values the JAX package's ESM3Config takes
ATTN_BACKENDS = ("auto", "flash", "small", "xla")
QKV_BACKENDS = ("xla", "fused")
QUANT_MODES = ("none", "int8")


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W + b in ``dtype``; ``weight`` is (out, in),
    the transpose of the flax kernel."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embed(nn.Module):
    """flax ``nn.Embed``: the table is cast to ``dtype`` before the lookup."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx):
        return F.embedding(idx, self.weight.to(self.dtype))


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics (population variance, eps 1e-5), a
    scale and an optional bias (float32 at use, as flax promotes bfloat16
    parameters); returns the input's dtype.  With
    ``use_scale=False`` it owns no scale (the int8 path, where gamma is
    folded into the next projection's weights)."""

    def __init__(self, dim: int, use_bias: bool = False,
                 use_scale: bool = True):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(dim)) if use_bias else None

    def forward(self, x):
        scale, bias = (None if t is None else t.float()
                       for t in (self.scale, self.bias))
        y = F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps=1e-5)
        return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """ESM3 attention: LN -> QKV projection -> q/k LayerNorm over the full
    model dim -> rotary per head -> attention -> output projection; no
    biases.

    qkv_backend: "xla" = LayerNorm, Dense and q/k LayerNorm as separate
    ops; "fused" = one kernel (``ops/fused_qkv.py``) on the same parameters.
    With "xla", no ``tp``, bf16 heads of 64, an ``attn_backend`` other than
    "small" and autograd not recording (sampling, decoding), the q/k
    LayerNorm and rotary are one kernel (``ops/qk_norm_rotary.py``, which
    has no backward) that computes the same chain.
    attn_backend: "small" = rotary fused into the attention kernel
    (``ops/small_attention.py``) when there is no mask, else rotary and
    ``plain_attention``, as in JAX; "auto", "flash" and "xla" = rotary, then
    ``dot_product_attention`` with that backend.  When autograd records,
    the kernels are reached through their ``autograd.Function``s, so their
    outputs carry gradients (``kernel_op``).
    quant: "int8" = the qkv and output projections are ``QuantDense`` and
    ``ln`` owns no scale; it raises with ``qkv_backend="fused"``, as JAX.
    tp: set by ``parallel.tp.shard_modules`` when the projections hold this
    rank's heads only: q_ln/k_ln then sum their statistics over the model
    axis and the output is summed over it.
    """

    tp = None

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 attn_backend: str = "auto", qkv_backend: str = "xla",
                 quant: str = "none"):
        super().__init__()
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(f"attn_backend must be one of {ATTN_BACKENDS}; "
                             f"got {attn_backend!r}")
        if qkv_backend not in QKV_BACKENDS:
            raise ValueError(f"qkv_backend must be one of {QKV_BACKENDS}; "
                             f"got {qkv_backend!r}")
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}; got "
                             f"{quant!r}")
        if quant == "int8" and qkv_backend == "fused":
            raise ValueError("quant='int8' is incompatible with "
                             "qkv_backend='fused'")
        self.d_model, self.n_heads = d_model, n_heads
        self.attn_backend, self.qkv_backend = attn_backend, qkv_backend
        int8 = quant == "int8"
        proj = QuantDense if int8 else Dense
        self.ln = LayerNorm(d_model, use_scale=not int8)
        self.qkv = proj(d_model, 3 * d_model, use_bias=False, dtype=dtype)
        self.q_ln = LayerNorm(d_model)
        self.k_ln = LayerNorm(d_model)
        self.out = proj(d_model, d_model, use_bias=False, dtype=dtype)

    def forward(self, x, rot_cos, rot_sin, mask=None, lengths=None):
        B, L, _ = x.shape
        dh = self.d_model // self.n_heads
        tp = self.tp
        heads = self.n_heads if tp is None else self.n_heads // tp.size
        d = heads * dh
        rotated = False
        if self.qkv_backend == "fused":
            # weight.t() is a (D, 3D) view: the kernel reads it in place
            qkv = kernel_op(qkv_ops.FusedLnQkvFunction, qkv_ops.fused_ln_qkv)(
                x, self.ln.scale, self.qkv.weight.t().to(self.qkv.dtype),
                self.q_ln.scale, self.k_ln.scale)
            q, k, v = qkv.split(self.d_model, dim=-1)
        elif tp is None:
            q, k, v = self.qkv(self.ln(x)).split(self.d_model, dim=-1)
            rotated = (self.attn_backend != "small"
                       and q.dtype == torch.bfloat16
                       and dh == qkr_ops.HEAD_DIM
                       and not torch.is_grad_enabled())
            if rotated:
                q, k = qkr_ops.qk_norm_rotary(q, k, self.q_ln.scale,
                                              self.k_ln.scale, rot_cos,
                                              rot_sin)
            else:
                q, k = self.q_ln(q), self.k_ln(k)
        else:
            q, k, v = self.qkv(tp.copy(self.ln(x))).split(d, dim=-1)
            q = tp.layer_norm(q, self.q_ln.scale)
            k = tp.layer_norm(k, self.k_ln.scale)
        q = q.reshape(B, L, heads, dh)
        k = k.reshape(B, L, heads, dh)
        v = v.reshape(B, L, heads, dh)
        if self.attn_backend == "small" and mask is None:
            o = kernel_op(small_ops.SmallAttentionFunction,
                          small_ops.small_attention)(q, k, v, rot_cos,
                                                     rot_sin, lengths)
        else:
            if not rotated:
                q = apply_rotary(q, rot_cos, rot_sin)
                k = apply_rotary(k, rot_cos, rot_sin)
            o = dot_product_attention(
                q, k, v, mask=mask, lengths=lengths,
                backend="xla" if self.attn_backend == "small"
                else self.attn_backend)
        out = self.out(o.reshape(B, L, d))
        return out if tp is None else tp.reduce(out)


class SwiGLUFFN(nn.Module):
    """Pre-norm SwiGLU MLP: LN -> Dense(d, 2h) -> silu(a)*b -> Dense(h, d);
    with ``quant="int8"`` both projections are ``QuantDense`` and ``ln``
    owns no scale.  tp: as ``MultiHeadAttention``'s (this rank's hidden
    units of ``a`` and of ``b``; the output summed over the model axis)."""

    tp = None

    def __init__(self, d_model: int, hidden: int, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        int8 = quant == "int8"
        proj = QuantDense if int8 else Dense
        self.ln = LayerNorm(d_model, use_scale=not int8)
        self.up = proj(d_model, 2 * hidden, use_bias=False, dtype=dtype)
        self.down = proj(hidden, d_model, use_bias=False, dtype=dtype)

    def forward(self, x):
        h = self.ln(x)
        if self.tp is not None:
            h = self.tp.copy(h)
        a, b = self.up(h).chunk(2, dim=-1)
        out = self.down(F.silu(a) * b)
        return out if self.tp is None else self.tp.reduce(out)


def swiglu_hidden_dim(d_model: int, expansion_ratio: float = 8 / 3) -> int:
    """SwiGLU hidden width rounded up to a multiple of 256 (ESM3:
    d_model=1536 -> 4096)."""
    return int(((expansion_ratio * d_model) + 255) // 256 * 256)


class RegressionHead(nn.Module):
    """Dense -> exact (erf) GELU -> LayerNorm(+bias) -> Dense; float32 out."""

    def __init__(self, d_model: int, output_dim: int,
                 hidden_dim: Optional[int] = None, dtype=torch.bfloat16):
        super().__init__()
        hidden = hidden_dim or d_model
        self.dense = Dense(d_model, hidden, dtype=dtype)
        self.ln = LayerNorm(hidden, use_bias=True)
        self.out = Dense(hidden, output_dim, dtype=dtype)

    def forward(self, x):
        h = self.ln(F.gelu(self.dense(x)))
        return self.out(h).float()


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding (cos before sin) + 2-layer SiLU MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 max_period: float = 10000.0, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.frequency_embedding_size = frequency_embedding_size
        self.max_period = max_period
        self.fc1 = Dense(frequency_embedding_size, hidden_size, dtype=dtype)
        self.fc2 = Dense(hidden_size, hidden_size, dtype=dtype)

    def forward(self, t):
        half = self.frequency_embedding_size // 2
        freqs = torch.exp(
            -math.log(self.max_period)
            * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        return self.fc2(F.silu(self.fc1(emb.to(self.dtype))))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights with flax's default initialisers' scales: Dense
    kernels N(0, 1/fan_in), embeddings N(0, 1/num_embeddings), LayerNorm
    scale 1, every bias and every other parameter 0."""
    for m in module.modules():
        own = dict(m.named_parameters(recurse=False))
        if isinstance(m, Dense):
            m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                             generator=generator)
            own.pop("weight")
        elif isinstance(m, Embed):
            m.weight.normal_(0.0, m.weight.shape[0] ** -0.5,
                             generator=generator)
            own.pop("weight")
        elif isinstance(m, LayerNorm) and m.scale is not None:
            own.pop("scale").fill_(1.0)
        for p in own.values():
            p.zero_()


@torch.no_grad()
def cast_matmul_weights(module: nn.Module) -> nn.Module:
    """Store every Dense/Embed weight (and Dense bias) in its module's
    compute dtype.  Numerically the same as flax's cast at use."""
    for m in module.modules():
        if isinstance(m, (Dense, Embed)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(m.dtype)
    return module
