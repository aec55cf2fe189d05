"""Rotary position embeddings (GPT-NeoX style, non-interleaved halves).

Port of ``esmdiff_tpu/nn/rotary.py``: the tables repeat the frequencies over
both halves (``cat([freqs, freqs])``) and ``_rotate_half`` is ``[-x2, x1]``.
The tables are computed once per forward and shared by every layer.
"""

from __future__ import annotations

import torch


def rotary_tables(length: int, head_dim: int, base: float = 10000.0,
                  dtype=torch.float32, device=None):
    """Return (cos, sin), each (length, head_dim)."""
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    pos = torch.arange(length, dtype=torch.float32, device=device)
    freqs = pos[:, None] * inv_freq                    # (L, half)
    emb = torch.cat([freqs, freqs], dim=-1)            # (L, head_dim)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x, cos, sin):
    """x: (B, L, H, Dh); cos/sin: (L, Dh) -> same shape and dtype as x.

    The products run in the tables' dtype (float32), as JAX promotes them."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    xf = x.to(cos.dtype)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_rotary_per_term(x, cos, sin):
    """``apply_rotary``'s value, with each term promoted to the tables'
    dtype on its own, as JAX promotes them: a backward through it in bf16
    rounds each term's gradient to x's dtype before the two are added, as
    JAX's does.  For recomputes under a backward; it converts x twice."""
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    return (x.to(cos.dtype) * cos
            + _rotate_half(x).to(cos.dtype) * sin).to(x.dtype)
