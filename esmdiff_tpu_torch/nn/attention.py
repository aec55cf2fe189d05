"""Attention dispatch: the hand-written kernel path and the plain path.

Port of ``esmdiff_tpu/nn/attention.py``.  Masking contract:

  - ``lengths`` (B,) int32 — contiguous-prefix valid lengths (bucketed
    padding), or no mask at all.  Goes to ``ops.flash_attention``, which
    launches the CUDA kernel for a CUDA tensor and runs its plain version
    for a CPU tensor.  Unlike the JAX package there is no length threshold
    (its ``_FLASH_MIN_LEN`` was tuned on another chip): every prefix-length
    attention on the card runs the kernel.
  - ``mask`` (B, 1|H, L, L) bool or an additive ``bias`` — arbitrary masks
    (packed ``sequence_id`` blocks, ...).  Plain path only.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(q, k, v, bias=None, mask=None, lengths=None):
    """q,k,v: (B, L, H, Dh).  mask: (B, 1|H, L, L) bool, True = attend.
    lengths: (B,) int32 valid-prefix lengths (mutually exclusive with mask).
    Softmax is accumulated in float32 whatever the io dtype."""
    if mask is not None and lengths is not None:
        raise ValueError("pass either `mask` or `lengths`, not both")
    if mask is None and bias is None:
        return flash_attention(q, k, v, lengths)
    if lengths is not None:
        key_ok = (torch.arange(q.shape[1], device=q.device)[None, :]
                  < lengths[:, None])
        mask = key_ok[:, None, None, :]
    return plain_attention(q, k, v, bias=bias, mask=mask)


def plain_attention(q, k, v, bias=None, mask=None):
    """The JAX package's ``_xla_attention``: float32 logits scaled by
    1/sqrt(Dh), masked logits filled with -1e9 (never -inf, so an all-masked
    row stays finite), normalised probabilities cast to v's dtype before P.V.
    """
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    probs = probs.to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


def sequence_id_mask(sequence_id):
    """(B, L) int ids -> (B, 1, L, L) bool attention mask (same id attends)."""
    if sequence_id is None:
        return None
    m = sequence_id[:, None, :] == sequence_id[:, :, None]
    return m[:, None, :, :]
