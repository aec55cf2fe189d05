"""Attention dispatch: the hand-written kernel path and the plain path.

Port of ``esmdiff_tpu/nn/attention.py``.  Masking contract:

  - ``lengths`` (B,) int32 — contiguous-prefix valid lengths (bucketed
    padding), or no mask at all.  With ``backend="auto"`` (the default) or
    ``"flash"`` it goes to ``ops.flash_attention`` (through its
    ``autograd.Function`` when autograd records: ``kernel_op``), which
    launches the CUDA kernel for a CUDA tensor and runs its plain version
    for a CPU tensor.  Unlike the JAX package
    "auto" has no length threshold (its ``_FLASH_MIN_LEN`` was tuned on
    another chip): every prefix-length attention on the card runs the
    kernel.
  - ``mask`` (B, 1|H, L, L) bool or an additive ``bias`` — arbitrary masks
    (packed ``sequence_id`` blocks, ...).  "auto" and "xla" send them to
    the plain path; "flash" raises, since the kernel takes neither (JAX
    raises on a mask and silently drops a bias there; the port raises on
    both).
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.ops import flash_attention as flash_ops

BACKENDS = ("auto", "flash", "xla")


def kernel_op(function, op):
    """What a module calls for a kernel: ``function.apply`` (the kernel's
    ``autograd.Function``, whose output carries a gradient) when autograd
    records, else ``op``, the kernel's wrapper.  Under ``no_grad``
    (sampling, decoding) an apply records nothing and only costs the host
    time, on paths the host bounds (PERF.md, PR 6)."""
    return function.apply if torch.is_grad_enabled() else op


def dot_product_attention(q, k, v, bias=None, mask=None, lengths=None,
                          backend: str = "auto"):
    """q,k,v: (B, L, H, Dh).  mask: (B, 1|H, L, L) bool, True = attend.
    lengths: (B,) int32 valid-prefix lengths (mutually exclusive with mask).
    backend: "auto" = the kernel path when there is no mask or bias, else
    the plain path; "flash" = the kernel path, raising on a mask or bias;
    "xla" = the plain path always.
    Softmax is accumulated in float32 whatever the io dtype."""
    if mask is not None and lengths is not None:
        raise ValueError("pass either `mask` or `lengths`, not both")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if backend == "flash" and (mask is not None or bias is not None):
        raise ValueError(
            "the flash path accepts only `lengths` (prefix padding); a mask "
            "or a bias must use the plain path (backend='xla'/'auto')")
    if backend != "xla" and mask is None and bias is None:
        return kernel_op(flash_ops.FlashAttentionFunction,
                         flash_ops.flash_attention)(q, k, v, lengths)
    return plain_attention(q, k, v, bias=bias, mask=_lengths_mask(q, lengths,
                                                                  mask))


def _lengths_mask(q, lengths, mask=None):
    """``mask``, or the (B, 1, 1, L) key mask of ``lengths`` when given."""
    if lengths is None:
        return mask
    key_ok = (torch.arange(q.shape[1], device=q.device)[None, :]
              < lengths.to(q.device)[:, None])
    return key_ok[:, None, None, :]


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


def plain_attention_with_lengths(q, k, v, lengths=None):
    """``plain_attention`` with prefix-length masking: the JAX
    ``_xla_attention_with_lengths``, through which the attention kernels'
    backwards recompute."""
    return plain_attention(q, k, v, mask=_lengths_mask(q, lengths))


def sequence_id_mask(sequence_id):
    """(B, L) int ids -> (B, 1, L, L) bool attention mask (same id attends)."""
    if sequence_id is None:
        return None
    m = sequence_id[:, None, :] == sequence_id[:, :, None]
    return m[:, None, :, :]
