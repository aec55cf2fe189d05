"""Rotary + prefix-length masked attention: hand-written CUDA kernel + plain
version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/small_attention.py::
_kernel`` (:55, launched at :155), the ``attn_backend="small"`` path.  For
q, k, v of shape (B, L, H, Dh) BEFORE rotary, (L, Dh) cos/sin tables and
``lengths`` (B,) int32 (or None: all L), it rotates q and k in fp32
(GPT-NeoX half rotation) and rounds them to v's dtype, then computes the
attention of ``ops/flash_attention.py``: fp32 logits scaled by 1/sqrt(Dh),
keys at positions >= lengths[b] filled with -1e9, p = exp(logits - rowmax)
cast to v's dtype before p.v, output times 1/sum(p).  p is cast before it
is normalised, as the TPU kernel does; the JAX ``_xla_reference`` (its
backward) normalises first, and the two agree in fp32.

The kernel (``csrc/small_attention.cu`` over ``csrc/attention_tiles.cuh``)
is CUDA C++ for ``sm_90a``, built by ``ops/_build.py``: the flash kernel's
design, with the block's cos and sin rows staged in shared memory once and
each q and k row rotated in place there, once per block, before the
products; the rotated q and k never exist in device memory.
``small_attention`` runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor, or raises: there is no fallback.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.nn.rotary import apply_rotary, apply_rotary_per_term
from esmdiff_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                   launch_attention)

launches = 0       # kernel launches (plain-version calls are not counted)


def small_attention(q, k, v, cos, sin, lengths=None):
    """q, k, v: (B, L, H, Dh) pre-rotary; cos/sin: (L, Dh) -> (B, L, H, Dh)."""
    global launches
    if q.device.type == "cpu":
        return small_attention_reference(q, k, v, cos, sin, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    L, Dh = q.shape[1], q.shape[-1]
    if cos.shape != (L, Dh) or sin.shape != (L, Dh):
        raise ValueError(f"cos/sin must be ({L}, {Dh}); got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    cos, sin = (t.to(device=q.device, dtype=torch.float32).contiguous()
                for t in (cos, sin))
    out = launch_attention("small_attention", q, k, v, lengths, cos, sin)
    launches += 1
    return out


def small_attention_reference(q, k, v, cos, sin, lengths=None):
    """The plain PyTorch version of the kernel (any device)."""
    cos, sin = cos.float(), sin.float()
    qr = apply_rotary(q, cos, sin).to(v.dtype)
    kr = apply_rotary(k, cos, sin).to(v.dtype)
    return flash_attention_reference(qr, kr, v, lengths)


class SmallAttentionFunction(torch.autograd.Function):
    """Differentiable ``small_attention``: the forward runs the kernel (or
    the plain version on the CPU), the backward recomputes rotary (each
    term promoted on its own) and then ``plain_attention`` with ``lengths``
    as a key mask, which normalises p before its cast — the JAX
    ``custom_vjp``'s ``_xla_reference``, rounded as JAX rounds it in bf16."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, lengths=None):
        ctx.save_for_backward(q, k, v, cos, sin, lengths)
        return small_attention(q, k, v, cos, sin, lengths)

    @staticmethod
    def backward(ctx, grad):
        from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths

        q, k, v, cos, sin, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v, cos, sin)]
            qi, ki, vi, ci, si = inputs
            out = plain_attention_with_lengths(
                apply_rotary_per_term(qi, ci, si),
                apply_rotary_per_term(ki, ci, si), vi, lengths)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)
