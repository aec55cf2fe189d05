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
tiling, with each q and k tile rotated as it is copied into shared memory.
``small_attention`` runs the plain version for a CPU tensor and launches
the kernel for a CUDA tensor, or raises: there is no fallback.
``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.nn.rotary import apply_rotary
from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.ops.flash_attention import (check_kernel_args,
                                                   flash_attention_reference,
                                                   kernel_lengths)

_ARGTYPES = [PTR] * 7 + [INT] * 3 + [LONG] * 12

launches = 0       # kernel launches (plain-version calls are not counted)


def small_attention(q, k, v, cos, sin, lengths=None):
    """q, k, v: (B, L, H, Dh) pre-rotary; cos/sin: (L, Dh) -> (B, L, H, Dh)."""
    global launches
    if q.device.type == "cpu":
        return small_attention_reference(q, k, v, cos, sin, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_args(q, k, v, lengths)
    B, L, H, Dh = q.shape
    if cos.shape != (L, Dh) or sin.shape != (L, Dh):
        raise ValueError(f"cos/sin must be ({L}, {Dh}); got "
                         f"{tuple(cos.shape)}, {tuple(sin.shape)}")
    cos, sin = (t.to(device=q.device, dtype=torch.float32).contiguous()
                for t in (cos, sin))
    lengths = kernel_lengths(q, lengths)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "small_attention", "esmdiff_small_attention_fwd", _ARGTYPES, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), cos.data_ptr(), sin.data_ptr(), B, L, H,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
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
    the plain version on the CPU), the backward recomputes through the plain
    version — the counterpart of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, lengths=None):
        ctx.save_for_backward(q, k, v, cos, sin, lengths)
        return small_attention(q, k, v, cos, sin, lengths)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, cos, sin, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v, cos, sin)]
            out = small_attention_reference(*inputs, lengths)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)
