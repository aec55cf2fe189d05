"""Prefix-length masked attention: hand-written CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/flash_attention.py::
_attn_kernel`` (launched at :204).  For q, k, v of shape (B, L, H, Dh) and
``lengths`` (B,) int32 it computes fp32 logits scaled by 1/sqrt(Dh), masks
keys at positions >= lengths[b] to -1e9, takes p = exp(logits - rowmax),
casts p to v's dtype before p.v (fp32 accumulation) and multiplies the
output by 1/sum(p).  A row with lengths[b] == 0 therefore gets the mean of V
over all L rows, as in JAX.

The kernel (``csrc/flash_attention.cu`` over ``csrc/attention_tiles.cuh``)
is CUDA C++ for ``sm_90a``, built by ``ops/_build.py``.  Its bound on an
H100 and what its design does about it are in the sources' headers: at the
main path's L (64) the bytes bound it, so it reads the native (B, L, H, Dh)
strides directly and streams K/V in 64-key tiles (two passes, so p is
rounded to bf16 at the same point as in JAX), instead of the TPU kernel's
whole-K/V-resident (B*H, L, Dh) layout.

``flash_attention`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises: there is no fallback.  ``launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR

HEAD_DIM = 64
_ARGTYPES = [PTR] * 5 + [INT] * 3 + [LONG] * 12

launches = 0       # kernel launches (plain-version calls are not counted)


def check_kernel_args(q, k, v, lengths=None) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, L, H, Dh) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel takes Dh={HEAD_DIM}, got {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel needs a contiguous last dim and other "
                f"strides that are multiples of 8 elements; got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs 16-byte alignment")
    if lengths is not None and (lengths.shape != (q.shape[0],)
                                or lengths.is_floating_point()):
        raise ValueError(f"lengths must be ({q.shape[0]},) integers; got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")


def kernel_lengths(q, lengths):
    """``lengths`` as the kernels take it: (B,) int32 on q's device, all L
    when None."""
    if lengths is None:
        return torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                          device=q.device)
    return lengths.to(device=q.device, dtype=torch.int32).contiguous()


def flash_attention(q, k, v, lengths=None):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh); lengths: optional (B,)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_args(q, k, v, lengths)
    B, L, H, _ = q.shape
    lengths = kernel_lengths(q, lengths)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "flash_attention", "esmdiff_flash_attention_fwd", _ARGTYPES, q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), B, L, H,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    launches += 1
    return out


def flash_attention_reference(q, k, v, lengths=None):
    """The plain PyTorch version of the kernel (any device)."""
    B, L, H, Dh = q.shape
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) \
        * (1.0 / Dh ** 0.5)
    if lengths is not None:
        key_ok = (torch.arange(L, device=q.device)[None, :]
                  < lengths.to(q.device)[:, None])
        logits = logits.masked_fill(~key_ok[:, None, None, :], -1e9)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)                     # (B, H, L, 1)
    o = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    return (o * (1.0 / denom).transpose(1, 2)).to(q.dtype)


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable ``flash_attention``: the forward runs the kernel (or
    the plain version on the CPU), the backward recomputes through the plain
    version — the counterpart of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, lengths=None):
        ctx.save_for_backward(q, k, v, lengths)
        return flash_attention(q, k, v, lengths)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_reference(*inputs, lengths)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None
