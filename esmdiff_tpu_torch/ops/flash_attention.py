"""Prefix-length masked attention: hand-written CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/flash_attention.py::
_attn_kernel`` (launched at :204).  For q, k, v of shape (B, L, H, Dh) and
``lengths`` (B,) int32 it computes fp32 logits scaled by 1/sqrt(Dh), masks
keys at positions >= lengths[b] to -1e9, takes p = exp(logits - rowmax),
casts p to v's dtype before p.v (fp32 accumulation) and multiplies the
output by 1/sum(p).  A row with lengths[b] == 0 therefore gets the mean of V
over all L rows, as in JAX.

The kernel (``csrc/flash_attention.cu`` over ``csrc/attention_tiles.cuh``)
is CUDA C++ for ``sm_90a``, built by ``ops/_build.py``.  At the main path's
L (64) the bytes of q, k, v and o bound it on an H100, so it reads the
native (B, L, H, Dh) strides in place and makes one pass: a block takes one
64-query tile of one batch row for G heads (``pick_group``), with the next
head's q, k and v in flight while one is computed, and the scores and p
never leave registers (``mma.sync``).  At 64 < L <= 1024 a block keeps
the whole K of its (b, h) in shared memory and sweeps it twice (the row
max, then p against that final max, with V streamed); above 1024 both
sweeps stream K.  So p is rounded to bf16 exactly where the TPU kernel
rounds it, at every L.

``flash_attention`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises: there is no fallback.  The tracer's
counter ``flash.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.utils import tracing

HEAD_DIM = 64
TILE = 64          # query rows a block takes; keys a single pass holds
# blocks of the one-pass (L <= TILE) kernel that one SM holds, as
# csrc/attention_tiles.cuh fixes them: __launch_bounds__ and the shared
# memory a block (flash 54 KB, small 88 KB with its rotary tables)
BLOCKS_PER_SM = {"flash_attention": 4, "small_attention": 2}

ARGTYPES = {"flash_attention": [PTR] * 5 + [INT] * 4 + [LONG] * 12,
            "small_attention": [PTR] * 7 + [INT] * 4 + [LONG] * 12}


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


def pick_group(B: int, L: int, H: int, slots: int) -> int:
    """Heads per block G.  At L > ``TILE`` a block holds (or streams) one
    head's whole K, so G = 1.  At L <= ``TILE`` the smallest divisor of H whose B * H / G
    blocks fit in one wave of ``slots`` (SMs x resident blocks an SM): every
    block is resident from the start, with the most blocks (and so the
    most loads in flight) that leaves no ragged last wave."""
    if L > TILE:
        return 1
    for g in range(1, H + 1):
        if H % g == 0 and B * (H // g) <= slots:
            return g
    return H


def heads_per_block(name: str, B: int, L: int, H: int, device) -> int:
    """G for ``name``'s kernel at this shape: ``pick_group`` over one wave
    of ``device``'s SMs x ``BLOCKS_PER_SM``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return pick_group(B, L, H, sms * BLOCKS_PER_SM[name])


def launch_attention(name: str, q, k, v, lengths, *tables):
    """Check the arguments, launch ``name``'s kernel (``tables`` are its
    extra device pointers, before B) and return the output."""
    check_kernel_args(q, k, v, lengths)
    B, L, H, _ = q.shape
    lengths = kernel_lengths(q, lengths)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _build.launch(
        name, f"esmdiff_{name}_fwd", ARGTYPES[name], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), *(t.data_ptr() for t in tables), B, L, H,
        heads_per_block(name, B, L, H, q.device),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    return out


def flash_attention(q, k, v, lengths=None):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh); lengths: optional (B,)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    out = launch_attention("flash_attention", q, k, v, lengths)
    tracing.count("flash.launches")
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
    the plain version on the CPU), the backward recomputes through
    ``plain_attention`` with ``lengths`` as a key mask, which normalises p
    before its cast — the JAX ``custom_vjp``'s
    ``_xla_attention_with_lengths``."""

    @staticmethod
    def forward(ctx, q, k, v, lengths=None):
        ctx.save_for_backward(q, k, v, lengths)
        return flash_attention(q, k, v, lengths)

    @staticmethod
    def backward(ctx, grad):
        # imported here: nn.attention dispatches to this module
        from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths

        q, k, v, lengths = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            out = plain_attention_with_lengths(*inputs, lengths)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad)
        return dq, dk, dv, None
