"""Prefix-length masked attention: hand-written CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/flash_attention.py::
_attn_kernel`` (launched at :204).  For q, k, v of shape (B, L, H, Dh) and
``lengths`` (B,) int32 it computes fp32 logits scaled by 1/sqrt(Dh), masks
keys at positions >= lengths[b] to -1e9, takes p = exp(logits - rowmax),
casts p to v's dtype before p.v (fp32 accumulation) and multiplies the
output by 1/sum(p).  A row with lengths[b] == 0 therefore gets the mean of V
over all L rows, as in JAX.

The kernel (``csrc/flash_attention.cu``) is CUDA C++ for ``sm_90a``, built
with ``nvcc`` at first use into ``build/torch_ext/`` and bound through ctypes
(a plain C interface: seconds to build, no PyTorch headers).  Its bound on an
H100 and what its design does about it are in the source's header: at the
main path's L (64) the bytes bound it, so it reads the native (B, L, H, Dh)
strides directly and streams K/V in 64-key tiles (two passes, so p is
rounded to bf16 at the same point as in JAX), instead of the TPU kernel's
whole-K/V-resident (B*H, L, Dh) layout.

``flash_attention`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises: there is no fallback.  ``launches``
counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HEAD_DIM = 64

launches = 0       # kernel launches (plain-version calls are not counted)
build_log = ""     # nvcc's output (ptxas registers / shared memory / spills)
_lib = None


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source content) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"libflash_attention_{tag}.so"
    if not so.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {res.returncode}:\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    c = ctypes
    lib.esmdiff_flash_attention_fwd.restype = c.c_int
    lib.esmdiff_flash_attention_fwd.argtypes = (
        [c.c_void_p] * 5 + [c.c_int] * 3 + [c.c_longlong] * 12 + [c.c_void_p])
    lib.esmdiff_cuda_error_string.restype = c.c_char_p
    lib.esmdiff_cuda_error_string.argtypes = [c.c_int]
    _lib = lib
    return lib


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


def flash_attention(q, k, v, lengths=None):
    """q, k, v: (B, L, H, Dh) -> (B, L, H, Dh); lengths: optional (B,)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    check_kernel_args(q, k, v, lengths)
    B, L, H, _ = q.shape
    if lengths is None:
        lengths = torch.full((B,), L, dtype=torch.int32, device=q.device)
    else:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = build()
    err = lib.esmdiff_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lengths.data_ptr(), B, L, H,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.esmdiff_cuda_error_string(err).decode())
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
