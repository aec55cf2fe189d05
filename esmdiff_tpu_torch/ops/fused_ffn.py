"""Fused pre-norm SwiGLU FFN: hand-written CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/fused_ffn.py::_kernel``
(:34, launched at :91), whose only caller is its public function
``fused_swiglu_ffn``: no model of the JAX package runs it, and the port's
``SwiGLUFFN`` does not either.  For x (M, D) it computes an fp32 LayerNorm
(population variance, rsqrt, eps 1e-5) times ``ln_scale`` rounded to x's
dtype, [a | b] = xn W_up with W_up (D, 2H) accumulated in fp32,
hid = silu(a) b in fp32 rounded to x's dtype, and hid W_down with W_down
(H, D) accumulated in fp32 over all of H, returned in x's dtype.

The kernel (``csrc/fused_ffn.cu``) is CUDA C++ for ``sm_90a``, built by
``ops/_build.py``; its products are its own (WMMA), the (M, 2H)
up-projection and the (M, H) hidden never reach device memory, and a
ragged last row tile is masked inside the kernel.  ``fused_swiglu_ffn``
runs the plain version for a CPU tensor and launches the kernel for a CUDA
tensor, or raises: there is no fallback.  ``launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.ops.fused_qkv import check_rows, check_weight

EPS = 1e-5
MAX_D = 1536       # the kernel's widest row (8 warps x 12 16-column tiles)
_ARGTYPES = [PTR, LONG, PTR, PTR, LONG, LONG, PTR, LONG, LONG, PTR, LONG,
             INT, INT, INT]

launches = 0       # kernel launches (plain-version calls are not counted)


def fused_swiglu_ffn(x, ln_scale, w_up, w_down):
    """x: (M, D); ln_scale: (D,); w_up: (D, 2H) as [a | b]; w_down: (H, D).
    Returns (M, D) in x's dtype."""
    global launches
    if x.device.type == "cpu":
        return fused_swiglu_ffn_reference(x, ln_scale, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D); got {tuple(x.shape)}")
    M, D = x.shape
    H = w_down.shape[0]
    if D % 128 or not 0 < D <= MAX_D:
        raise ValueError(f"the kernel takes a width that is a multiple of "
                         f"128 up to {MAX_D}; got {D}")
    x2 = check_rows(x, D)
    if H % 128 or H == 0:
        raise ValueError(f"the kernel takes a hidden width that is a "
                         f"multiple of 128; got {H}")
    check_weight("w_up", w_up, (D, 2 * H))
    check_weight("w_down", w_down, (H, D))
    scale = ln_scale.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (D,):
        raise ValueError(f"ln_scale must be ({D},)")
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    _build.launch(
        "fused_ffn", "esmdiff_fused_swiglu_ffn_fwd", _ARGTYPES, x.device,
        x2.data_ptr(), x2.stride(0), scale.data_ptr(), w_up.data_ptr(),
        *w_up.stride(), w_down.data_ptr(), *w_down.stride(), out.data_ptr(),
        D, M, D, H)
    launches += 1
    return out


def fused_swiglu_ffn_reference(x, ln_scale, w_up, w_down):
    """The plain PyTorch version of the kernel (any device)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + EPS) * ln_scale.float()).to(x.dtype)
    a, b = (xn.float() @ w_up.float()).chunk(2, dim=-1)   # fp32 accumulation
    hid = (F.silu(a) * b).to(x.dtype)
    return (hid.float() @ w_down.float()).to(x.dtype)
