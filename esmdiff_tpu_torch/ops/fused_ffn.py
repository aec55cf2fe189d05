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
``ops/_build.py``: a 128-row tile is owned by a cluster of 8 blocks, each
holding D/8 output columns in registers over the whole H loop; per chunk
of 512 hidden columns each block makes a 64-column slice of the hidden
and the 8 slices are swapped through distributed shared memory, so the
(M, 2H) up-projection and the (M, H) hidden never reach device memory.
LN(x) is computed once per row into an (M, D) scratch that the wrapper
allocates.  The products are ``wgmma`` on a ring of shared-memory stages
that TMA fills with LN(x) and the weights, read in place through three
TMA descriptors per call; the weights K-major (``up.weight.t()``,
``down.weight.t()``) or MN-major (contiguous matrices): no copy for
either layout.  A ragged last row tile is masked inside the kernel.

On the card the kernel takes D in ``WIDTHS`` (512, 1024, 1536) and H a
multiple of 512 (1536, 3584 and 4096 among them), narrower than the
earlier kernel of this file, which took any multiple of 128 for both;
``fused_swiglu_ffn`` raises ``ValueError`` on any other shape before a
launch.  The plain version, which a CPU tensor runs, takes every shape.
For a CUDA tensor the wrapper launches the kernel or raises: there is no
fallback.  The tracer's counter ``fused_ffn.launches`` counts kernel
launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.ops.fused_qkv import (WIDTHS, check_rows,
                                             check_tma_weight)
from esmdiff_tpu_torch.utils import tracing

EPS = 1e-5
BH = 512           # hidden columns per chunk: 8 blocks x 64
_ARGTYPES = [PTR, LONG, PTR, PTR, LONG, LONG, PTR, LONG, LONG, PTR, PTR,
             LONG, INT, INT, INT]



def fused_swiglu_ffn(x, ln_scale, w_up, w_down):
    """x: (M, D); ln_scale: (D,); w_up: (D, 2H) as [a | b]; w_down: (H, D).
    Returns (M, D) in x's dtype."""
    if x.device.type == "cpu":
        return fused_swiglu_ffn_reference(x, ln_scale, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D); got {tuple(x.shape)}")
    M, D = x.shape
    H = w_down.shape[0]
    if D not in WIDTHS:
        raise ValueError(f"the kernel takes D in {WIDTHS}; got {D}")
    x2 = check_rows(x, D)
    if H % BH or H == 0:
        raise ValueError(f"the kernel takes a hidden width that is a "
                         f"multiple of {BH}; got {H}")
    check_tma_weight("w_up", w_up, (D, 2 * H))
    check_tma_weight("w_down", w_down, (H, D))
    scale = ln_scale.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (D,):
        raise ValueError(f"ln_scale must be ({D},)")
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    xn = torch.empty((M, D), dtype=x.dtype, device=x.device)  # LN(x) scratch
    _build.launch(
        "fused_ffn", "esmdiff_fused_swiglu_ffn_fwd", _ARGTYPES, x.device,
        x2.data_ptr(), x2.stride(0), scale.data_ptr(), w_up.data_ptr(),
        *w_up.stride(), w_down.data_ptr(), *w_down.stride(), xn.data_ptr(),
        out.data_ptr(), D, M, D, H)
    tracing.count("fused_ffn.launches")
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
