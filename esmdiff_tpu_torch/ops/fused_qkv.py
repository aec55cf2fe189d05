"""Fused LN -> QKV projection -> QK-LayerNorm: hand-written CUDA kernel +
plain version.

Replaces the Pallas TPU kernel ``esmdiff_tpu/ops/fused_qkv.py::_kernel``
(:41, launched at :119), the ``qkv_backend="fused"`` path.  For x (B, L, D)
it computes an fp32 LayerNorm (population variance, eps 1e-5, scale only)
rounded to W's dtype, the product with the (D, 3D) ``w_qkv`` accumulated in
fp32, and a second fp32 LayerNorm over the D outputs of q and of k (not v)
with ``q_ln_scale`` / ``k_ln_scale``, returning (B, L, 3D) in x's dtype.
The q/k LayerNorm takes the fp32 product, as the TPU kernel does; the
unfused path (and the JAX ``_reference_ln_qkv``, its backward, here
``ln_qkv_unfused``) rounds the product to bf16 first, and the two agree in
fp32.

The kernel (``csrc/fused_qkv.cu``) is CUDA C++ for ``sm_90a``, built by
``ops/_build.py``: 192-row tiles whose D output columns are split over a
cluster of 8 blocks that share the q/k LayerNorm statistics; its products
are ``wgmma`` on a ring of shared-memory stages that TMA fills with W, and
it reads W in place through one TMA descriptor per call, K-major (the
port's (3D, D) weight goes in as ``weight.t()``) or MN-major (a row-major
(D, 3D) W, through wgmma's transpose bit): no copy for either layout.
``fused_ln_qkv`` runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises: there is no fallback.  The tracer's
counter ``fused_qkv.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.utils import tracing

EPS = 1e-5
WIDTHS = (512, 1024, 1536)   # D = 8 blocks x 64 * (1, 2 or 3) columns
_ARGTYPES = [PTR, LONG, PTR, PTR, LONG, LONG, PTR, PTR, PTR, LONG, INT, INT]



def ln_f32(x, scale):
    """fp32 LayerNorm over the last dim: (x - mean) / sqrt(var + eps) *
    scale, population variance, no bias (the JAX ``_ln_f32``)."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * (1.0 / torch.sqrt(var + EPS)) * scale.float()


def check_tma_weight(name, w, shape) -> None:
    """Raise ValueError unless ``w`` is a bf16 matrix of ``shape`` that a
    TMA descriptor can describe: one stride 1 (K-major as ``weight.t()``,
    or MN-major), the other a multiple of 8 elements (16 bytes), the data
    16-byte aligned."""
    if tuple(w.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}; got {tuple(w.shape)}")
    if w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {w.dtype}")
    s0, s1 = w.stride()
    if not ((s0 == 1 and s1 % 8 == 0) or (s1 == 1 and s0 % 8 == 0)):
        raise ValueError(f"{name}: TMA needs a row- or column-major matrix "
                         f"whose leading stride is a multiple of 16 bytes; "
                         f"got strides {w.stride()}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned address")


def check_rows(x, D) -> torch.Tensor:
    """``x`` (..., D) bf16 as a (rows, D) view whose rows the kernels read
    16 bytes at a time; raise ValueError on what they do not take."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x: the kernel takes bfloat16, got {x.dtype}")
    x2 = x.reshape(-1, D)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        raise ValueError(f"x needs a contiguous last dim, a row stride that "
                         f"is a multiple of 8 and 16-byte alignment; got "
                         f"strides {x.stride()}")
    return x2


def fused_ln_qkv(x, ln_scale, w_qkv, q_ln_scale, k_ln_scale):
    """x: (B, L, D); w_qkv: (D, 3D).  Returns (B, L, 3D) =
    [QK-LN(LN(x) Wq), QK-LN(LN(x) Wk), LN(x) Wv]."""
    if x.device.type == "cpu":
        return fused_ln_qkv_reference(x, ln_scale, w_qkv, q_ln_scale,
                                      k_ln_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    D = x.shape[-1]
    if D not in WIDTHS:
        raise ValueError(f"the kernel takes D in {WIDTHS}; got {D}")
    x2 = check_rows(x, D)
    check_tma_weight("w_qkv", w_qkv, (D, 3 * D))
    scales = [t.to(device=x.device, dtype=torch.float32).contiguous()
              for t in (ln_scale, q_ln_scale, k_ln_scale)]
    if any(s.shape != (D,) for s in scales):
        raise ValueError(f"the LayerNorm scales must be ({D},)")
    out = torch.empty((*x.shape[:-1], 3 * D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _build.launch(
        "fused_qkv", "esmdiff_fused_ln_qkv_fwd", _ARGTYPES, x.device,
        x2.data_ptr(), x2.stride(0), scales[0].data_ptr(), w_qkv.data_ptr(),
        *w_qkv.stride(), scales[1].data_ptr(), scales[2].data_ptr(),
        out.data_ptr(), 3 * D, x2.shape[0], D)
    tracing.count("fused_qkv.launches")
    return out


def fused_ln_qkv_reference(x, ln_scale, w_qkv, q_ln_scale, k_ln_scale):
    """The plain PyTorch version of the kernel (any device)."""
    D = x.shape[-1]
    xn = ln_f32(x, ln_scale).to(w_qkv.dtype)
    y = xn.float() @ w_qkv.float()                  # fp32 accumulation
    q = ln_f32(y[..., :D], q_ln_scale)
    k = ln_f32(y[..., D:2 * D], k_ln_scale)
    return torch.cat([q, k, y[..., 2 * D:]], dim=-1).to(x.dtype)


def ln_qkv_unfused(x, ln_scale, w_qkv, q_ln_scale, k_ln_scale):
    """The JAX ``_reference_ln_qkv``: the same function with the product
    rounded to x's dtype before the q/k LayerNorm, as the unfused path
    rounds it."""
    D = x.shape[-1]
    xn = ln_f32(x, ln_scale).to(x.dtype)
    y = (xn @ w_qkv.to(x.dtype)).float()
    q = ln_f32(y[..., :D], q_ln_scale)
    k = ln_f32(y[..., D:2 * D], k_ln_scale)
    return torch.cat([q, k, y[..., 2 * D:]], dim=-1).to(x.dtype)


class FusedLnQkvFunction(torch.autograd.Function):
    """Differentiable ``fused_ln_qkv``: the forward runs the kernel (or the
    plain version on the CPU), the backward recomputes through
    ``ln_qkv_unfused`` — the JAX ``custom_vjp``'s ``_reference_ln_qkv``."""

    @staticmethod
    def forward(ctx, x, ln_scale, w_qkv, q_ln_scale, k_ln_scale):
        ctx.save_for_backward(x, ln_scale, w_qkv, q_ln_scale, k_ln_scale)
        return fused_ln_qkv(x, ln_scale, w_qkv, q_ln_scale, k_ln_scale)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = ln_qkv_unfused(*inputs)
            return torch.autograd.grad(out, inputs, grad)
