"""q/k LayerNorm + rotary of the trunk's attention: hand-written CUDA kernel
+ plain version.

Replaces no TPU kernel: XLA fuses this chain on the TPU by itself, while
PyTorch's eager mode runs it as 20 launches a layer between the QKV product
and attention (``MultiHeadAttention.forward``: ``q_ln``/``k_ln``, each a
cast to fp32, the LayerNorm and a cast back, then ``apply_rotary`` on q and
on k, each a cast, two broadcast multiplies, a negation, the concatenation
of ``_rotate_half``, an add and a cast), which move about 1.8 GB a layer at
the trunk's T 8192 x D 1536.  For q and k (B, L, D) in bf16, strided views
of the QKV product as the trunk passes them, it computes the LayerNorm
over D (fp32 statistics, population variance, eps 1e-5, the fp32 scale)
rounded to bf16, then the rotary of each 64-wide head in fp32 on those
values with the fp32 (L, 64) or per-row (B, L, 64) tables, rounded to
bf16: the plain chain's arithmetic, rounded at its two points.  The
outputs are (B, L, H, 64) contiguous.

The kernel (``csrc/qk_norm_rotary.cu``) is CUDA C++ for ``sm_90a``, built
by ``ops/_build.py``: one pass that reads q and k and writes them rotated,
one warp a (token, q|k) row.  It has no backward: ``MultiHeadAttention``
takes it only when autograd does not record.  ``qk_norm_rotary`` runs the
plain version for a CPU tensor and launches the kernel for a CUDA tensor,
or raises: there is no fallback.  The tracer's counter
``qk_norm_rotary.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from esmdiff_tpu_torch.nn.rotary import apply_rotary
from esmdiff_tpu_torch.ops import _build
from esmdiff_tpu_torch.ops._build import INT, LONG, PTR
from esmdiff_tpu_torch.utils import tracing

HEAD_DIM = 64
MAX_WIDTH = 2048   # D / 256 16-byte chunks a lane: 8 at most
_ARGTYPES = [PTR] * 8 + [INT] * 3 + [LONG] * 5


def check_args(q, k, q_scale, k_scale, cos, sin) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 3 or q.shape != k.shape:
        raise ValueError(f"q and k must share one (B, L, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got "
                             f"{t.dtype}")
    B, L, D = q.shape
    if cos.shape[-1] != HEAD_DIM:
        raise ValueError(f"the kernel takes Dh={HEAD_DIM}, got "
                         f"{cos.shape[-1]}")
    if sin.shape != cos.shape or tuple(cos.shape) not in (
            (L, HEAD_DIM), (B, L, HEAD_DIM)):
        raise ValueError(f"cos/sin must be ({L}, {HEAD_DIM}) or ({B}, {L}, "
                         f"{HEAD_DIM}); got {tuple(cos.shape)}, "
                         f"{tuple(sin.shape)}")
    if D % HEAD_DIM or D > MAX_WIDTH:
        raise ValueError(f"the kernel takes D a multiple of {HEAD_DIM} up to "
                         f"{MAX_WIDTH}; got {D}")
    if q_scale.shape != (D,) or k_scale.shape != (D,):
        raise ValueError(f"the LayerNorm scales must be ({D},); got "
                         f"{tuple(q_scale.shape)}, {tuple(k_scale.shape)}")


def _check_rows(name, t) -> None:
    """The kernel reads each row 16 bytes at a time."""
    if t.stride(-1) != 1 or t.stride(0) % 8 or t.stride(1) % 8 \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous last dim, "
                         f"other strides that are multiples of 8 elements "
                         f"and 16-byte alignment; got {t.stride()}")


def qk_norm_rotary(q, k, q_scale, k_scale, cos, sin):
    """q, k: (B, L, D) bf16; q_scale, k_scale: (D,); cos/sin: (L, 64) or
    (B, L, 64) -> (q, k), each (B, L, D // 64, 64)."""
    check_args(q, k, q_scale, k_scale, cos, sin)
    if q.device.type == "cpu":
        return qk_norm_rotary_reference(q, k, q_scale, k_scale, cos, sin)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if k.device != q.device:
        raise ValueError(f"k is on {k.device}, q on {q.device}")
    _check_rows("q", q)
    _check_rows("k", k)
    dev = q.device
    q_scale, k_scale, cos, sin = (
        t.to(device=dev, dtype=torch.float32).contiguous()
        for t in (q_scale, k_scale, cos, sin))
    B, L, D = q.shape
    q_out = torch.empty(B, L, D // HEAD_DIM, HEAD_DIM, dtype=q.dtype,
                        device=dev)
    k_out = torch.empty_like(q_out)
    if q_out.numel() == 0:
        return q_out, k_out
    _build.launch(
        "qk_norm_rotary", "esmdiff_qk_norm_rotary_fwd", _ARGTYPES, dev,
        q.data_ptr(), k.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        B, L, D, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        0 if cos.dim() == 2 else cos.stride(0))
    tracing.count("qk_norm_rotary.launches")
    return q_out, k_out


def qk_norm_rotary_reference(q, k, q_scale, k_scale, cos, sin):
    """The plain PyTorch version of the kernel (any device): the chain it
    replaces, ``q_ln``/``k_ln`` (``nn.layers.LayerNorm``) then
    ``apply_rotary``, the same ops in the same order."""
    B, L, D = q.shape
    Dh = cos.shape[-1]
    out = []
    for x, scale in ((q, q_scale), (k, k_scale)):
        y = F.layer_norm(x.float(), (D,), scale.float(), None,
                         eps=1e-5).to(x.dtype)
        out.append(apply_rotary(y.reshape(B, L, D // Dh, Dh), cos, sin))
    return tuple(out)
