"""W8A8 int8 projections for the inference path (port of
``esmdiff_tpu/ops/quant.py``).

  - ``quantize_weight``: symmetric per-output-channel absmax quantization
    of a weight (the port's (out, in) layout: the contraction axis last);
  - ``int8_dot``: dynamic per-token activation quantization, an int8 x int8
    -> int32 product and a float32 dequant epilogue;
  - ``QuantDense``: ``Dense(use_bias=False)`` with pre-quantized weights
    (``kernel_q`` int8 (F, D), ``scale`` float32 (F,), optional ``bias``);
  - ``quantize_trunk_params``: a trunk's (or the VQ decoder's) state dict
    -> the layout of its ``quant="int8"`` twin, with the pre-projection
    LayerNorm gammas folded into the qkv/up weights (``_FOLD_LN``);
  - ``quantize_named_denses``: the same for the AR nets (CLM, JLM), by
    module name, biases kept in float32.

The product: the JAX package contracts with ``lax.dot_general`` outside any
Pallas kernel, so the port calls a library product too, ``torch._int_mm``
(cuBLASLt int8) on a CUDA tensor.  ``kernel_q`` is stored (F, D) and passed
as its ``.t()`` view, a column-major (D, F): cuBLASLt's int8 "TN" layout.
The card's product takes more than 16 rows and K, N multiples of 8, so
fewer rows are zero-padded (never sent to the plain version).  The plain
version, ``int8_mm_reference``, takes the product in float64: every partial
sum is an integer below 2^53, so it is the exact int32 product on either
device.  The tracer's counter ``int8_mm.launches`` counts the card
products.
"""

from __future__ import annotations

import torch
from torch import nn

from esmdiff_tpu_torch.utils import tracing

MIN_ROWS = 32      # the card product's row count at least (it takes > 16)


def quantize_weight(w, contract_axis: int = -1):
    """Symmetric per-output-channel int8 quantization of a weight.

    w: (..., F, D) float weight (the contraction axis last, as in
    ``Dense.weight``; a leading layer axis is fine).  Returns (q int8 of
    w's shape, scale float32 with the contraction axis reduced away) such
    that ``q * scale[..., None] ~= w``."""
    w32 = w.float()
    s = (w32.abs().amax(dim=contract_axis, keepdim=True) / 127.0).clamp_min(
        1e-12)
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return q, s.squeeze(contract_axis)


def quantize_activations(x):
    """Per-token absmax: (x (..., D) any float) -> (xq int8, sa float32
    (..., 1)).  ``x / sa`` stays a division, as in JAX: a multiply by the
    reciprocal moves values across .5 boundaries.  Both steps read x in its
    own dtype and compute in float32 (the norm's ``dtype``, the division's
    type promotion): JAX's values without a float32 copy of x."""
    amax = torch.linalg.vector_norm(x, ord=float("inf"), dim=-1,
                                    keepdim=True, dtype=torch.float32)
    sa = (amax / 127.0).clamp_min(1e-12)
    return torch.round(x / sa).clamp_(-127, 127).to(torch.int8), sa


def int8_mm_reference(xq, kernel_q):
    """The plain version of the product: (T, D) int8 x (F, D) int8 ->
    (T, F) int32, exact (float64 partial sums are integers below 2^53)."""
    return (xq.double() @ kernel_q.double().t()).to(torch.int32)


def int8_mm(xq, kernel_q):
    """(T, D) int8 x (F, D) int8 -> (T, F) int32: ``torch._int_mm`` on a
    CUDA tensor (rows zero-padded up to a multiple of 8, at least
    ``MIN_ROWS``), the plain version on a CPU tensor."""
    if xq.device.type == "cpu":
        return int8_mm_reference(xq, kernel_q)
    T, D = xq.shape
    F = kernel_q.shape[0]
    if D % 8 or F % 8:
        raise ValueError(f"the card's int8 product takes K and N multiples "
                         f"of 8; got D={D}, F={F}")
    rows = max(MIN_ROWS, -(-T // 8) * 8)
    if rows != T:
        xq = torch.cat([xq, xq.new_zeros(rows - T, D)])
    tracing.count("int8_mm.launches")
    return torch._int_mm(xq, kernel_q.t())[:T]


def int8_dot(x, kernel_q, scale, out_dtype=torch.bfloat16):
    """Quantize activations per token, contract in int8, dequantize in
    float32: x (..., D) float, kernel_q (F, D) int8, scale (F,) float32
    -> (..., F) ``out_dtype``.  Inference only, as the JAX package uses
    it: while autograd records an input that needs a gradient, the
    dequant's ``out=`` pass raises."""
    xq, sa = quantize_activations(x)
    o = int8_mm(xq.reshape(-1, x.shape[-1]), kernel_q)
    o = o.reshape(*x.shape[:-1], kernel_q.shape[0])
    # JAX's (float(o) * sa * scale).astype(out_dtype) in two passes: the
    # first converts o as it multiplies, the second writes out_dtype
    out = torch.empty(o.shape, dtype=out_dtype, device=o.device)
    return torch.mul(torch.mul(o, sa), scale, out=out)


class QuantDense(nn.Module):
    """``Dense(in, out, use_bias)`` with pre-quantized int8 weights:
    ``kernel_q`` (out, in) int8 and ``scale`` (out,) float32, buffers (they
    take no gradient) that a state dict carries as parameters are; with
    ``use_bias`` a float32 ``bias`` added after the dequant.  Placeholders
    (zeros, ones) until ``quantize_trunk_params`` values are loaded."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.register_buffer(
            "kernel_q", torch.zeros(out_features, in_features,
                                    dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features)
                             if use_bias else None)

    def forward(self, x):
        out = int8_dot(x, self.kernel_q, self.scale, out_dtype=self.dtype)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out


# The Dense leaves ESM3Config(quant="int8") swaps to QuantDense: the
# attention qkv/out and SwiGLU up/down projections (geometric attention,
# embeddings and output heads stay in their dtype).
_QUANT_SITES = {"attn": ("qkv", "out"), "ffn": ("up", "down")}

# Pre-projection LayerNorm gamma folded into these weights before
# quantization: LN_noscale(x) @ (diag(gamma) W) == LN(x) @ W, exact; the
# int8 modules run those LayerNorms without a scale.  The q/k LayerNorms
# cannot be folded: rotary mixes channel pairs between gamma and the dot.
_FOLD_LN = {"attn": "qkv", "ffn": "up"}


@torch.no_grad()
def quantize_trunk_params(state_dict: dict) -> dict:
    """A trunk's (or VQ decoder's) state dict -> its ``quant="int8"``
    layout: every ``<...>.attn.{qkv,out}.weight`` and
    ``<...>.ffn.{up,down}.weight`` becomes ``kernel_q`` + ``scale``, the
    ``ln.scale`` of its block folded into the qkv/up weight first and
    dropped; every other entry is kept as it is.  Quantizes the values the
    state dict holds: float32 weights quantize as JAX's do, bf16 ones from
    their bf16 values."""
    out = dict(state_dict)
    for key, w in state_dict.items():
        parts = key.split(".")
        if (len(parts) < 3 or parts[-1] != "weight"
                or parts[-2] not in _QUANT_SITES.get(parts[-3], ())):
            continue
        site, name = parts[-3], parts[-2]
        block = ".".join(parts[:-2])
        w32 = w.float()
        gamma = state_dict.get(f"{block}.ln.scale")
        if name == _FOLD_LN[site] and gamma is not None:
            w32 = w32 * gamma.float()[None, :]
            del out[f"{block}.ln.scale"]
        q, s = quantize_weight(w32)
        del out[key]
        out[f"{block}.{name}.kernel_q"] = q
        out[f"{block}.{name}.scale"] = s
    return out


@torch.no_grad()
def quantize_named_denses(state_dict: dict, names) -> dict:
    """The AR nets' converter (CLM, JLM): every Dense whose module name is
    in ``names`` and whose entries are ``weight`` and at most a ``bias``
    becomes the ``QuantDense`` layout ``kernel_q`` + ``scale``, its bias
    kept in float32; every other entry is kept as it is.  Quantizes the
    values the state dict holds (float32 weights quantize as JAX's do)."""
    leaves: dict = {}
    for key in state_dict:
        module, _, leaf = key.rpartition(".")
        leaves.setdefault(module, set()).add(leaf)
    out = dict(state_dict)
    for module, own in leaves.items():
        if (module.rpartition(".")[2] not in names or "weight" not in own
                or not own <= {"weight", "bias"}):
            continue
        q, s = quantize_weight(state_dict[f"{module}.weight"].float())
        del out[f"{module}.weight"]
        out[f"{module}.kernel_q"] = q
        out[f"{module}.scale"] = s
        if "bias" in own:
            out[f"{module}.bias"] = state_dict[f"{module}.bias"].float()
    return out
