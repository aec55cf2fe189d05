"""Mixture of experts: the sparse SwiGLU block of SDAR (Qwen3-MoE's).

    y = sum over e in top-k(p) of (p_e / sum_top-k p) *
        W_down,e (silu(W_gate,e x) * W_up,e x),    p = softmax(W_router x)

``Router`` (the published ``mlp.gate``): the router product in the
model's dtype, its softmax in float32, ``torch.topk``, the weights
renormalised over the k (``norm_topk_prob``) and cast to x's dtype.  A
module of its own, returning (weights (T, k), expert ids (T, k)), so a
forward hook sees the routing.

``Experts``: the (token, expert) pairs sorted by expert (a stable argsort
of the ids), the tokens gathered in that order, one grouped product for
gate and up together (``w_gate_up`` (E, 2I, D): each expert's gate rows,
then its up rows), silu(gate) * up, one grouped product for down
(``w_down`` (E, D, I)), each pair's output scaled by its weight and the k
outputs of a token summed in float32 (no atomics: the same sum every run).
On a CUDA tensor the grouped products are ``torch._grouped_mm`` over the
experts' end offsets, computed on the device (no host sync); on the CPU a
loop over the experts that hold tokens.

``MoE.forward(x, routes=...)`` also copies each token's expert ids into
``routes``, a buffer the caller holds: what a forward captured as a CUDA
graph routed can be read after each replay (``diffusion/block.py``).

Nothing in a forward reads the device on a card (the expert counts are
an ``index_add_``, not ``bincount``), so a forward can be captured as a
CUDA graph.

Tracing (``utils/tracing.py``): ``moe.route`` (the router, the sort and
the gather) and ``moe.experts`` (the two products and the activation)
spans; and, while the tracer is on and the forward runs eagerly, the
number of experts that got at least one token, kept on the device
(``hits``) and read once a batch by the caller (``diffusion/block.py``,
which also counts the token-expert pairs) into ``moe.experts_hit``.  A
replayed graph opens no span and counts no hit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from esmdiff_tpu_torch.utils import tracing


class Router(nn.Module):
    """Top-k routing over ``n_experts`` (module docstring)."""

    def __init__(self, dim: int, n_experts: int, top_k: int,
                 norm_topk_prob: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.top_k, self.norm_topk_prob = top_k, norm_topk_prob
        self.weight = nn.Parameter(torch.empty(n_experts, dim, dtype=dtype))

    def forward(self, x):
        p = torch.softmax(F.linear(x, self.weight), dim=-1,
                          dtype=torch.float32)
        w, ids = torch.topk(p, self.top_k, dim=-1)
        if self.norm_topk_prob:
            w = w / w.sum(dim=-1, keepdim=True)
        return w.to(x.dtype), ids


def f32_bmm(a, b):
    """a (N, m, k) @ b (N, k, n) in float32: on a card bf16 inputs with a
    float32 result (no float32 copy of the inputs), else the inputs
    upcast."""
    if a.is_cuda and a.dtype == b.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def grouped_mm(x, w, offs, counts=None):
    """(N, K) rows sorted by expert x (E, F, K) stacked weights -> (N, F):
    rows offs[e-1]:offs[e] through expert e.  ``counts`` (host ints) is
    the CPU loop's split; the card's product takes the offsets alone."""
    if x.device.type == "cuda":
        return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for e, n in enumerate(counts):
        if n:
            out[start:start + n] = x[start:start + n] @ w[e].t()
        start += n
    return out


class Experts(nn.Module):
    """The stacked SwiGLU experts of one layer (module docstring)."""

    def __init__(self, dim: int, hidden: int, n_experts: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.hidden = hidden
        self.w_gate_up = nn.Parameter(
            torch.empty(n_experts, 2 * hidden, dim, dtype=dtype))
        self.w_down = nn.Parameter(
            torch.empty(n_experts, dim, hidden, dtype=dtype))

    @torch.no_grad()
    def load(self, gate_up, down) -> None:
        """Fill from float weights (E, 2I, D) and (E, D, I)."""
        for name, w in (("gate_up", gate_up), ("down", down)):
            param = getattr(self, f"w_{name}")
            if tuple(w.shape) != tuple(param.shape):
                raise ValueError(f"w_{name}: expected {tuple(param.shape)}, "
                                 f"got {tuple(w.shape)}")
            param.copy_(w)

    def forward(self, xs, offs, counts=None):
        """xs (N, D) rows sorted by expert -> (N, D)."""
        h = grouped_mm(xs, self.w_gate_up, offs, counts)
        gate, up = h.split(self.hidden, dim=-1)
        return grouped_mm(F.silu(gate) * up, self.w_down, offs, counts)


class MoE(nn.Module):
    """``Router`` then ``Experts``: (B, n, D) -> (B, n, D)."""

    def __init__(self, dim: int, hidden: int, n_experts: int, top_k: int,
                 norm_topk_prob: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.gate = Router(dim, n_experts, top_k, norm_topk_prob, dtype)
        self.experts = Experts(dim, hidden, n_experts, dtype)
        self.hits = None

    def forward(self, x, routes=None):
        """x (..., D) -> (..., D); ``routes`` (..., k), if given, takes
        each token's expert ids."""
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        T, k = x.shape[0], self.top_k
        with tracing.span("moe.route"):
            w, ids = self.gate(x)
            flat = ids.reshape(-1)
            order = torch.argsort(flat, stable=True)
            # a count that does not read the device (bincount would)
            per_expert = torch.zeros(self.n_experts, dtype=torch.long,
                                     device=x.device).index_add_(
                0, flat, torch.ones_like(flat))
            offs = torch.cumsum(per_expert, 0, dtype=torch.int32)
            counts = (per_expert.tolist() if x.device.type != "cuda"
                      else None)
            xs = x[order // k]
            if routes is not None:
                routes.copy_(ids.view(routes.shape))
        if tracing.enabled() and not (
                x.is_cuda and torch.cuda.is_current_stream_capturing()):
            hit = (per_expert > 0).sum()
            self.hits = hit if self.hits is None else self.hits + hit
        with tracing.span("moe.experts"):
            ys = self.experts(xs, offs, counts)
        out = torch.empty_like(ys)
        out[order] = ys
        # each token's k outputs weighted and summed in float32
        y = f32_bmm(w.view(T, 1, k), out.view(T, k, -1))
        return y.to(x.dtype).view(shape)

    def take_hits(self):
        """The device count of experts hit since the last call (None when
        the tracer was off), reset."""
        hits, self.hits = self.hits, None
        return hits
