"""Tensor parallelism for the trunk: Megatron-style column/row parallel
projections over the ``model`` axis of a 2-D (data, model) device mesh.

Port of ``esmdiff_tpu/parallel/tp.py``.  The JAX package states the
layout as GSPMD shardings and XLA inserts the collectives; here each rank
holds its slice of the six projections of ``TP_RULES`` and the modules
call the collectives themselves (``TPGroup``): the input of a
column-parallel projection goes through ``copy`` (identity forward,
all-reduce backward), the output of a row-parallel one through ``reduce``
(all-reduce forward, identity backward).

Three things GSPMD did silently are done here by hand:
  * whole heads of q, k and v: ``qkv``'s rows are split per q/k/v block,
    so a rank holds the same heads of each; ``q_ln`` and ``k_ln``
    normalise over the whole ``d_model``, so their statistics are summed
    over ``model`` (``TPGroup.layer_norm``) and the attention kernel runs
    on the rank's local heads;
  * matching halves of ``[a | b]``: ``ffn.up``'s rows are split per half,
    so each rank holds the same hidden units of ``a`` and of ``b``;
  * whole geometric heads: ``geom_attn.proj``'s rows (and ``out``'s
    columns) are head-major, so a contiguous split keeps whole heads; the
    per-head scales are sliced at use.
A module whose heads (or hidden units) do not divide by the model axis
stays replicated, as ``_spec_for`` leaves indivisible leaves.  Every other
parameter is replicated, and its gradient is the same on every rank of a
model group.  The trainer keeps ``qkv_backend="xla"`` (the ``fused_qkv``
kernel normalises q and k over its own width) and raises on it.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# (module path suffix, parameter, dim, blocks): the parameter is split on
# ``dim`` (torch's (out, in) layout: 0 = output features, column parallel;
# 1 = input features, row parallel), each of its ``blocks`` equal parts
# split contiguously over the model axis
TP_RULES: tuple[tuple[tuple[str, ...], str, int, int], ...] = (
    (("attn", "qkv"), "weight", 0, 3),
    (("attn", "out"), "weight", 1, 1),
    (("ffn", "up"), "weight", 0, 2),
    (("ffn", "down"), "weight", 1, 1),
    (("geom_attn", "proj"), "weight", 0, 1),
    (("geom_attn", "out"), "weight", 1, 1),
)


def parse_tp_strategy(strategy: str):
    """'dp{N}xtp{M}' or 'tp{M}' -> (n_data, n_model); None otherwise."""
    m = re.fullmatch(r"dp(\d+)xtp(\d+)", strategy)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.fullmatch(r"tp(\d+)", strategy)
    if m:
        return 1, int(m.group(1))
    return None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TPGroup:
    """This rank's place on the model axis and its collectives."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def copy(self, x):
        """Identity forward, gradient summed over the model axis: the
        input of a column-parallel projection (or a replicated parameter
        used in slices)."""
        return _Copy.apply(x, self.group)

    def reduce(self, x):
        """Partial sums of a row-parallel projection summed over the model
        axis; the gradient passes as it is."""
        return _Reduce.apply(x, self.group)

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous slice of ``t`` on ``dim``."""
        return t.chunk(self.size, dim)[self.rank]

    def layer_norm(self, x, scale=None, eps: float = 1e-5):
        """``LayerNorm`` over the whole feature axis of which ``x`` holds
        this rank's slice: float32 statistics summed over the model axis
        (population variance), this rank's slice of ``scale``; the
        input's dtype out."""
        xf = x.float()
        n = x.shape[-1] * self.size
        # summed forward and backward: each rank's statistics feed every
        # rank's slice
        mean = self.copy(self.reduce(xf.sum(-1, keepdim=True))) / n
        xc = xf - mean
        var = self.copy(self.reduce((xc * xc).sum(-1, keepdim=True))) / n
        y = xc * torch.rsqrt(var + eps)
        if scale is not None:
            y = y * self.local(self.copy(scale.float()))
        return y.to(x.dtype)


def shard_tensor(full: torch.Tensor, dim: int, blocks: int, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``full``: its slice of each of the
    ``blocks`` equal parts on ``dim``, concatenated."""
    return torch.cat([b.chunk(size, dim)[rank]
                      for b in full.chunk(blocks, dim)], dim)


def unshard_tensor(parts, dim: int, blocks: int) -> torch.Tensor:
    """The inverse of ``shard_tensor``: every rank's part in rank order ->
    the whole tensor."""
    split = [p.chunk(blocks, dim) for p in parts]
    return torch.cat([torch.cat([s[i] for s in split], dim)
                      for i in range(blocks)], dim)


def _divides(module, size: int) -> bool:
    from esmdiff_tpu_torch.nn.geometric import GeometricAttention
    from esmdiff_tpu_torch.nn.layers import MultiHeadAttention, SwiGLUFFN

    if isinstance(module, MultiHeadAttention):
        if module.qkv_backend != "xla" or not hasattr(module.qkv, "weight"):
            raise ValueError("tensor parallelism needs qkv_backend='xla' "
                             "and float projections")
        return module.n_heads % size == 0
    if isinstance(module, SwiGLUFFN):
        return module.down.weight.shape[1] % size == 0
    if isinstance(module, GeometricAttention):
        return module.v_heads % size == 0
    return False


def shard_modules(model: nn.Module, tp: TPGroup) -> int:
    """Split ``model``'s attention, SwiGLU and geometric attention
    projections over ``tp`` in place (``TP_RULES``), leaving a module whose
    heads do not divide replicated; each split parameter keeps its rule as
    ``tp_spec`` (dim, blocks) for the checkpoint and the gradient norm.
    Returns the number of modules split."""
    n = 0
    for name, module in model.named_modules():
        if not _divides(module, tp.size):
            continue
        for prefix, param, dim, blocks in TP_RULES:
            if name.rsplit(".", 1)[-1] != prefix[0]:
                continue
            child = getattr(module, prefix[-1])
            p = getattr(child, param)
            local = shard_tensor(p.data, dim, blocks, tp.rank, tp.size)
            new = nn.Parameter(local.clone(), requires_grad=p.requires_grad)
            new.tp_spec = (dim, blocks)
            setattr(child, param, new)
        module.tp = tp
        n += 1
    return n


def tp_spec(p: torch.Tensor) -> Optional[tuple[int, int]]:
    return getattr(p, "tp_spec", None)


def gather_full(t: torch.Tensor, spec, tp: Optional[TPGroup]) -> torch.Tensor:
    """The whole tensor of a split parameter (or of a state tensor shaped
    like it) from every rank of the model axis; ``t`` when it is not
    split."""
    if spec is None or tp is None:
        return t
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.contiguous(), group=tp.group)
    return unshard_tensor(parts, *spec)


def local_part(full: torch.Tensor, spec, tp: Optional[TPGroup]):
    """This rank's part of a whole tensor (``full`` when not split)."""
    if spec is None or tp is None:
        return full
    return shard_tensor(full, spec[0], spec[1], tp.rank, tp.size)
