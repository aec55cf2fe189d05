"""FSDP (ZeRO-3): parameters, gradients and AdamW moments sharded over the
data axis, with FSDP2's ``fully_shard``.

Port of ``esmdiff_tpu/parallel/fsdp.py``.  The wrapping policy is one unit
per trunk block plus the root (the module the loss runs through), so a
block's weights are gathered just before it runs and its gradients
reduce-scattered after its backward.  FSDP2 needs one parameter dtype a
unit: with ``model.param_dtype=bfloat16`` the float32 LayerNorms are
units of their own.  The parameter dtype is kept (no mixed-precision
policy): a bfloat16 run gathers bfloat16 weights.

A difference of layout, not of numbers: JAX shards each leaf on its
largest evenly divisible axis and keeps leaves under 2**14 elements
replicated (its ``MIN_SHARD_SIZE``); FSDP2 shards dim 0 of every
parameter of a unit (padding an uneven last shard).  The moments are born
on their parameter's shards (``torch.zeros_like`` of a sharded
parameter).
"""

from __future__ import annotations

import torch
from torch import nn


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a sharded tensor (a view: writes reach the
    sharded tensor), else ``t``."""
    return t.to_local() if is_sharded(t) else t


def shard_model(root: nn.Module, blocks, device_mesh) -> int:
    """``fully_shard`` each of ``blocks`` (with its LayerNorms their own
    units when the block mixes dtypes), then ``root``.  Returns the number
    of units."""
    from torch.distributed.fsdp import fully_shard

    from esmdiff_tpu_torch.nn.layers import LayerNorm

    mixed = len({p.dtype for p in root.parameters()}) > 1
    n = 0
    if mixed:
        for m in root.modules():
            if isinstance(m, LayerNorm) and any(
                    True for _ in m.parameters()):
                fully_shard(m, mesh=device_mesh)
                n += 1
    for block in blocks:
        fully_shard(block, mesh=device_mesh)
        n += 1
    fully_shard(root, mesh=device_mesh)
    return n + 1


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded one (every rank of its mesh takes
    part), else ``t``."""
    return t.full_tensor() if is_sharded(t) else t


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as the sharded ``like`` (this rank keeps its
    shard), else ``full`` on ``like``'s device."""
    if not is_sharded(like):
        return full.to(like.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device_mesh.device_type),
                             like.device_mesh, like.placements)
