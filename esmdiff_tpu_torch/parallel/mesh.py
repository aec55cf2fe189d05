"""Process groups and data sharding.

Port of ``esmdiff_tpu/parallel/mesh.py`` in the idiom of
``torch.distributed``: one process per card, launched by ``torchrun``
(``torchrun --nproc_per_node N -m esmdiff_tpu_torch.cli.train ...``; the
same launch across nodes for ``trainer.multihost``).  The group opens
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL on ``cuda``, gloo on ``cpu``, and
each rank takes the card ``LOCAL_RANK``.  A group that fails to open
raises; gloo never stands in for NCCL on ``cuda``.  With no such
environment the entry points run as before, on one device, with no group.

Every rank builds the same seeded global batch and keeps its own rows
(``shard_batch``), as the JAX package's multi-process branch does; the
loss divides by the global batch's counts (``RowShard.sum``), so the
process layout is no change of the numbers.  A global batch that does not
divide by the data world raises (``data_shard``), where JAX drops devices
(``make_data_mesh_for_batch``).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# a collective that waits longer than this raises instead of hanging
TIMEOUT = timedelta(minutes=10)


def in_torchrun() -> bool:
    """True when the process was started by torchrun (its rank variables
    are set)."""
    return all(v in os.environ for v in ("RANK", "WORLD_SIZE"))


def local_device(device=None) -> torch.device:
    """The device of this process: under torchrun a ``cuda`` request
    means the card ``LOCAL_RANK``; otherwise ``device`` as given
    (``None`` = ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and in_torchrun():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_from_env(device, init_method: Optional[str] = None) -> bool:
    """Open the default process group from torchrun's environment (or
    ``init_method``, e.g. ``file://...``, with the rank variables): NCCL on
    a ``cuda`` device, gloo on ``cpu``.  Returns True when this call opened
    it; False when a group is already open or there is no such
    environment (one device, no group)."""
    if dist.is_initialized():
        return False
    if not in_torchrun():
        return False
    dev = torch.device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda process group needs a card; pass "
                               "--device cpu for gloo on the CPU")
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    missing = [v for v in ENV_VARS[3:] if v not in os.environ]
    if init_method is None and missing:
        raise RuntimeError(f"torchrun's environment lacks {missing}")
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=TIMEOUT,
        **({"device_id": dev} if dev.type == "cuda" else {}))
    return True


def close(opened: bool) -> None:
    """Destroy the default group if ``init_from_env`` opened it."""
    if opened and dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's rank: the group's, else torchrun's ``RANK``, else
    0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor, outside autograd);
    ``x`` itself when there is no group."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows ``[lo, hi)`` of a global batch of ``total`` rows, held by this
    rank of the data group ``group`` (None: one process holds them all)."""

    lo: int
    hi: int
    total: int
    group: object = None

    @classmethod
    def whole(cls, total: int) -> "RowShard":
        return cls(0, total, total)

    @property
    def world(self) -> int:
        return group_size(self.group)

    def rows(self, x):
        """This rank's rows of a global-batch array or tensor."""
        return x[self.lo:self.hi]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group: a count or a metric of the
        global batch from this rank's part of it."""
        return all_sum(x, self.group)


def data_shard(batch_size: int, index: int, size: int,
               group=None) -> RowShard:
    """The rows of data rank ``index`` of ``size``: a contiguous block of
    ``batch_size // size``.  An indivisible batch raises."""
    if batch_size % size:
        raise ValueError(f"global batch {batch_size} does not divide by "
                         f"the data world size {size}")
    per = batch_size // size
    return RowShard(index * per, (index + 1) * per, batch_size,
                    group if size > 1 else None)


def shard_batch(batch: dict, shard: Optional[RowShard]) -> dict:
    """This rank's rows of every array of a global batch."""
    if shard is None or (shard.lo == 0 and shard.hi == shard.total):
        return batch
    return {k: shard.rows(np.asarray(v)) for k, v in batch.items()}


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on dim 0 in
    rank order: the global batch's rows."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)
