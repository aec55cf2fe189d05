"""Train state and the training step on one device.

Port of ``esmdiff_tpu/train/state.py``: AdamW with optax's semantics, a
state holding the step count, the trainable modules and the optimizer, and
the train and eval steps.  The JAX package's strategies shard the state
over a mesh; on one device ``ddp`` and ``zero2`` are the plain step, and
the others (``fsdp``, ``dpNxtpM``, ``ppS``) are not ported yet.

optax semantics kept where PyTorch's differ:
  - ``linear_schedule(0, lr, warmup_steps)``, or the VQ-VAE trainer's
    ``warmup_cosine_decay_schedule``, is evaluated at the count of
    updates already made, so the first update has lr 0;
  - ``clip_by_global_norm(max)`` scales by max / ||g|| only when
    ||g|| >= max (``clip_grad_norm_`` adds 1e-6 to the norm);
  - every parameter is decayed and stepped on every update, the ones that
    got no gradient too (their gradient is zero, as in ``jax.grad``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn

STRATEGIES = ("ddp", "zero2")


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included), flat
    after it."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"the cosine decay needs decay_steps "
                         f"({decay_steps}) > warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return ((init_value - peak_value) * (1 - count / warmup_steps)
                    + peak_value)
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t
                                     / (decay_steps - warmup_steps)))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


@dataclasses.dataclass
class Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with an optional linear warmup
    from 0, or a ``schedule`` of the update count, and an optional
    global-norm clip."""

    adamw: torch.optim.AdamW
    lr: float
    warmup_steps: int = 0
    grad_clip: Optional[float] = None
    schedule: Optional[Callable[[int], float]] = None

    def lr_at(self, count: int) -> float:
        """The lr after ``count`` updates: ``schedule(count)``, else optax
        ``linear_schedule(0, lr, warmup_steps)`` (constant ``lr`` without
        warmup)."""
        if self.schedule is not None:
            return self.schedule(count)
        if self.warmup_steps <= 0:
            return self.lr
        return self.lr * min(count, self.warmup_steps) / self.warmup_steps


def make_optimizer(params, lr: float = 1e-5, weight_decay: float = 0.01,
                   warmup_steps: int = 0, grad_clip: Optional[float] = None,
                   schedule: Optional[Callable[[int], float]] = None
                   ) -> Optimizer:
    """AdamW over ``params`` with decay on every parameter (optax.adamw with
    no mask)."""
    adamw = torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=weight_decay)
    return Optimizer(adamw, lr, warmup_steps, grad_clip, schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer


def create_train_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    """The state at step 0, every parameter's gradient allocated (zero), so
    that each update steps every parameter."""
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    return TrainState(step=0, model=model, optimizer=optimizer)


def check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise NotImplementedError(
            f"trainer.strategy={strategy!r} is not ported yet (the port "
            f"trains on one device: {' | '.join(STRATEGIES)})")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every element, in float32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def train_step(state: TrainState, loss_fn: Callable, batch: dict,
               draws) -> dict:
    """Forward, backward and one AdamW update of ``state`` in place.

    loss_fn(batch, draws) -> (loss, breakdown dict).  Returns the breakdown
    with ``loss`` and ``grad_norm`` (the global norm of the raw gradients,
    before clipping), all as device tensors."""
    opt = state.optimizer
    params = [p for g in opt.adamw.param_groups for p in g["params"]]
    opt.adamw.zero_grad(set_to_none=False)
    with torch.enable_grad():
        loss, breakdown = loss_fn(batch, draws)
        loss.backward()
    grads = [p.grad for p in params]
    grad_norm = global_norm(grads)
    if opt.grad_clip:
        scale = torch.where(grad_norm < opt.grad_clip,
                            torch.ones_like(grad_norm),
                            opt.grad_clip / grad_norm)
        for g in grads:
            g.mul_(scale)
    for group in opt.adamw.param_groups:
        group["lr"] = opt.lr_at(state.step)
    opt.adamw.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in breakdown.items()}
    metrics["loss"] = loss.detach()
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.no_grad()
def eval_step(loss_fn: Callable, batch: dict, draws) -> dict:
    loss, breakdown = loss_fn(batch, draws)
    metrics = dict(breakdown)
    metrics["loss"] = loss
    return metrics
