"""Train state and the training step on one device.

Port of ``esmdiff_tpu/train/state.py``: AdamW with optax's semantics, a
state holding the step count, the trainable modules and the optimizer, and
the train and eval steps.  The JAX package's strategies shard the state
over a mesh; on one device ``ddp`` and ``zero2`` are the plain step, and
the others (``fsdp``, ``dpNxtpM``, ``ppS``) raise.

optax semantics kept where PyTorch's differ:
  - ``linear_schedule(0, lr, warmup_steps)``, or the VQ-VAE trainer's
    ``warmup_cosine_decay_schedule``, is evaluated at the count of
    updates already made, so the first update has lr 0;
  - ``clip_by_global_norm(max)`` scales by max / ||g|| only when
    ||g|| >= max (``clip_grad_norm_`` adds 1e-6 to the norm), with the
    norm and the scaling in the gradients' dtype;
  - ``adamw`` with the moments in the parameter dtype (bfloat16 moments
    for bfloat16 parameters, as optax keeps ``mu``/``nu``), and in a
    bfloat16 parameter optax's order op by op (``AdamW``): the decay is
    added to the Adam direction before the lr scales it, where
    ``torch.optim.AdamW`` first multiplies the parameter by 1 - lr * wd,
    which in bfloat16 rounds the decay away;
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
# parameter elements one AdamW update call takes at once: its temporaries
# (up to three of the chunk's size) stay small beside the state
UPDATE_CHUNK = 1 << 26


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


class AdamW(torch.optim.Optimizer):
    """optax ``adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``):

        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g**2
        u = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
        p = p + (-lr) * (u + wd * p)

    A parameter held in a lower precision than float32 takes these
    operations in its dtype, one rounding each, as the JAX step computes
    them (the bias corrections in float32, cast to the dtype): there
    torch's order (decay first, p *= 1 - lr * wd) rounds the decay away.
    A float32 parameter takes ``torch.optim.AdamW``'s arithmetic, the same
    function in half the passes over the state, which in float32 agrees
    with optax's order to rounding.  The state keeps ``torch.optim.AdamW``'s
    names (``step``, ``exp_avg``, ``exp_avg_sq``)."""

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_dtype = {}
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                by_dtype.setdefault((p.dtype, int(st["step"])), []).append(
                    (p, grad, st["exp_avg"], st["exp_avg_sq"]))
            for (dtype, count), items in by_dtype.items():
                update = (_adamw_float32 if dtype == torch.float32
                          else _adamw_optax_order)
                for chunk in _chunks(items):
                    ps, gs, mus, nus = (list(t) for t in zip(*chunk))
                    update(ps, gs, mus, nus, dtype, count, b1, b2,
                           group["eps"], group["weight_decay"], group["lr"])


def _chunks(items, max_elements: int = UPDATE_CHUNK):
    """``items`` in runs of at most ``max_elements`` parameter elements (a
    larger parameter alone), which bounds the update's temporaries."""
    chunk, n = [], 0
    for item in items:
        if chunk and n + item[0].numel() > max_elements:
            yield chunk
            chunk, n = [], 0
        chunk.append(item)
        n += item[0].numel()
    if chunk:
        yield chunk


def _adamw_float32(ps, gs, mus, nus, dtype, count, b1, b2, eps, wd, lr):
    torch._foreach_mul_(ps, 1 - lr * wd)
    torch._foreach_lerp_(mus, gs, 1 - b1)
    torch._foreach_mul_(nus, b2)
    torch._foreach_addcmul_(nus, gs, gs, value=1 - b2)
    den = torch._foreach_sqrt(nus)
    torch._foreach_div_(den, math.sqrt(1 - b2 ** count))
    torch._foreach_add_(den, eps)
    torch._foreach_addcdiv_(ps, mus, den, value=-lr / (1 - b1 ** count))


def _adamw_optax_order(ps, gs, mus, nus, dtype, count, b1, b2, eps, wd, lr):
    def scalar(x):
        # a float32 value as the parameter dtype holds it
        return float(torch.tensor(x, dtype=torch.float32).to(dtype))

    torch._foreach_mul_(mus, scalar(b1))
    torch._foreach_add_(mus, torch._foreach_mul(gs, scalar(1 - b1)))
    sq = torch._foreach_mul(gs, gs)
    torch._foreach_mul_(sq, scalar(1 - b2))
    torch._foreach_mul_(nus, scalar(b2))
    torch._foreach_add_(nus, sq)
    del sq
    u = torch._foreach_div(mus, scalar(1 - b1 ** count))
    den = torch._foreach_div(nus, scalar(1 - b2 ** count))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, scalar(eps))
    torch._foreach_div_(u, den)
    del den
    if wd:
        torch._foreach_add_(u, torch._foreach_mul(ps, scalar(wd)))
    torch._foreach_mul_(u, scalar(-lr))
    torch._foreach_add_(ps, u)


@dataclasses.dataclass
class Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with an optional linear warmup
    from 0, or a ``schedule`` of the update count, and an optional
    global-norm clip."""

    adamw: AdamW
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
    adamw = AdamW(list(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                  weight_decay=weight_decay)
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
    """optax's ``global_norm``: each tensor's sum of squares (accumulated in
    float32) rounded to its dtype, their sum in the tensors' dtype when
    they share one, else in float32 (as JAX promotes a mixed sum), and its
    square root."""
    dtypes = {t.dtype for t in tensors}
    out = dtypes.pop() if len(dtypes) == 1 else torch.float32
    squares = [torch.sum(t.float() ** 2).to(t.dtype).to(out)
               for t in tensors]
    return torch.sqrt(torch.stack(squares).sum())


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
    if opt.grad_clip and not grad_norm < opt.grad_clip:
        # optax: (g / norm) * max, each in the gradient's dtype
        for g in grads:
            g.div_(grad_norm.to(g.dtype)).mul_(opt.grad_clip)
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
