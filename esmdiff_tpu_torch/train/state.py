"""Train state, the training step, and the strategies that spread it over
ranks.

Port of ``esmdiff_tpu/train/state.py``: AdamW with optax's semantics, a
state holding the step count, the trainable modules and the optimizer, and
the train and eval steps.  ``distribute`` lays a model out by
``trainer.strategy`` over the ranks of an open process group
(``parallel/mesh.py``), one process per card:

  * ``ddp``: ``DistributedDataParallel``, everything replicated;
  * ``zero2``: DDP with ``ZeroRedundancyOptimizer`` over the port's
    ``AdamW``: moments sharded, parameters and gradients replicated;
  * ``fsdp``: FSDP2's ``fully_shard`` (``parallel/fsdp.py``): parameters,
    gradients and moments sharded;
  * ``dpNxtpM`` / ``tpM``: the projections split over the model axis of a
    (data, model) mesh (``parallel/tp.py``; at M = 1 each rank holds them
    whole and runs the same split modules over a model group of one), DDP
    over the data axis (the moments lie as their parameters do: JAX also
    shards the replicated leaves' moments over ``data``);
  * ``dpNxppS`` / ``ppS``: GPipe stages of the trunk over the stage axis
    of a (data, stage) mesh (``parallel/pp.py``; at S = 1 the one stage
    still runs its M microbatches), the gradients summed over the data
    axis by hand and the moments ZeRO-2 over it.
With no process group a strategy is the one-device step (``tpM`` and
``ppS`` with M, S > 1 raise: they need their ranks).

The loss of a rank's rows divides by the global batch's counts
(``mesh.RowShard``) and is scaled by the data world before the gradient
average, so the gradient is the global batch's; the reported loss and
breakdown are summed over the data axis.

optax semantics kept where PyTorch's differ:
  - ``linear_schedule(0, lr, warmup_steps)``, or the VQ-VAE trainer's
    ``warmup_cosine_decay_schedule``, is evaluated at the count of
    updates already made, so the first update has lr 0;
  - ``clip_by_global_norm(max)`` scales by max / ||g|| only when
    ||g|| >= max (``clip_grad_norm_`` adds 1e-6 to the norm), with the
    norm and the scaling in the gradients' dtype; a sharded gradient's
    float32 sum of squares is summed over its shards before it is
    rounded;
  - ``adamw`` with the moments in the parameter dtype (bfloat16 moments
    for bfloat16 parameters, as optax keeps ``mu``/``nu``), and in a
    bfloat16 parameter optax's order op by op (``AdamW``): the decay is
    added to the Adam direction before the lr scales it, where
    ``torch.optim.AdamW`` first multiplies the parameter by 1 - lr * wd,
    which in bfloat16 rounds the decay away;
  - every parameter is decayed and stepped on every update, the ones that
    got no gradient too (their gradient is zero, as in ``jax.grad``; DDP
    is told to expect such parameters).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from esmdiff_tpu_torch.parallel import fsdp as pfsdp
from esmdiff_tpu_torch.parallel import mesh as pmesh
from esmdiff_tpu_torch.parallel import pp as ppp
from esmdiff_tpu_torch.parallel import tp as ptp
from esmdiff_tpu_torch.utils import tracing
from esmdiff_tpu_torch.utils.logging import is_main_process

STRATEGIES = ("ddp", "zero2", "fsdp", "dpNxtpM", "tpM", "dpNxppS", "ppS")
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
                # a sharded parameter steps its own shard
                by_dtype.setdefault((p.dtype, int(st["step"])), []).append(
                    tuple(pfsdp.local(t) for t in (
                        p, grad, st["exp_avg"], st["exp_avg_sq"])))
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


@dataclasses.dataclass
class Layout:
    """How a train state lies over the ranks (``distribute``): the rows of
    the global batch this rank holds (None: all of them, no group), the
    model axis of tensor parallelism, whether FSDP shards the parameters,
    whether ZeRO shards the moments, this rank's pipeline stage."""

    shard: Optional[pmesh.RowShard] = None
    tp: Optional[ptp.TPGroup] = None
    fsdp_group: object = None
    zero_group: object = None
    pipeline: Optional[ppp.Pipeline] = None

    @property
    def data_world(self) -> int:
        return 1 if self.shard is None else self.shard.world

    def norm_group(self, p):
        """The group over which ``p``'s gradient is split (its partial sums
        of squares are summed over it), or None."""
        if self.fsdp_group is not None and pfsdp.is_sharded(p):
            return self.fsdp_group
        if self.tp is not None and ptp.tp_spec(p) is not None:
            return self.tp.group
        return None

    @property
    def data_root(self) -> bool:
        """This rank holds the first rows of the global batch (data index
        0)."""
        return self.shard is None or self.shard.lo == 0

    def reduce(self, metrics: dict) -> dict:
        """Every scalar metric of a rank's rows summed over the data axis:
        the global batch's value (under a pipeline, the last stage's,
        shared with the others first)."""
        if self.pipeline is not None:
            metrics = self.pipeline.share(metrics)
        if self.data_world == 1:
            return metrics
        return {k: self.shard.sum(v) if v.dim() == 0
                and v.is_floating_point() else v for k, v in metrics.items()}


def make_optimizer(params, lr: float = 1e-5, weight_decay: float = 0.01,
                   warmup_steps: int = 0, grad_clip: Optional[float] = None,
                   schedule: Optional[Callable[[int], float]] = None,
                   layout: Optional[Layout] = None) -> Optimizer:
    """AdamW over ``params`` with decay on every parameter (optax.adamw with
    no mask); under ``zero2`` with a group, a ``ZeroRedundancyOptimizer``
    whose ranks each step the AdamW of their partition."""
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if layout is not None and layout.zero_group is not None:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        adamw = ZeroRedundancyOptimizer(
            list(params), optimizer_class=AdamW,
            process_group=layout.zero_group, **kw)
    else:
        adamw = AdamW(list(params), **kw)
    return Optimizer(adamw, lr, warmup_steps, grad_clip, schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    layout: Layout = dataclasses.field(default_factory=Layout)


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       layout: Optional[Layout] = None) -> TrainState:
    """The state at step 0, every parameter's gradient allocated (zero), so
    that each update steps every parameter."""
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    return TrainState(step=0, model=model, optimizer=optimizer,
                      layout=layout or Layout())


def check_strategy(strategy: str) -> None:
    """Raise on a strategy the port does not run."""
    if strategy in ("ddp", "zero2", "fsdp") or \
            ptp.parse_tp_strategy(strategy) is not None or \
            ppp.parse_pp_strategy(strategy) is not None:
        return
    raise ValueError(f"unknown strategy: {strategy!r} "
                     f"({' | '.join(STRATEGIES)})")


class _LossModule(nn.Module):
    """The module a distributed loss runs through: DDP's reducer and
    FSDP's root hooks fire on its forward."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch, draws, training: bool = True):
        return self.loss_fn(batch, draws, training=training)


def distribute(model: nn.Module, loss_fn: Callable, strategy: str,
               batch_size: int, device, blocks=(), microbatches: int = 0):
    """Lay ``model`` out by ``strategy`` over the open process group.

    loss_fn(batch, draws, training=True, shard=None) -> (loss, breakdown)
    on this rank's rows of a global batch of ``batch_size`` rows.
    blocks: the trunk blocks FSDP makes units of.  microbatches: the pp
    strategies' M (0 = ``pp.auto_microbatches``); ``model`` is then the
    MDLM's modules (``net``, ``sigma_embedder``), pruned to this rank's
    stage.  Returns (loss_fn of (batch, draws, training=True) through the
    wrapped model, Layout).  Without a group: the one-device loss and an
    empty Layout."""
    check_strategy(strategy)
    shape = ptp.parse_tp_strategy(strategy)
    pp_shape = ppp.parse_pp_strategy(strategy)
    if not dist.is_initialized():
        for s in (shape, pp_shape):
            if s is not None and s != (1, 1):
                raise ValueError(f"trainer.strategy={strategy!r} needs "
                                 f"{s[0] * s[1]} ranks: launch it with "
                                 f"torchrun")
        return (lambda b, d, training=True: loss_fn(b, d, training=training),
                Layout())
    from torch.distributed.device_mesh import init_device_mesh
    from torch.nn.parallel import DistributedDataParallel

    dev = torch.device(device)
    world = dist.get_world_size()
    n_data, n_model = (shape or pp_shape or (world, 1))
    if n_data * n_model != world:
        raise ValueError(f"trainer.strategy={strategy!r} needs "
                         f"{n_data * n_model} ranks; the group has {world}")
    if pp_shape is not None:
        return _distribute_pp(model, loss_fn, n_data, n_model, batch_size,
                              dev, microbatches)
    if shape is not None:
        # dpNxtpM builds its (data, model) mesh and splits the projections
        # at any M, M = 1 too: the same modules and collectives
        dmesh = init_device_mesh(dev.type, (n_data, n_model),
                                 mesh_dim_names=(ptp.DATA_AXIS,
                                                 ptp.MODEL_AXIS))
        data_group, data_index = (dmesh.get_group(ptp.DATA_AXIS),
                                  dmesh.get_local_rank(ptp.DATA_AXIS))
    else:
        dmesh = init_device_mesh(dev.type, (world,),
                                 mesh_dim_names=(ptp.DATA_AXIS,))
        data_group, data_index = dmesh.get_group(), dmesh.get_local_rank()
    shard = pmesh.data_shard(batch_size, data_index, n_data, data_group)
    layout = Layout(shard=shard)
    if shape is not None:
        layout.tp = ptp.TPGroup(dmesh.get_group(ptp.MODEL_AXIS))
        ptp.shard_modules(model, layout.tp)

    def sharded_loss(b, d, training=True):
        return loss_fn(b, d, training=training, shard=shard)

    root = _LossModule(model, sharded_loss)
    if strategy == "fsdp":
        pfsdp.shard_model(root, blocks, dmesh)
        layout.fsdp_group = data_group
        wrapped = root
    else:
        wrapped = DistributedDataParallel(
            root, process_group=data_group,
            device_ids=[dev.index] if dev.type == "cuda" else None,
            find_unused_parameters=True)
        if strategy == "zero2":
            layout.zero_group = data_group
    return (lambda b, d, training=True: wrapped(b, d, training=training),
            layout)


def _distribute_pp(model, loss_fn, n_data: int, n_stage: int,
                   batch_size: int, dev: torch.device, microbatches: int):
    """``distribute``'s pipeline strategies: the (data, stage) mesh, this
    rank's stage (``model`` pruned to it) and its rows."""
    from torch.distributed.device_mesh import init_device_mesh

    dmesh = init_device_mesh(dev.type, (n_data, n_stage),
                             mesh_dim_names=(ppp.DATA_AXIS, ppp.STAGE_AXIS))
    data_group = dmesh.get_group(ppp.DATA_AXIS)
    shard = pmesh.data_shard(batch_size, dmesh.get_local_rank(ppp.DATA_AXIS),
                             n_data, data_group)
    pipeline = ppp.Pipeline(
        model["net"].cfg, n_stage, dmesh.get_local_rank(ppp.STAGE_AXIS),
        microbatches or ppp.auto_microbatches(batch_size // n_data, n_stage),
        dmesh.get_group(ppp.STAGE_AXIS), dev)
    pipeline.prune(model)
    layout = Layout(shard=shard, pipeline=pipeline,
                    zero_group=data_group if n_data > 1 else None)
    return (lambda b, d, training=True: loss_fn(b, d, training=training,
                                                shard=shard)), layout


def _sum_grads(params, group) -> None:
    """Every gradient summed over ``group``, one all-reduce a dtype."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def global_norm(tensors, groups=None, across=None) -> torch.Tensor:
    """optax's ``global_norm``: each tensor's sum of squares (accumulated in
    float32) rounded to its dtype, their sum in the tensors' dtype when
    they share one, else in float32 (as JAX promotes a mixed sum), and its
    square root.  groups: per tensor, the group over which it is split
    (its float32 partial sum is summed over the group before rounding),
    or None.  across: a group whose ranks hold the other tensors (a
    pipeline's stages): the float32 sums are summed over it."""
    dtypes = {t.dtype for t in tensors}
    out = (dtypes.pop() if len(dtypes) == 1 and across is None
           else torch.float32)
    groups = groups or [None] * len(tensors)
    squares = [pmesh.all_sum(torch.sum(t.float() ** 2), g).to(t.dtype)
               .to(out) for t, g in zip(tensors, groups)]
    total = torch.stack(squares).sum()
    if across is not None:
        total = pmesh.all_sum(total, across)
    return torch.sqrt(total)


def train_step(state: TrainState, loss_fn: Callable, batch: dict,
               draws) -> dict:
    """Forward, backward and one AdamW update of ``state`` in place.

    loss_fn(batch, draws) -> (loss, breakdown dict).  Returns the breakdown
    with ``loss`` and ``grad_norm`` (the global norm of the raw gradients,
    before clipping), all as device tensors (the global batch's values
    under a ``distribute`` layout).  Spans (``utils/tracing.py``):
    ``train.step`` around ``train.forward`` (the loss), ``train.backward``
    and ``train.update`` (the norm, the clip test's read of it, the
    learning rate and AdamW); counts ``train.steps``."""
    tracing.count("train.steps")
    with tracing.span("train.step", step=state.step):
        return _train_step(state, loss_fn, batch, draws)


def _train_step(state: TrainState, loss_fn: Callable, batch: dict,
                draws) -> dict:
    opt, layout = state.optimizer, state.layout
    pipeline = layout.pipeline
    params = [p for g in opt.adamw.param_groups for p in g["params"]]
    opt.adamw.zero_grad(set_to_none=False)
    with torch.enable_grad():
        with tracing.span("train.forward"):
            loss, breakdown = loss_fn(batch, draws)
        with tracing.span("train.backward"):
            if pipeline is not None:
                # the schedule's backward, then the sum of the data ranks'
                # parts of the global loss (no DDP: it would reduce per
                # microbatch)
                pipeline.backward(loss)
                if layout.data_world > 1:
                    _sum_grads(params, layout.shard.group)
            else:
                # the gradient average over the data axis, times its size:
                # the sum of the ranks' parts of the global loss
                (loss * layout.data_world if layout.data_world > 1
                 else loss).backward()
    with tracing.span("train.update"):
        grads = [pfsdp.local(p.grad) for p in params]
        grad_norm = global_norm(grads,
                                [layout.norm_group(p) for p in params],
                                across=pipeline and pipeline.group)
        if opt.grad_clip and not grad_norm < opt.grad_clip:
            # optax: (g / norm) * max, each in the gradient's dtype
            for g in grads:
                g.div_(grad_norm.to(g.dtype)).mul_(opt.grad_clip)
        for group in opt.adamw.param_groups:
            group["lr"] = opt.lr_at(state.step)
        opt.adamw.step()
    state.step += 1
    metrics = _metrics(loss, breakdown)
    metrics = layout.reduce(metrics)
    metrics["grad_norm"] = grad_norm
    return metrics


def _metrics(loss, breakdown: dict) -> Optional[dict]:
    """The breakdown and ``loss``, detached; None for a pipeline stage
    without the loss."""
    if loss is None:
        return None
    metrics = {k: v.detach() for k, v in breakdown.items()}
    metrics["loss"] = loss.detach()
    return metrics


@torch.no_grad()
def eval_step(loss_fn: Callable, batch: dict, draws,
              layout: Optional[Layout] = None) -> dict:
    metrics = _metrics(*loss_fn(batch, draws))
    return metrics if layout is None else layout.reduce(metrics)


# -- checkpoints in the one-device layout ------------------------------------

def _params(state: TrainState):
    return [p for g in state.optimizer.adamw.param_groups
            for p in g["params"]]


def full_model_state(state: TrainState) -> dict:
    """The model's state dict with whole tensors (every rank takes part;
    the values are meant for rank 0's writer)."""
    layout = state.layout
    if layout.pipeline is not None:
        return (layout.pipeline.gather_state(state.model.state_dict())
                if layout.data_root else {})
    if layout.fsdp_group is not None:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict)

        return get_model_state_dict(state.model, options=StateDictOptions(
            full_state_dict=True, cpu_offload=True))
    specs = {n: ptp.tp_spec(p) for n, p in state.model.named_parameters()}
    return {n: ptp.gather_full(t, specs.get(n), layout.tp)
            for n, t in state.model.state_dict().items()}


def full_optimizer_state(state: TrainState) -> Optional[dict]:
    """The optimizer's state dict in the one-device layout (as the AdamW
    of the unsplit model holds it) on rank 0, None on the others; every
    rank takes part."""
    layout, adamw = state.layout, state.optimizer.adamw
    if layout.zero_group is not None:
        # to the data group's rank 0
        adamw.consolidate_state_dict(to=0)
        if layout.pipeline is None:
            return adamw.state_dict() if is_main_process() else None
    if layout.pipeline is not None:
        if not layout.data_root:
            return None
        sd = layout.pipeline.gather_optimizer(adamw.state_dict(), state.model)
        return sd if is_main_process() else None
    sd = adamw.state_dict()
    if layout.fsdp_group is None and layout.tp is None:
        return sd
    for i, p in enumerate(_params(state)):
        if i not in sd["state"]:
            continue
        # state_dict() holds the live state's dicts: replace, not write
        st = sd["state"][i] = dict(sd["state"][i])
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                full = pfsdp.full_tensor(st[k])
                st[k] = ptp.gather_full(full, ptp.tp_spec(p), layout.tp)
    return sd


def load_full_state(state: TrainState, params: dict,
                    optimizer_sd: dict) -> None:
    """Load a one-device-layout checkpoint (``full_model_state``,
    ``full_optimizer_state``) into ``state``, each rank keeping its
    part."""
    layout, adamw = state.layout, state.optimizer.adamw
    if layout.pipeline is not None:
        pipeline = layout.pipeline
        differ = sorted(set(pipeline.full_keys) ^ set(params))
        if differ:
            raise KeyError(f"checkpoint keys differ from the model's: "
                           f"{differ[:4]}")
        own = state.model.state_dict()
        state.model.load_state_dict({k: params[k] for k in own}, strict=True)
        adamw.load_state_dict(pipeline.local_optimizer(optimizer_sd,
                                                        state.model))
        return
    if layout.fsdp_group is None and layout.tp is None:
        state.model.load_state_dict(params, strict=True)
        adamw.load_state_dict(optimizer_sd)
        return
    named = dict(state.model.named_parameters())
    if set(named) != set(params):
        raise KeyError(f"checkpoint keys differ from the model's: "
                       f"{sorted(set(named) ^ set(params))[:4]}")

    def place(full, p):
        full = ptp.local_part(full, ptp.tp_spec(p), layout.tp)
        return pfsdp.shard_like(full.to(p.dtype), p)

    with torch.no_grad():
        for name, p in named.items():
            pfsdp.local(p).copy_(pfsdp.local(place(params[name], p)))
    for i, p in enumerate(_params(state)):
        st = optimizer_sd["state"].get(i)
        if st is None:
            continue
        adamw.state[p] = {
            "step": st["step"].clone().cpu(),
            "exp_avg": place(st["exp_avg"], p),
            "exp_avg_sq": place(st["exp_avg_sq"], p)}
    for group, saved in zip(adamw.param_groups, optimizer_sd["param_groups"]):
        group.update({k: v for k, v in saved.items() if k != "params"})
