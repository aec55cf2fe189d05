"""Pipeline parallelism: GPipe stages of the trunk over processes.

Port of ``esmdiff_tpu/parallel/pp.py`` in the idiom of
``torch.distributed``.  ``trainer.strategy=ppS`` / ``dpNxppS`` lays
N x S ranks out as a 2-D (data, stage) mesh (rank = data index x S +
stage); each rank is one stage of its data row's pipeline:

  * stage 0 holds the front end (``ESM3.embed`` and the sigma embedder)
    and the geometric blocks ``0 .. n_layers_geom-1``;
  * the ``n_layers - n_layers_geom`` blocks JAX scans are split into S
    contiguous slices with JAX's partition, ``ceil(n/S)`` a stage and the
    rest at the end (``stage_rows``).  JAX pads its stack with inert zero
    layers to store it stage-sharded; here a stage holds fewer blocks, or
    none, and passes its activations on;
  * the last stage holds ``transformer.norm`` and the output heads.

A rank drops the modules of the other stages (``Pipeline.prune``): its
state dict and optimizer hold its own parameters, under their names in
the whole model.  The schedule is GPipe's, as JAX's: the rank's rows are
split into M microbatches; the forward runs all M, each stage handing its
output to the next (``batch_isend_irecv``, as ``parallel/ring.py`` hands
K/V); the last stage joins them for the norm, the heads and the loss of
all its rows.  The backward, which JAX gets from ``ppermute``'s transpose,
is this module's own (autograd does not cross processes): the last stage
runs ``loss.backward()`` and sends each microbatch's input gradient back,
in reverse order; every other stage receives the gradient of its output,
calls ``torch.autograd.backward(out, grad)`` and sends the gradient of its
input on; stage 0 ends with one backward through the front end.  Each
stage keeps ``remat`` per block (``ESM3``'s ``run_blocks``).  Evaluation
runs the forward alone.

The loss of the last stage's rows divides by the global batch's counts
(``mesh.RowShard`` over the data group), so each stage all-reduces its
gradients over ``data`` (a sum: the global batch's gradient), the grad
norm sums each stage's squares over ``stage``, and the metrics are the
last stage's, broadcast over ``stage``.  The checkpoints join the stages
on rank 0 in the one-device layout (``gather_state``,
``gather_optimizer``), and a rank loads its own part of one
(``local_optimizer``).
"""

from __future__ import annotations

import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from esmdiff_tpu_torch.nn.rotary import rotary_tables

STAGE_AXIS = "stage"
DATA_AXIS = "data"


def parse_pp_strategy(strategy: str):
    """'dp{N}xpp{S}' or 'pp{S}' -> (n_data, n_stage); None otherwise."""
    m = re.fullmatch(r"dp(\d+)xpp(\d+)", strategy)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = re.fullmatch(r"pp(\d+)", strategy)
    if m:
        return 1, int(m.group(1))
    return None


def auto_microbatches(local_batch: int, n_stage: int) -> int:
    """Default GPipe microbatch count: the smallest divisor of the per-data-
    slice batch that is >= the stage count (bubble <= (S-1)/(2S-1)), else
    the largest divisor."""
    divs = [d for d in range(1, local_batch + 1) if local_batch % d == 0]
    for d in divs:
        if d >= n_stage:
            return d
    return divs[-1]


def check_training(task_name: str, pack_len: int, batch_size: int,
                   strategy: str, microbatches: int = 0) -> int:
    """What the JAX trainer checks of a pp strategy, with its errors: the
    task is ``mdlm``, rows are not packed, the batch divides by the data
    axis and the per-data-slice batch by M.  Returns M (``microbatches``,
    0 = ``auto_microbatches``)."""
    n_data, n_stage = parse_pp_strategy(strategy)
    if task_name != "mdlm":
        raise ValueError("pp strategies support task_name=mdlm only")
    if pack_len > 0:
        raise ValueError(
            "pp strategies are incompatible with data.pack_len "
            "(packed rows carry sequence_id, which the GPipe trunk "
            "forward does not take) — set data.pack_len=0")
    if batch_size % n_data != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by dp={n_data} in "
            f"strategy {strategy!r}")
    local_b = batch_size // n_data
    m = microbatches or auto_microbatches(local_b, n_stage)
    if local_b % m != 0:
        raise ValueError(f"per-data-slice batch {local_b} not divisible by "
                         f"pp_microbatches={m}")
    return m


def stage_rows(n_rows: int, n_stage: int, stage: int) -> range:
    """The rows of a stacked ``n_rows`` layers that stage ``stage`` holds:
    JAX's ``ceil(n_rows / n_stage)`` a stage, padded at the end, less the
    pad rows."""
    n_loc = -(-n_rows // n_stage)
    return range(min(stage * n_loc, n_rows), min((stage + 1) * n_loc,
                                                  n_rows))


class Pipeline:
    """This rank's stage of the trunk's pipeline (see the module
    docstring).

    cfg: the trunk's ``ESM3Config``; stage of ``n_stage`` in ``group``
    (the stage group of this rank's data row; None with one stage);
    n_microbatches: M; device: this rank's."""

    def __init__(self, cfg, n_stage: int, stage: int, n_microbatches: int,
                 group=None, device="cpu"):
        if not 0 <= stage < n_stage:
            raise ValueError(f"stage {stage} of {n_stage}")
        self.cfg, self.n_stage, self.stage = cfg, n_stage, stage
        self.n_microbatches = int(n_microbatches)
        self.group, self.device = group, torch.device(device)
        n_geom = cfg.n_layers_geom
        self.blocks = ([*range(n_geom)] if self.first else []) + [
            n_geom + r for r in stage_rows(cfg.n_layers - n_geom, n_stage,
                                           stage)]
        if not (self.blocks or self.last):
            raise ValueError(
                f"pp{n_stage} leaves stage {stage} with nothing to hold: "
                f"the trunk's {cfg.n_layers - n_geom} blocks past the "
                f"geometric ones fill at most "
                f"{cfg.n_layers - n_geom + 1} stages")
        self.full_keys: list = []
        self.full_params: list = []
        self._saved = None

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n_stage - 1

    # -- layout -------------------------------------------------------------
    def prune(self, modules: nn.ModuleDict) -> nn.ModuleDict:
        """Drop from ``modules`` (``net``: the ESM3, ``sigma_embedder``)
        what other stages hold, after noting the whole model's names, and
        route the trunk's forward through this stage."""
        self.full_keys = list(modules.state_dict())
        self.full_params = [n for n, _ in modules.named_parameters()]
        net = modules["net"]
        if not self.first:
            net.encoder = None
            if "sigma_embedder" in modules:
                # the MDLM still embeds sigma (stage 0's input only): a
                # frozen copy that no optimizer or checkpoint sees
                modules["sigma_embedder"].requires_grad_(False)
                del modules["sigma_embedder"]
        if not self.last:
            net.transformer.norm = None
            net.output_heads = None
        keep = set(self.blocks)
        for i in range(len(net.transformer.blocks)):
            if i not in keep:
                net.transformer.blocks[i] = None
        net.pipeline = self
        return modules

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def _exchange(self, send=None, to=None, recv=None, src=None):
        """Send ``send`` to stage ``to`` and/or receive into ``recv`` from
        stage ``src``; waits for both."""
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  self._peer(to), self.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src),
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    # -- the schedule -------------------------------------------------------
    def forward(self, net, structure_tokens=None, sequence_tokens=None,
                sequence_id=None, lengths=None, positions=None,
                auxiliary_embeddings=None, **embed_kw):
        """The forward of this stage over all M microbatches (``ESM3``'s
        forward under a pipeline): the last stage returns the heads'
        ``ESMOutput`` of all its rows, the others None.  While autograd
        records, what the backward needs is kept (``backward``)."""
        if sequence_id is not None or positions is not None:
            raise ValueError(
                "the pp trunk forward does not take packed inputs "
                "(sequence_id/positions) — train with data.pack_len=0")
        cfg = self.cfg
        ref = next(t for t in (structure_tokens, sequence_tokens)
                   if t is not None)
        B, L = ref.shape[0], ref.shape[1]
        M = self.n_microbatches
        if B % M:
            raise ValueError(f"batch {B} not divisible by M={M}")
        mb = B // M
        dev = ref.device
        train = torch.is_grad_enabled()
        rot_cos, rot_sin = rotary_tables(L, cfg.d_model // cfg.n_heads,
                                         device=dev)
        lens = [None] * M if lengths is None else lengths.split(mb)
        x = None
        if self.first:
            x, _, _, _, skip_geom = net.embed(
                structure_tokens=structure_tokens,
                sequence_tokens=sequence_tokens,
                auxiliary_embeddings=auxiliary_embeddings, **embed_kw)
            if not skip_geom:
                raise ValueError("the pp trunk forward takes no "
                                 "coordinates (geometric attention runs "
                                 "skipped, as in JAX)")
            chunks = x.split(mb)
        ins, outs = [], []
        for m in range(M):
            if self.first:
                h = chunks[m]
                if train and not self.last:
                    h = h.detach().requires_grad_()
            else:
                h = self._exchange(recv=torch.empty(
                    (mb, L, cfg.d_model), dtype=cfg.torch_dtype,
                    device=dev), src=self.stage - 1)
                h.requires_grad_(train)
            out = net.transformer.run_blocks(h, self.blocks, rot_cos,
                                             rot_sin, lengths=lens[m],
                                             skip_geom=True)
            if not self.last:
                self._exchange(send=out.detach(), to=self.stage + 1)
            ins.append(h)
            outs.append(out)
        self._saved = (x, ins, outs) if train else None
        if not self.last:
            return None
        y = torch.cat(outs) if M > 1 else outs[0]
        return net.output_heads(net.transformer.norm(y), y)

    def backward(self, loss: Optional[torch.Tensor]) -> None:
        """The backward of the last ``forward`` (``loss``: the last
        stage's, None elsewhere), each stage's parameters' gradients
        accumulated."""
        x, ins, outs = self._saved
        self._saved = None
        if self.last:
            loss.backward()
            if not self.first:
                for m in reversed(range(len(ins))):
                    self._exchange(send=ins[m].grad, to=self.stage - 1)
            return
        for m in reversed(range(len(outs))):
            grad = self._exchange(recv=torch.empty_like(outs[m]),
                                  src=self.stage + 1)
            torch.autograd.backward(outs[m], grad)
            if not self.first:
                self._exchange(send=ins[m].grad, to=self.stage - 1)
        if self.first:
            x.backward(torch.cat([h.grad for h in ins]))

    def share(self, metrics: Optional[dict]) -> dict:
        """The last stage's metrics (scalar tensors) on every stage."""
        if self.n_stage == 1:
            return metrics
        box = [None if metrics is None else
               {k: v.detach().cpu() for k, v in metrics.items()}]
        dist.broadcast_object_list(box, src=self._peer(self.n_stage - 1),
                                   group=self.group)
        return {k: v.to(self.device) for k, v in box[0].items()}

    # -- checkpoints in the one-device layout -------------------------------
    def _join(self, part: dict) -> Optional[dict]:
        """Every stage's dict ``part`` merged on stage 0; None on the
        others."""
        if self.n_stage == 1:
            return part
        parts = [None] * self.n_stage if self.first else None
        dist.gather_object(part, parts, dst=self._peer(0), group=self.group)
        return ({k: v for p in parts for k, v in p.items()}
                if self.first else None)

    def gather_state(self, local: dict) -> dict:
        """The stages' ``{name: tensor}`` (a state dict, gradients) joined
        on stage 0 (CPU copies), in the whole model's order; {} on the
        other stages."""
        joined = self._join({k: v.detach().cpu() for k, v in local.items()})
        if joined is None:
            return {}
        return {k: joined[k] for k in self.full_keys if k in joined}

    def global_index(self, model: nn.Module) -> list:
        """Per parameter of this stage's ``model``: its index among the
        whole model's parameters (the one-device optimizer's)."""
        where = {n: i for i, n in enumerate(self.full_params)}
        return [where[n] for n, _ in model.named_parameters()]

    def gather_optimizer(self, sd: dict, model: nn.Module) -> dict:
        """A stage's optimizer state dict (numbered by its own parameters)
        joined with the other stages' on stage 0, numbered as the
        one-device optimizer's; {} on the other stages."""
        index = self.global_index(model)
        state = {index[i]: {k: (v.detach().cpu()
                                if isinstance(v, torch.Tensor) else v)
                            for k, v in st.items()}
                 for i, st in sd["state"].items()}
        groups = [{k: v for k, v in g.items() if k != "params"}
                  for g in sd["param_groups"]]
        if len(groups) != 1:
            raise ValueError("the pp checkpoint takes one param group")
        state = self._join(state)
        if state is None:
            return {}
        groups[0]["params"] = list(range(len(self.full_params)))
        return {"state": dict(sorted(state.items())),
                "param_groups": groups}

    def local_optimizer(self, sd: dict, model: nn.Module) -> dict:
        """This stage's part of a one-device optimizer state dict,
        numbered by its own parameters."""
        index = self.global_index(model)
        state = {i: sd["state"][g] for i, g in enumerate(index)
                 if g in sd["state"]}
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": list(range(len(index)))}
                  for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

