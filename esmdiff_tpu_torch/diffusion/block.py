"""Block-diffusion sampling of structure tokens (SDAR, arXiv:2510.06303)
with the model of ``models/sdar.py``: autoregressive across blocks, with a
KV cache of the committed blocks, and masked diffusion inside a block.

For a batch of rows sharing one prompt ([BOS, residues, EOS], sequence ids
at ``SEQUENCE_OFFSET``): one prefill writes the prompt's keys and values;
then for each block of ``block_length`` structure positions, all masked,
``steps`` denoising steps, each a forward of the block's current tokens
against the cache that commits that step's quota of masked positions (the
block's positions spread evenly over its steps, the remainder to the first;
at block 4 and 4 steps, one a step: static low-confidence remasking), and
one commit forward of the finished block that writes its keys and values.
A short last block takes min(steps, its positions) steps; it runs at the
full block width, its missing positions masked out of attention and never
committed.

A step (``block_update``): x^ = argmax(z / T + Gumbel(u)) over the 4,096
structure codes from the row's uniforms, the confidence p(x^) under
softmax(z / T), and the most confident masked positions committed
(``gibbs.select_top_by_confidence``).  The uniforms are a source
``step -> (B, block_length, 4096)`` (``gibbs.RowGeneratorUniform`` by
default), the step counted over the whole request.

CUDA graphs (``BlockForwards``).  The step (forward and update) and the
commit have the same shapes at every block of a batch (the cache is read
whole at a fixed length, ``CACHE_MULTIPLE``), so on a card each is
captured once a (rows, cache length, block length, temperature) and
replayed: a forward is then one launch on the host instead of ~3,000.  The
prefill, whose length is the prompt's, runs eagerly.  A capture that
fails raises.  Each step and commit leaves in static buffers what it
computed besides the block's tokens: the step's logits over the codes
(``logits``) and every layer's expert ids (``routes``), so that a caller
can read what a replay did.

Tracing: ``block.prefill``, ``block.step`` (its draw a ``block.draws``)
and ``block.commit`` spans, around the replays as around eager forwards
(a replay's kernels fall inside them, not inside the model's own spans);
the counters ``block.forwards``, ``moe.tokens_routed`` (token-expert
pairs, each layer) and ``kv.positions_read`` (the cache positions a
forward's attention takes, each row and layer), from the host's shapes;
and ``moe.experts_hit``, read once a batch from the model, for the
forwards that ran eagerly while the tracer was on.
"""

from __future__ import annotations

from typing import Optional

import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models.sdar import STRUCTURE_CODES
from esmdiff_tpu_torch.utils import tracing
from .gibbs import UniformSource, _gumbel_sample, select_top_by_confidence

CACHE_MULTIPLE = 256     # cache lengths, so one graph serves a length range


def step_quotas(positions: int, steps: int) -> list[int]:
    """The masked positions each step of a block commits."""
    steps = min(steps, positions)
    return [positions // steps + (i < positions % steps)
            for i in range(steps)]


def block_update(x, logits, u, n_new, temperature: float = 1.0,
                 eligible=None):
    """One denoising step: x (B, w) the block's tokens (MASK where still
    masked), logits (B, w, >= 4096) at x, u (B, w, 4096) uniforms, n_new
    (B,) the positions to commit, ``eligible`` (w,) the block's real
    positions (default all) -> the block's tokens after it."""
    z = logits[..., :STRUCTURE_CODES].float() / max(temperature, 1e-4)
    sampled = _gumbel_sample(z, u)
    conf = torch.softmax(z, dim=-1).gather(-1, sampled[..., None])[..., 0]
    still = x == C.STRUCTURE_MASK_TOKEN
    if eligible is not None:
        still = still & eligible
    commit = select_top_by_confidence(conf, still, n_new)
    return torch.where(commit, sampled, x)


class BlockForwards:
    """A batch shape's step and commit over static buffers: the cache,
    the block's tokens ``x`` (updated in place by a step), its ``start``
    and ``valid`` positions, the draws ``u``, the quota ``n_new``, and
    what the last forward left (module docstring): ``logits`` (rows,
    width, 4096) and ``routes`` (layers, rows, width, k).  ``capture``
    makes the CUDA graphs, before a batch's prefill (capturing runs the
    forwards on the buffers)."""

    def __init__(self, model, rows: int, length: int, width: int,
                 temperature: float):
        cfg = model.cfg
        dev = model.embed_tokens.weight.device
        self.model, self.width, self.temperature = model, width, temperature
        self.cache = model.new_cache(rows, length)
        self.x = torch.full((rows, width), C.STRUCTURE_MASK_TOKEN,
                            dtype=torch.long, device=dev)
        self.start = torch.zeros((), dtype=torch.long, device=dev)
        self.valid = torch.full((), width, dtype=torch.long, device=dev)
        self.u = torch.zeros((rows, width, STRUCTURE_CODES), device=dev)
        self.n_new = torch.ones((rows,), dtype=torch.long, device=dev)
        self.logits = torch.zeros((rows, width, STRUCTURE_CODES),
                                  dtype=cfg.torch_dtype, device=dev)
        self.routes = torch.zeros((cfg.num_hidden_layers, rows, width,
                                   cfg.num_experts_per_tok),
                                  dtype=torch.int16, device=dev)
        self.graphs = None              # (step, commit) once captured

    def step(self):
        logits = self.model.block(self.x, self.start, self.cache,
                                  valid=self.valid, routes=self.routes)
        self.logits.copy_(logits[..., :STRUCTURE_CODES])
        eligible = torch.arange(self.width, device=self.x.device) \
            < self.valid
        self.x.copy_(block_update(self.x, logits, self.u, self.n_new,
                                  self.temperature, eligible))

    def commit(self):
        self.model.block(self.x, self.start, self.cache, write=True,
                         head=False, valid=self.valid, routes=self.routes)

    def run(self, kind: str, graphs: bool = True) -> None:
        """The ``kind`` ("step" or "commit") forward: its CUDA graph's
        replay where ``graphs`` and on a card, else eagerly."""
        if graphs and self.x.is_cuda:
            self.graphs[kind == "commit"].replay()
        else:
            (self.commit if kind == "commit" else self.step)()

    def capture(self) -> None:
        """The step's and the commit's CUDA graphs, once."""
        if self.graphs is not None:
            return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.step()
                self.commit()
        torch.cuda.current_stream().wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for fn in (self.step, self.commit):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                fn()
            graphs.append(g)
        self.graphs = tuple(graphs)


@torch.no_grad()
def block_sample(model, prompt, length: int, uniforms: UniformSource,
                 block_length: int = 4, steps: int = 4,
                 temperature: float = 1.0, graphs: bool = True,
                 held: Optional[dict] = None):
    """prompt (B, P) model ids; ``length`` structure positions -> (B,
    length) int64 structure tokens (module docstring).  ``graphs``: replay
    the captured step and commit on a card (the prefill always runs
    eagerly).  ``held``: the caller's ``BlockForwards`` by batch shape,
    kept across calls so that each shape is captured once (default: this
    call's alone)."""
    B, P = prompt.shape
    cfg = model.cfg
    need = P + -(-length // block_length) * block_length
    cache_len = -(-need // CACHE_MULTIPLE) * CACHE_MULTIPLE
    key = (B, cache_len, block_length, float(temperature))
    held = {} if held is None else held
    if key not in held:
        held[key] = BlockForwards(model, B, cache_len, block_length,
                                  temperature)
    fw = held[key]
    if graphs and prompt.is_cuda:
        fw.capture()
    pairs = B * cfg.num_experts_per_tok * cfg.num_hidden_layers

    def counted(width, read):
        tracing.count("block.forwards")
        tracing.count("moe.tokens_routed", width * pairs)
        tracing.count("kv.positions_read", B * read * cfg.num_hidden_layers)

    with tracing.span("block.prefill"):
        model.prefill(prompt, fw.cache)
        counted(P, 0)
    out = torch.empty((B, length), dtype=torch.long, device=prompt.device)
    k = 0
    for b0 in range(0, length, block_length):
        m = min(block_length, length - b0)
        fw.x.fill_(C.STRUCTURE_MASK_TOKEN)
        fw.start.fill_(P + b0)
        fw.valid.fill_(m)
        for n_new in step_quotas(m, steps):
            with tracing.span("block.step"):
                with tracing.span("block.draws"):
                    fw.u.copy_(uniforms(k))
                fw.n_new.fill_(n_new)
                fw.run("step", graphs)
                counted(block_length, P + b0)
            k += 1
        with tracing.span("block.commit"):
            fw.run("commit", graphs)
            counted(block_length, P + b0)
        out[:, b0:b0 + m] = fw.x[:, :m]
    hits = model.take_experts_hit()
    if hits is not None:
        tracing.count("moe.experts_hit", hits)
    return out
