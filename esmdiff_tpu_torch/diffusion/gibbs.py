"""Confidence-ranked iterative unmasking ("gibbs") and entropy-bounded
unmasking ("eb"): port of ``esmdiff_tpu/diffusion/gibbs.py``.

Each step runs one trunk forward, samples structure tokens at the masked
positions (temperature, top-p, Gumbel-max) and commits some of them: gibbs
the most confident ones, so that the unmasked count follows a cosine
schedule over ``num_steps``; eb the largest low-entropy set whose summed
entropy stays under a budget, so the step count adapts to the input.  JAX
scans (gibbs) and runs a ``lax.while_loop`` (eb); here both are Python
loops, and eb stops when no row of the batch has a masked decode position
left (one host sync a step) or at ``max_steps``.

Randomness is an injectable source, as in ``diffusion/mdlm.py``: a callable
``step -> u``, a (B, L, V) float32 uniform in [0, 1) for step ``step``.
``RowGeneratorUniform`` draws it from one ``torch.Generator`` per row; the
parity tests inject JAX's ``uniform(fold_in(row_key, step), (L, V))``.

Tracing (``utils/tracing.py``): each step is a ``sample.step`` span, its
draw a ``sample.draws`` and the rest after the forward (top-p, the
Gumbel-max draw, the ranking and the commit) a ``sample.update``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.utils import tracing
from .mdlm import row_generators

UniformSource = Callable[[int], torch.Tensor]


class RowGeneratorUniform:
    """Default uniform source: one ``torch.Generator`` per row, on the
    rows' device, seeded with that row's seed; each step draws, row by row,
    an (L, V) uniform into one (B, L, V) buffer."""

    def __init__(self, row_seeds: Sequence[int], length: int, vocab: int,
                 device):
        self.length, self.vocab = length, vocab
        self.device = torch.device(device)
        self.generators = row_generators(row_seeds, self.device)

    def __call__(self, step: int) -> torch.Tensor:
        u = torch.empty((len(self.generators), self.length, self.vocab),
                        device=self.device, dtype=torch.float32)
        for row, g in zip(u, self.generators):
            torch.rand(row.shape, generator=g, out=row)
        return u


def top_p_filter(logits, top_p: float, exact: bool = False):
    """Nucleus filtering: logits outside the smallest set with cumulative
    probability >= top_p become -1e9.

    The default bisects the probability threshold in 24 fixed halvings,
    each a masked sum over the vocabulary; ``exact=True`` is the sort-based
    form."""
    if exact:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.exp(torch.log_softmax(sorted_logits, dim=-1))
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_logits,
                             torch.inf).amin(dim=-1, keepdim=True)
        return torch.where(logits >= thresh, logits, -1e9)

    probs = torch.exp(torch.log_softmax(logits, dim=-1))
    # find tau with mass(p >= tau) ~ top_p; keep p >= tau (mass >= top_p)
    hi = probs.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(24):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(dim=-1, keepdim=True)
        too_much = mass > top_p
        lo, hi = torch.where(too_much, mid, lo), torch.where(too_much, hi, mid)
    return torch.where(probs >= lo, logits, -1e9)


def select_top_by_confidence(conf, eligible, n_new):
    """Boolean mask of (up to) the n_new most confident eligible positions,
    by a 30-halving bisection of a per-row threshold; at least the per-row
    maximum when n_new > 0.

    conf: (B, L) float; eligible: (B, L) bool; n_new: (B,) int."""
    c = torch.where(eligible, conf, -1e30)
    lo = torch.where(eligible, conf, torch.inf).amin(dim=-1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, 0.0) - 1.0
    hi = c.amax(dim=-1, keepdim=True)
    for _ in range(30):
        mid = (lo + hi) * 0.5
        cnt = (c >= mid).sum(dim=-1, keepdim=True)
        too_many = cnt > n_new[:, None]
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    commit = eligible & (c >= hi)
    # guarantee progress: always include the per-row max when n_new > 0
    is_max = c >= c.amax(dim=-1, keepdim=True)
    commit = commit | (eligible & is_max)
    return commit & (n_new[:, None] > 0)


def cosine_unmask_schedule(num_steps: int):
    """(num_steps,) float32 fraction of the initially masked tokens that
    must be unmasked after each step (monotone to 1.0 at the last).  On
    the CPU, so that a step's quota does not depend on the card."""
    k = torch.arange(1, num_steps + 1, dtype=torch.float32)
    return 1.0 - torch.cos(k / num_steps * math.pi / 2.0) ** 2


def _gumbel_sample(scaled, u):
    """argmax(scaled + g), g = -log(-log(u + 1e-20) + 1e-20): JAX's form."""
    gumbel = -torch.log(-torch.log(u.to(scaled.device) + 1e-20) + 1e-20)
    return (scaled + gumbel).argmax(dim=-1)


@torch.no_grad()
def iterative_unmask_sample(forward_logits_fn, uniforms: UniformSource,
                            initial_tokens, decode_mask, num_steps: int = 16,
                            temperature: float = 1.4, top_p: float = 0.9):
    """Run the iterative unmasking loop.

    forward_logits_fn: tokens (B, L) -> (B, L, V) raw structure logits
        (specials already shielded by the caller if V == 4101).
    uniforms: the draws (module docstring).
    initial_tokens: (B, L) ints; positions to generate hold STRUCTURE_MASK.
    decode_mask: (B, L) bool, the positions eligible for generation; only
        those also masked in ``initial_tokens`` are generated.
    Returns (B, L) int64 tokens with every decode position committed."""
    x = initial_tokens.long()
    decode_mask = decode_mask & (x == C.STRUCTURE_MASK_TOKEN)
    n_init = decode_mask.sum(dim=-1).cpu()
    quotas = torch.ceil(cosine_unmask_schedule(num_steps)[None, :]
                        * n_init[:, None].float()).long().to(x.device)
    for step in range(num_steps):
        with tracing.span("sample.step"):
            logits = forward_logits_fn(x)
            with tracing.span("sample.draws"):
                u = uniforms(step)
            with tracing.span("sample.update"):
                logits = logits.float()
                scaled = logits / max(temperature, 1e-4)
                scaled = top_p_filter(scaled, top_p)
                sampled = _gumbel_sample(scaled, u)
                logp = torch.log_softmax(logits, dim=-1)
                conf = logp.gather(-1, sampled[..., None])[..., 0]

                still_masked = (x == C.STRUCTURE_MASK_TOKEN) & decode_mask
                already = (decode_mask
                           & (x != C.STRUCTURE_MASK_TOKEN)).sum(dim=-1)
                n_new = (quotas[:, step] - already).clamp_min(0)
                commit = select_top_by_confidence(conf, still_masked, n_new)
                x = torch.where(commit, sampled, x)
    return x


@torch.no_grad()
def entropy_bounded_unmask_sample(forward_logits_fn, uniforms: UniformSource,
                                  initial_tokens, decode_mask,
                                  entropy_budget: float = 1.0,
                                  temperature: float = 1.0,
                                  top_p: float = 1.0, max_steps: int = 64):
    """Adaptive unmasking: each step commits the largest low-entropy set
    of masked positions whose summed predictive entropy stays under
    ``entropy_budget`` (nats), and always exactly the lowest-entropy one
    (the first under ties).

    Returns (tokens (B, L) int64, the number of steps run)."""
    x = initial_tokens.long()
    decode_mask = decode_mask & (x == C.STRUCTURE_MASK_TOKEN)
    B, L = x.shape
    steps = 0
    while steps < max_steps and bool(
            ((x == C.STRUCTURE_MASK_TOKEN) & decode_mask).any()):
        logits = forward_logits_fn(x).float()
        logp = torch.log_softmax(logits, dim=-1)
        entropy = -(torch.exp(logp) * logp).sum(dim=-1)            # (B, L)

        scaled = logits / max(temperature, 1e-4)
        if top_p < 1.0:
            scaled = top_p_filter(scaled, top_p)
        sampled = _gumbel_sample(scaled, uniforms(steps))

        still = (x == C.STRUCTURE_MASK_TOKEN) & decode_mask
        # largest tau with sum(entropy[entropy <= tau]) <= budget, by
        # bisection
        masked_ent = torch.where(still, entropy, torch.inf)
        lo = torch.zeros((B, 1), dtype=torch.float32, device=x.device)
        hi = torch.where(still, entropy, 0.0).amax(
            dim=-1, keepdim=True) + 1e-6
        for _ in range(30):
            mid = (lo + hi) * 0.5
            mass = torch.where(still & (entropy <= mid), entropy, 0.0).sum(
                dim=-1, keepdim=True)
            over = mass > entropy_budget
            lo, hi = torch.where(over, lo, mid), torch.where(over, mid, hi)
        commit = still & (entropy <= lo)
        # exactly one lowest-entropy position (argmin one-hot): a `<= min`
        # mask would commit every tied position
        is_min = torch.nn.functional.one_hot(
            masked_ent.argmin(dim=-1), L).bool()
        commit = commit | (still & is_min)
        x = torch.where(commit, sampled, x)
        steps += 1
    return x, steps
