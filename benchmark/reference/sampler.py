"""One step of each sampler, in plain PyTorch, and the draws a step uses.

The draws are worked out again from the request's seed, as the samplers
define them: a row (request seed s, sample index j) draws from one
``torch.Generator`` on the card seeded with the 63-bit
``SeedSequence([s, j])`` value; each ddpm step draws an (L, V) uniform and
then an (L,) one, each gibbs step one (L, V) uniform.  A batch's rows are
the request's samples in order, the last batch's surplus rows repeating the
last sample (``batch_rows``).

``ddpm_update`` is the ancestral step of masked diffusion (a masked token
stays masked with probability mc_s / mc_t, else takes
argmax(z + Gumbel)), and the final noise-removal argmax.  ``gibbs_update``
is one step of confidence-ranked unmasking: temperature, nucleus (top-p by
24 halvings of the probability threshold), Gumbel-max, and the commit of
the most confident masked positions up to the cosine schedule's quota (30
halvings of a confidence threshold, the row's most confident always
included).  Both are exact transcriptions of the samplers' definitions, so
the same logits and draws give the same tokens.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 4096
NEG = -1e6


def row_seed(request_seed: int, sample: int) -> int:
    return int(np.random.SeedSequence([int(request_seed), int(sample)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def single_plan(n_samples: int) -> tuple[int, int]:
    """(batch size, batches) of the "single" plan: one power of two, at
    least 8, for every batch (the cells' shapes stay far inside the
    sampler's L^2 x B memory budget)."""
    b = max(8, 1 << (max(1, n_samples).bit_length() - 1))
    return b, -(-n_samples // b)


def batch_rows(n_samples: int, batch: int, b: int) -> np.ndarray:
    """The sample indices of batch ``b`` of size ``batch``."""
    return np.minimum(np.arange(b * batch, (b + 1) * batch), n_samples - 1)


def ddpm_draws(request_seed, samples, L, V, step, device):
    """(gumbel (B, L, V), stay_u (B, L)) of ddpm step ``step``."""
    g, u = [], []
    tiny = torch.finfo(torch.float32).tiny
    for j in samples:
        gen = torch.Generator(device=device)
        gen.manual_seed(row_seed(request_seed, j))
        for _ in range(step + 1):
            tok = torch.rand((L, V), generator=gen, device=device)
            stay = torch.rand((L,), generator=gen, device=device)
        g.append(-torch.log(-torch.log(tok.clamp_min_(tiny))))
        u.append(stay)
    return torch.stack(g), torch.stack(u)


def gibbs_uniforms(request_seed, samples, L, V, step, device):
    out = []
    for j in samples:
        gen = torch.Generator(device=device)
        gen.manual_seed(row_seed(request_seed, j))
        for _ in range(step + 1):
            u = torch.rand((L, V), generator=gen, device=device)
        out.append(u)
    return torch.stack(out)


def loglinear_sigma(t, eps: float = 1e-3):
    return -torch.log1p(-(1 - eps) * t)


def ddpm_update(x, logits, step, num_steps, draws, t_eps: float = 1e-5):
    """x (B, L) tokens before step ``step``, logits (B, L, V) the trunk's
    raw structure logits at x -> the tokens after it."""
    z = logits.float().clone()
    z[..., MASK] += NEG                      # no probability on the mask
    z[..., MASK:] += NEG                     # nor on the specials
    copy = x != MASK
    if step == num_steps:                    # noise removal
        return torch.where(copy, x, z.argmax(dim=-1))
    B = x.shape[0]
    ts = torch.linspace(1.0, t_eps, num_steps + 1, dtype=torch.float32)
    tb = ts[step].to(x.device).expand(B)
    dt = (1 - t_eps) / num_steps
    mc_t = (1 - torch.exp(-loglinear_sigma(tb)))[:, None]
    mc_s = (1 - torch.exp(-loglinear_sigma(tb - dt)))[:, None]
    gumbel, stay_u = draws
    new = (z + gumbel).argmax(dim=-1)
    new = torch.where(stay_u * mc_t < mc_s, MASK, new)
    return torch.where(copy, x, new)


def _top_p(logits, top_p):
    probs = torch.exp(torch.log_softmax(logits, dim=-1))
    hi = probs.amax(dim=-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(24):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(dim=-1, keepdim=True)
        over = mass > top_p
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    return torch.where(probs >= lo, logits, -1e9)


def _most_confident(conf, eligible, n_new):
    c = torch.where(eligible, conf, -1e30)
    lo = torch.where(eligible, conf, torch.inf).amin(dim=-1, keepdim=True)
    lo = torch.where(torch.isfinite(lo), lo, 0.0) - 1.0
    hi = c.amax(dim=-1, keepdim=True)
    for _ in range(30):
        mid = (lo + hi) * 0.5
        over = (c >= mid).sum(dim=-1, keepdim=True) > n_new[:, None]
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    commit = eligible & (c >= hi)
    commit = commit | (eligible & (c >= c.amax(dim=-1, keepdim=True)))
    return commit & (n_new[:, None] > 0)


def gibbs_update(x, logits, step, num_steps, decode_mask, n_init, uniforms,
                 temperature, top_p):
    """One gibbs step: x (B, L) before it, logits (B, L, 4096) at x,
    decode_mask (B, L) the positions to generate, n_init (B,) how many
    there are."""
    logits = logits.float()
    k = torch.arange(1, num_steps + 1, dtype=torch.float32)
    frac = 1.0 - torch.cos(k / num_steps * math.pi / 2.0) ** 2
    quota = torch.ceil(frac[None, :] * n_init.cpu()[:, None].float()).long()
    quota = quota.to(x.device)[:, step]
    scaled = _top_p(logits / max(temperature, 1e-4), top_p)
    gumbel = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    sampled = (scaled + gumbel).argmax(dim=-1)
    conf = torch.log_softmax(logits, dim=-1).gather(
        -1, sampled[..., None])[..., 0]
    still = (x == MASK) & decode_mask
    done = (decode_mask & (x != MASK)).sum(dim=-1)
    commit = _most_confident(conf, still, (quota - done).clamp_min(0))
    return torch.where(commit, sampled, x)
