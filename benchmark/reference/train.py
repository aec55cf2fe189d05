"""MDLM fine-tuning in plain float32 PyTorch: the packed batches, the
masked-diffusion loss, its gradients and AdamW, for the first steps of a
run.

Batches: each epoch shuffles the chains with ``RandomState(seed + epoch)``
and packs them first-fit-decreasing, longest first, from a window of
8 x batch chains into ``batch`` rows of ``pack_len`` tokens with at most
``pack_len // 8`` segments a row (ESMDiff's packed trainer); the chains
left over stay in the window.  Loss (MDLM's continuous-time NELBO with a
log-linear schedule, eps 1e-3): one time a segment slot, antithetic over
the batch's B x S slots and permuted across them; a token is masked with
probability 1 - exp(-sigma(t)); the trunk sees the masked tokens, its
segment mask, positions restarting at each segment, and the sigma
embedding of its segment's sigma; the mask token gets no probability and
an unmasked token carries itself; the loss is the mean over real tokens of
-log p(x0) * sigma'(t) / expm1(sigma(t)).  The draws are a
``torch.Generator`` on the card seeded with the run's seed, in the order
the trainer draws them: the slot times, their permutation, the masking
uniforms.  AdamW: b1 0.9, b2 0.999, eps 1e-8, decay on every parameter,
constant lr, no clipping.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M

SAMPLING_EPS = 1e-3


def packed_batches(chains, batch: int, pack_len: int, seed: int):
    """Yield (B, P) numpy batches of ``chains`` (a list of (sequence
    tokens, structure tokens) without BOS/EOS), epoch after epoch."""
    S = max(1, pack_len // 8)
    epoch = 0
    while True:
        rng = np.random.RandomState(seed + epoch)
        order = np.arange(len(chains))
        rng.shuffle(order)
        stream, buf = iter(order), []
        exhausted = False
        while True:
            while not exhausted and len(buf) < 8 * batch:
                try:
                    buf.append(chains[int(next(stream))])
                except StopIteration:
                    exhausted = True
            if not buf:
                break
            rows = [[] for _ in range(batch)]
            room = [pack_len] * batch
            placed = set()
            for j in sorted(range(len(buf)), key=lambda j: -len(buf[j][1])):
                n = min(len(buf[j][1]), pack_len)
                for r in range(batch):
                    if room[r] >= n and len(rows[r]) < S:
                        rows[r].append(buf[j])
                        room[r] -= n
                        placed.add(j)
                        break
            buf = [c for j, c in enumerate(buf) if j not in placed]
            yield _collate(rows, pack_len)
        epoch += 1


def _collate(rows, P):
    B = len(rows)
    out = {"sequence_tokens": np.full((B, P), M.SEQ_PAD, np.int64),
           "structure_tokens": np.full((B, P), M.STRUCT_PAD, np.int64),
           "mask": np.zeros((B, P), np.float32),
           "segment_ids": np.full((B, P), -1, np.int64),
           "positions": np.zeros((B, P), np.int64)}
    for i, row in enumerate(rows):
        off = 0
        for s, (seq, st) in enumerate(row):
            n = min(len(st), P - off)
            out["sequence_tokens"][i, off:off + n] = seq[:n]
            out["structure_tokens"][i, off:off + n] = st[:n]
            out["mask"][i, off:off + n] = 1.0
            out["segment_ids"][i, off:off + n] = s
            out["positions"][i, off:off + n] = np.arange(n)
            off += n
    return out


def loss(W, cfg, b, gen, prec=M.Precision()):
    """The packed NELBO of one batch ``b`` (device tensors)."""
    x0, seg = b["structure_tokens"], b["segment_ids"]
    B, P = x0.shape
    S = max(1, P // 8)
    dev = x0.device
    n = B * S
    u = torch.rand((n,), generator=gen, device=dev)
    u = torch.remainder(u / n + torch.arange(n, dtype=torch.float32,
                                             device=dev) / n, 1.0)
    t = (1 - SAMPLING_EPS) * u + SAMPLING_EPS
    t = t[torch.randperm(n, generator=gen, device=dev)].reshape(B, S)
    sigma = -torch.log1p(-(1 - SAMPLING_EPS) * t)
    dsigma = (1 - SAMPLING_EPS) / (1 - (1 - SAMPLING_EPS) * t)
    valid = seg >= 0
    slot = seg.clamp(0, S - 1)
    move_chance = (1 - torch.exp(-sigma)).gather(1, slot)
    move = (torch.rand((B, P), generator=gen, device=dev) < move_chance)
    xt = torch.where(move & valid, M.STRUCT_MASK, x0)
    emb = M.sigma_embed(W, sigma.reshape(-1), prec).reshape(B, S, -1)
    aux = emb.gather(1, slot[..., None].expand(-1, -1, emb.shape[-1]))
    logits = M.trunk_logits(W, cfg, b["sequence_tokens"], xt,
                            M.segment_mask(seg), b["positions"], aux,
                            prec=prec, remat=True)
    logits = logits.clone()
    logits[..., M.STRUCT_MASK] += -1e6
    logp = torch.log_softmax(logits, dim=-1).gather(-1, x0[..., None])[..., 0]
    logp = torch.where(xt != M.STRUCT_MASK, 0.0, logp)   # carried over
    weight = (dsigma / torch.expm1(sigma)).gather(1, slot)
    keep = b["mask"] * (x0 != M.STRUCT_PAD) * valid
    return (-logp * weight * keep).sum() / keep.sum().clamp_min(1.0)


def train(W, cfg, batches, seed, steps, lr, weight_decay,
          prec=M.Precision()):
    """``steps`` AdamW steps on the float32 weights ``W`` (updated in
    place), taking each step's batch (device tensors) from ``batches``.
    Returns (the steps' losses, the first step's gradient norm per key)."""
    params = {k: v.requires_grad_() for k, v in W.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=next(iter(W.values())).device)
    gen.manual_seed(int(seed))
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first_grad = [], None
    for step in range(1, steps + 1):
        b = next(batches)
        value = loss(params, cfg, b, gen, prec)
        grads = torch.autograd.grad(value, list(params.values()),
                                    allow_unused=True)
        losses.append(float(value.detach()))
        with torch.no_grad():
            if first_grad is None:
                first_grad = {k: 0.0 if g is None else float(g.norm())
                              for k, g in zip(params, grads)}
            for (k, p), g in zip(params.items(), grads):
                g = torch.zeros_like(p) if g is None else g
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** step)
                vhat = v2[k] / (1 - b2 ** step)
                p.sub_(lr * (mhat / (vhat.sqrt() + eps) + weight_decay * p))
        del grads
    for p in params.values():
        p.requires_grad_(False)
    return losses, first_grad
