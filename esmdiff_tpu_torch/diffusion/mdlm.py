"""Masked Diffusion Language Modeling (ESMDiff) — the ancestral sampler.

Port of the sampling half of ``esmdiff_tpu/diffusion/mdlm.py``:
``forward_logits`` (by default the ``parameterize=False`` form: raw float32
logits with the mask-token and special-token shields; ``parameterize=True``
gives the SUBS log-probabilities) and ``ddpm_sample``, here a Python loop of
``num_steps + 1`` trunk forwards where JAX scans.

Randomness is an injectable noise source: a callable ``step -> (gumbel
(B, L, V) float32, stay_u (B, L) float32)`` giving the draws of step
``step`` (0 <= step < num_steps; the final noise-removal step draws
nothing).  The default, ``RowGeneratorNoise``, draws on the device from one
``torch.Generator`` per row, so a row's draws depend only on its seed: the
same request on the same card gives the same tokens.  JAX's threefry bits
cannot be reproduced in PyTorch; the parity tests inject draws made by JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.ops.packing import packed_positions, packed_segment_ids
from .noise import LogLinearNoise, Noise

NEG_INFINITY = -1e6

NoiseSource = Callable[[int], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MDLMConfig:
    """The sampler's fields of the JAX ``MDLMConfig`` (the training fields
    come with the loss, in a later slice)."""

    time_conditioning: bool = True
    noise_removal: bool = True
    sequence_prediction: bool = False
    mask_index: int = C.STRUCTURE_MASK_TOKEN
    vocab_size: int = C.STRUCTURE_VOCAB_SIZE


def shield_special_tokens(logits):
    """Suppress the 5 structure special tokens during sampling: adds
    NEG_INFINITY to their logits, in place (saves a (B, L, V) copy)."""
    logits[..., C.VQVAE_CODEBOOK_SIZE:] += NEG_INFINITY
    return logits


def logits_parameterization(logits, xt, cfg: MDLMConfig):
    """SUBS parameterization: no probability on the mask token; unmasked
    positions carry themselves over with probability 1."""
    logits = logits.float().clone()
    logits[..., cfg.mask_index] += NEG_INFINITY
    logits = torch.log_softmax(logits, dim=-1)
    carry = torch.full_like(logits, NEG_INFINITY)
    carry.scatter_(-1, xt.long()[..., None], 0.0)
    return torch.where((xt != cfg.mask_index)[..., None], carry, logits)


def row_generators(row_seeds: Sequence[int], device) -> list:
    """One ``torch.Generator`` per row on ``device``, seeded with the row's
    seed."""
    gens = []
    for s in row_seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        gens.append(g)
    return gens


class RowGeneratorNoise:
    """Default noise source: one ``torch.Generator`` per row, on the rows'
    device, seeded with that row's seed.  Each step draws, row by row, a
    (L, V) uniform for the Gumbel noise and an (L,) uniform for the
    stay-masked test."""

    def __init__(self, row_seeds: Sequence[int], length: int, vocab: int,
                 device):
        self.length, self.vocab = length, vocab
        self.device = torch.device(device)
        self.generators = row_generators(row_seeds, self.device)

    def __call__(self, step: int):
        kw = dict(device=self.device, dtype=torch.float32)
        u_tok = torch.stack([torch.rand((self.length, self.vocab),
                                        generator=g, **kw)
                             for g in self.generators])
        stay_u = torch.stack([torch.rand((self.length,), generator=g, **kw)
                              for g in self.generators])
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(u_tok.clamp_min_(tiny))), stay_u


class MDLM:
    """Bundles the trunk, the sigma embedder, the noise schedule and the
    config (the modules carry their own parameters)."""

    def __init__(self, net, sigma_embedder, noise: Optional[Noise] = None,
                 cfg: MDLMConfig = MDLMConfig()):
        self.net = net
        self.sigma_embedder = sigma_embedder
        self.noise = noise if noise is not None else LogLinearNoise()
        self.cfg = cfg

    def _process_sigma(self, sigma):
        if sigma.dim() > 1:
            sigma = sigma.squeeze(-1)
        if not self.cfg.time_conditioning:
            sigma = torch.zeros_like(sigma)
        return sigma

    def forward_logits(self, xt, condition_seq, sigma,
                       shield_specials: bool = False, sequence_id=None,
                       lengths=None, pack: int = 1, positions=None,
                       parameterize: bool = False):
        """Conditioned forward -> (float32 logits, sequence logits or None).

        By default the logits are raw (JAX's ``parameterize=False``): only
        the mask-token and, optionally, special-token shields are applied —
        enough for Gumbel-max sampling, which is invariant to the
        log-softmax normalisation.  ``parameterize=True`` returns the SUBS
        log-probabilities (``logits_parameterization``), then the shield.

        ``pack`` > 1 runs the trunk on a sequence-packed view: ``pack`` rows
        to a device row under a block-diagonal segment mask, positions
        restarting per segment (ops/packing.py); the same function, and the
        outputs come back at (B, L).  It needs B % pack == 0 and raises with
        an explicit ``sequence_id`` (already-packed input)."""
        B, L = xt.shape
        aux = None
        if sigma is not None:
            cond = self.sigma_embedder(self._process_sigma(sigma))
            aux = cond[:, None, :].expand(B, L, cond.shape[-1])
        if pack > 1:
            if sequence_id is not None:
                raise ValueError("pack > 1 is incompatible with an explicit "
                                 "sequence_id (already-packed input)")
            sequence_id = packed_segment_ids(lengths, L, pack,
                                             device=xt.device)
            positions = packed_positions(L, pack, device=xt.device)
            lengths = None
            xt = xt.reshape(B // pack, pack * L)
            condition_seq = condition_seq.reshape(B // pack, pack * L)
            if aux is not None:
                aux = aux.reshape(B // pack, pack * L, -1)
        out = self.net(structure_tokens=xt, sequence_tokens=condition_seq,
                       sequence_id=sequence_id, lengths=lengths,
                       positions=positions, auxiliary_embeddings=aux)
        # the head's float32 output is fresh: shield it in place
        logits = out.structure_logits.float().reshape(B, L, -1)
        if parameterize:
            logits = logits_parameterization(logits, xt.reshape(B, L),
                                             self.cfg)
        else:
            logits[..., self.cfg.mask_index] += NEG_INFINITY
        if shield_specials:
            shield_special_tokens(logits)
        seq_logits = (out.sequence_logits if self.cfg.sequence_prediction
                      else None)
        if seq_logits is not None:
            seq_logits = seq_logits.reshape(B, L, -1)
        return logits, seq_logits

    @torch.no_grad()
    def ddpm_sample(self, sequence_tokens, noise_source: NoiseSource,
                    num_steps: int = 25, eps: float = 1e-5, input_prior=None,
                    sample_max_t: float = 1.0, shield_specials: bool = True,
                    sequence_id=None, lengths=None, pack: int = 1,
                    positions=None):
        """Ancestral denoising: ``num_steps`` sampling steps plus, with
        ``noise_removal``, a final argmax step.

        sequence_tokens: (B, L) int conditioning (with BOS/EOS).
        input_prior: optional (B, L) partially-masked start tokens.
        noise_source: the draws (see module docstring), e.g.
        ``RowGeneratorNoise``.
        pack: sequence-packing factor of the trunk forwards; the sampler's
        state and draws stay at (B, L), so a seed's tokens do not change.
        sequence_id, positions: an already-packed layout (the cross-length
        packed engine, api/generation.py), passed to every trunk forward.
        Returns (B, L) int64 structure tokens (with BOS/EOS slots).
        """
        cfg = self.cfg
        B, L = sequence_tokens.shape
        dev = sequence_tokens.device
        if input_prior is None:
            x = torch.full((B, L), cfg.mask_index, dtype=torch.long,
                           device=dev)
        else:
            x = input_prior.to(device=dev, dtype=torch.long)

        timesteps = torch.linspace(sample_max_t, eps, num_steps + 1,
                                   dtype=torch.float32)
        dt = (1 - eps) / num_steps
        n_iters = num_steps + (1 if cfg.noise_removal else 0)
        for i in range(n_iters):
            tb = timesteps[i].to(dev).expand(B)
            sigma_t = self.noise.total_noise(tb)
            sigma_s = self.noise.total_noise(tb - dt)
            mc_t = (1 - torch.exp(-sigma_t))[:, None]        # (B, 1)
            mc_s = (1 - torch.exp(-sigma_s))[:, None]
            z, _ = self.forward_logits(
                x, sequence_tokens, sigma_t[:, None],
                shield_specials=shield_specials, sequence_id=sequence_id,
                lengths=lengths, pack=pack, positions=positions)
            copy = x != cfg.mask_index
            if i == num_steps:
                # noise removal: argmax of p(x0) at still-masked positions;
                # unmasked positions carry over (the SUBS rule on tokens)
                x = torch.where(copy, x, z.argmax(dim=-1))
                continue
            # Two-stage form of the reference posterior sample: a masked
            # position stays masked w.p. mc_s/mc_t, else draws x0 ~
            # softmax(z) by Gumbel-max (no normalisation needed).
            gumbel, stay_u = noise_source(i)
            x_new = (z + gumbel.to(dev)).argmax(dim=-1)
            stay = stay_u.to(dev) * mc_t < mc_s
            x_new = torch.where(stay, cfg.mask_index, x_new)
            x = torch.where(copy, x, x_new)
        return x
