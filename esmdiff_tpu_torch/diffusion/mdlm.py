"""Masked Diffusion Language Modeling (ESMDiff) — objective and sampler.

Port of ``esmdiff_tpu/diffusion/mdlm.py``: ``forward_logits`` (by default
the ``parameterize=False`` form: raw float32 logits with the mask-token and
special-token shields; ``parameterize=True`` gives the SUBS
log-probabilities), the training objective (``sample_t``,
``packed_segment_times``, ``q_xt``, ``MDLM.loss`` and ``MDLM.loss_packed``)
and ``ddpm_sample``, here a Python loop of ``num_steps + 1`` trunk forwards
where JAX scans.

The loss draws its randomness from a draw source (``LossDraws``): the
condition-dropout uniform, the condition-mask uniforms, the time uniforms,
the packed permutation and the move uniforms.  The default,
``GeneratorDraws``, draws from one ``torch.Generator`` on the device; the
parity tests inject the draws JAX makes from its key.  Under data
parallelism every rank draws the global batch's values and keeps its rows
(a ``parallel.mesh.RowShard``), so the draws do not depend on the process
layout; ``RecordedDraws`` replays a run's draws in another process.

Randomness is an injectable noise source: a callable ``step -> (gumbel
(B, L, V) float32, stay_u (B, L) float32)`` giving the draws of step
``step`` (0 <= step < num_steps; the final noise-removal step draws
nothing).  The default, ``RowGeneratorNoise``, draws on the device from one
``torch.Generator`` per row, so a row's draws depend only on its seed: the
same request on the same card gives the same tokens.  JAX's threefry bits
cannot be reproduced in PyTorch; the parity tests inject draws made by JAX.

Tracing (``utils/tracing.py``): every trunk call is a ``trunk.forward``
span, counted by ``count_trunk``; each iteration of ``ddpm_sample`` a
``sample.step`` with its ``sample.draws`` and ``sample.update``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, Sequence

import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.ops.packing import packed_positions, packed_segment_ids
from esmdiff_tpu_torch.parallel.mesh import RowShard
from esmdiff_tpu_torch.utils import tracing
from .noise import LogLinearNoise, Noise

NEG_INFINITY = -1e6

NoiseSource = Callable[[int], tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class MDLMConfig:
    time_conditioning: bool = True
    change_of_variables: bool = False
    importance_sampling: bool = False
    antithetic_sampling: bool = True
    noise_removal: bool = True
    structure_only: bool = False
    sequence_prediction: bool = False
    condition_dropout: float = 0.0
    condition_mask_rate: float = 0.0
    coupled_condition_mask: bool = False
    sampling_eps: float = 1e-3
    T: int = 0  # 0 = continuous time
    mask_index: int = C.STRUCTURE_MASK_TOKEN
    condition_mask_index: int = C.SEQUENCE_MASK_TOKEN
    vocab_size: int = C.STRUCTURE_VOCAB_SIZE


class LossDraws(Protocol):
    """Where the loss's randomness comes from: each method returns float32
    uniforms in [0, 1) (or, ``permutation``, a permutation of range(n)) on
    the device of the batch."""

    def dropout(self) -> torch.Tensor:
        """() — the condition-dropout draw."""

    def condition_mask(self, shape) -> torch.Tensor:
        """shape — the condition-mask draws."""

    def times(self, n: int) -> torch.Tensor:
        """(n,) — the diffusion-time draws."""

    def permutation(self, n: int) -> torch.Tensor:
        """(n,) int64 — the packed loss's permutation of its time slots."""

    def move(self, shape) -> torch.Tensor:
        """shape — the forward-diffusion (masking) draws."""


class GeneratorDraws:
    """Default draw source: one ``torch.Generator`` on ``device``, seeded
    with ``seed``; each call draws the next values from it."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def _uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def dropout(self):
        return self._uniform(())

    def condition_mask(self, shape):
        return self._uniform(shape)

    def times(self, n):
        return self._uniform((n,))

    def permutation(self, n):
        return torch.randperm(n, generator=self.generator,
                              device=self.device)

    def move(self, shape):
        return self._uniform(shape)


class RecordedDraws:
    """A draw source that records what ``source`` draws (``records``: a
    list of (method, tensor on the CPU), picklable), or, with
    ``source=None``, replays ``records`` in order on ``device``: a run's
    draws carried to another process or package."""

    def __init__(self, source=None, records=None, device="cpu"):
        self.source, self.device = source, torch.device(device)
        self.records = [] if records is None else list(records)
        self._next = 0

    def _call(self, method, *args):
        if self.source is not None:
            out = getattr(self.source, method)(*args)
            self.records.append((method, out.detach().cpu()))
            return out
        name, value = self.records[self._next]
        if name != method:
            raise ValueError(f"draw {self._next} was {name!r}, asked for "
                             f"{method!r}")
        self._next += 1
        return value.to(self.device)

    def dropout(self):
        return self._call("dropout")

    def condition_mask(self, shape):
        return self._call("condition_mask", shape)

    def times(self, n):
        return self._call("times", n)

    def permutation(self, n):
        return self._call("permutation", n)

    def move(self, shape):
        return self._call("move", shape)


class _RowDraws:
    """``move`` draws of a shard's rows: the global batch's draw, of which
    it keeps its rows."""

    def __init__(self, draws: LossDraws, shard: RowShard):
        self.draws, self.shard = draws, shard

    def move(self, shape):
        return self.shard.rows(self.draws.move(
            (self.shard.total, *tuple(shape)[1:])))


def sample_t(draws: LossDraws, n: int, cfg: MDLMConfig, noise: Noise):
    """Antithetic low-discrepancy time sampling: (n,) times in
    [sampling_eps, 1]."""
    eps_t = draws.times(n)
    if cfg.antithetic_sampling:
        offset = torch.arange(n, dtype=torch.float32,
                              device=eps_t.device) / n
        eps_t = torch.remainder(eps_t / n + offset, 1.0)
    t = (1 - cfg.sampling_eps) * eps_t + cfg.sampling_eps
    if cfg.importance_sampling:
        t = noise.importance_sampling_transformation(t)
    return t


def packed_segment_times(draws: LossDraws, B: int, S: int, cfg: MDLMConfig,
                         noise: Noise):
    """(B, S) per-segment diffusion times for packed training: antithetic
    strata over all B*S slots, then permuted across slots, so that a row
    holding fewer than S segments does not train only at S-spaced noise
    levels."""
    t = sample_t(draws, B * S, cfg, noise)
    return t[draws.permutation(B * S).to(t.device)].reshape(B, S)


def q_xt(draws: LossDraws, x0, move_chance, cfg: MDLMConfig,
         condition_seq=None, non_moving_mask=None):
    """Forward diffusion: mask each token with probability move_chance;
    with ``coupled_condition_mask`` the condition sequence is masked at the
    same positions."""
    move = draws.move(x0.shape) < move_chance
    if non_moving_mask is not None:
        move = move & ~non_moving_mask.bool()
    xt = torch.where(move, cfg.mask_index, x0)
    if cfg.coupled_condition_mask and condition_seq is not None:
        condition_seq = torch.where(move, cfg.condition_mask_index,
                                    condition_seq)
    return xt, condition_seq


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


def count_trunk(rows: int, width: int, valid: Optional[int]) -> None:
    """The trunk's counters for one forward of ``rows`` x ``width``
    positions: ``trunk.forwards``, and where the caller knows on the host
    how many of them are real (``valid``: not padding, not a surplus row),
    ``trunk.positions_valid`` and ``trunk.positions_run``."""
    tracing.count("trunk.forwards")
    if valid is not None:
        tracing.count("trunk.positions_valid", valid)
        tracing.count("trunk.positions_run", rows * width)


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
                       parameterize: bool = False,
                       positions_valid: Optional[int] = None):
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
        an explicit ``sequence_id`` (already-packed input).
        ``positions_valid``: the real positions of the batch, a host
        integer, for the trunk's counters (``count_trunk``)."""
        B, L = xt.shape
        count_trunk(B, L, positions_valid)
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
        with tracing.span("trunk.forward"):
            out = self.net(structure_tokens=xt,
                           sequence_tokens=condition_seq,
                           sequence_id=sequence_id, lengths=lengths,
                           positions=positions, auxiliary_embeddings=aux)
        if out is None:  # a pipeline stage without the heads
            return None, None
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

    # -- training objective -------------------------------------------------
    def _condition(self, condition_seq, draws: LossDraws, training: bool,
                   shard: RowShard):
        """The conditioning sequence as the loss sees it: dropped whole
        (``condition_dropout``), masked per position
        (``condition_mask_rate``, pads kept) while training, or all
        masked (``structure_only``)."""
        cfg = self.cfg
        if cfg.condition_dropout > 0 and training:
            drop = draws.dropout() < cfg.condition_dropout
            condition_seq = torch.where(drop, C.SEQUENCE_MASK_TOKEN,
                                        condition_seq)
        if cfg.condition_mask_rate > 0 and training:
            m = ((shard.rows(draws.condition_mask(
                (shard.total, *condition_seq.shape[1:])))
                  < cfg.condition_mask_rate)
                 & (condition_seq != C.SEQUENCE_PAD_TOKEN))
            condition_seq = torch.where(m, C.SEQUENCE_MASK_TOKEN,
                                        condition_seq)
        if cfg.structure_only:
            condition_seq = torch.full_like(condition_seq,
                                            C.SEQUENCE_MASK_TOKEN)
        return condition_seq

    def _noise_levels(self, t):
        """(net conditioning, move chance, per-token NELBO weight or None)
        at times ``t``; discrete time (``T`` > 0) rounds t first."""
        cfg = self.cfg
        if cfg.T > 0:
            t = (t * cfg.T).int().float() / cfg.T + 1.0 / cfg.T
        if cfg.change_of_variables:
            f_T = torch.log1p(-torch.exp(-self.noise.sigma_max))
            f_0 = torch.log1p(-torch.exp(-self.noise.sigma_min))
            return t, torch.exp(f_0 + t * (f_T - f_0)), None
        sigma, dsigma = self.noise(t)
        return sigma, 1 - torch.exp(-sigma), dsigma / torch.expm1(sigma)

    def _nelbo(self, logits, seq_logits, x0, sequence_tokens, loss_mask,
               weight, shard: RowShard):
        """Masked mean of the per-token NELBO over ``loss_mask`` (plus the
        sequence NLL with ``sequence_prediction``) -> (loss, breakdown);
        of a shard's rows: its part of the global batch's mean (the count
        summed over the data group)."""
        cfg = self.cfg
        log_p_theta = logits.gather(-1, x0[..., None]).squeeze(-1)
        if cfg.change_of_variables or cfg.importance_sampling:
            per_tok = log_p_theta * torch.log1p(
                -torch.exp(-self.noise.sigma_min))
        else:
            per_tok = -log_p_theta * weight
        denom = shard.sum(loss_mask.sum()).clamp_min(1.0)
        loss = (per_tok * loss_mask).sum() / denom
        breakdown = {"nelbo": loss}
        if cfg.sequence_prediction:
            seq_lp = torch.log_softmax(seq_logits.float(), dim=-1)
            seq_nll = -seq_lp.gather(-1, sequence_tokens[..., None]).squeeze(-1)
            seq_nll = torch.where(sequence_tokens == C.SEQUENCE_PAD_TOKEN,
                                  0.0, seq_nll)
            seq_nll = (seq_nll * loss_mask).sum() / denom
            loss = loss + seq_nll
            breakdown["seq_nll"] = seq_nll
        return loss, breakdown

    def loss(self, batch: dict, draws: LossDraws, training: bool = True,
             shard: Optional[RowShard] = None):
        """Continuous-time NELBO over padded rows, one diffusion time a row.

        batch: structure_tokens (B, L) int64, sequence_tokens (B, L) int64,
        mask (B, L) float32, optional non_moving_mask (B, L).  The trunk
        runs with no attention mask (the reference attends into padding),
        so at every L it takes the attention kernel.
        shard: the batch is these rows of a global batch
        (``parallel/mesh.py``): the draws are the global batch's, of which
        it keeps its rows, and the loss is its part of the global loss.
        Returns (loss, dict of breakdown metrics); (None, {}) on a
        pipeline stage that holds no heads (``parallel/pp.py``)."""
        cfg = self.cfg
        x0 = batch["structure_tokens"]
        shard = shard or RowShard.whole(x0.shape[0])
        condition_seq = self._condition(batch["sequence_tokens"], draws,
                                        training, shard)
        loss_mask = batch["mask"] * (x0 != C.STRUCTURE_PAD_TOKEN)
        cond, move_chance, weight = self._noise_levels(
            shard.rows(sample_t(draws, shard.total, cfg, self.noise)))
        xt, condition_seq = q_xt(
            _RowDraws(draws, shard), x0, move_chance[:, None], cfg,
            condition_seq=condition_seq,
            non_moving_mask=batch.get("non_moving_mask"))
        logits, seq_logits = self.forward_logits(
            xt, condition_seq, cond[:, None], parameterize=True)
        if logits is None:  # a pipeline stage without the heads
            return None, {}
        return self._nelbo(logits, seq_logits, x0, batch["sequence_tokens"],
                           loss_mask, None if weight is None
                           else weight[:, None], shard)

    def loss_packed(self, batch: dict, draws: LossDraws, max_segments: int,
                    training: bool = True, t_override=None,
                    shard: Optional[RowShard] = None):
        """NELBO over sequence-packed rows (``train/data.py``
        ``packed_batches``): the objective of ``loss`` with one diffusion
        time per segment, attention segment-masked (the plain path) and
        rotary positions restarting per segment.

        batch: structure_tokens / sequence_tokens / mask (B, P), plus
        segment_ids (B, P) with -1 on padding and positions (B, P).
        max_segments: S, the per-row segment-slot count of the (B, S) time
        draw.  t_override: optional (B, S) times in place of the draw.
        shard: as ``loss``'s."""
        cfg = self.cfg
        x0 = batch["structure_tokens"]
        seg = batch["segment_ids"]
        B = x0.shape[0]
        shard = shard or RowShard.whole(B)
        S = int(max_segments)
        valid = seg >= 0
        segc = seg.clamp(0, S - 1).long()
        condition_seq = self._condition(batch["sequence_tokens"], draws,
                                        training, shard)
        loss_mask = (batch["mask"] * (x0 != C.STRUCTURE_PAD_TOKEN)
                     * valid.float())
        t = (shard.rows(packed_segment_times(draws, shard.total, S, cfg,
                                             self.noise))
             if t_override is None else t_override)
        cond_seg, move_seg, weight_seg = self._noise_levels(t)   # (B, S)
        # padding slots stay un-noised (outside attention and loss)
        nmm = ~valid
        if batch.get("non_moving_mask") is not None:
            nmm = nmm | batch["non_moving_mask"].bool()
        xt, condition_seq = q_xt(_RowDraws(draws, shard), x0,
                                 move_seg.gather(1, segc), cfg,
                                 condition_seq=condition_seq,
                                 non_moving_mask=nmm)
        # the per-segment sigma embedding, gathered to the tokens
        if not cfg.time_conditioning:
            cond_seg = torch.zeros_like(cond_seg)
        emb = self.sigma_embedder(cond_seg.reshape(B * S)).reshape(B, S, -1)
        aux = emb.gather(1, segc[..., None].expand(-1, -1, emb.shape[-1]))
        count_trunk(*xt.shape, None)
        with tracing.span("trunk.forward"):
            out = self.net(structure_tokens=xt,
                           sequence_tokens=condition_seq, sequence_id=seg,
                           positions=batch["positions"],
                           auxiliary_embeddings=aux)
        logits = logits_parameterization(out.structure_logits, xt, cfg)
        seq_logits = (out.sequence_logits if cfg.sequence_prediction
                      else None)
        return self._nelbo(logits, seq_logits, x0, batch["sequence_tokens"],
                           loss_mask, None if weight_seg is None
                           else weight_seg.gather(1, segc), shard)

    @torch.no_grad()
    def ddpm_sample(self, sequence_tokens, noise_source: NoiseSource,
                    num_steps: int = 25, eps: float = 1e-5, input_prior=None,
                    sample_max_t: float = 1.0, shield_specials: bool = True,
                    sequence_id=None, lengths=None, pack: int = 1,
                    positions=None, positions_valid: Optional[int] = None):
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
        positions_valid: the real positions, for the trunk's counters.
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
            with tracing.span("sample.step"):
                tb = timesteps[i].to(dev).expand(B)
                sigma_t = self.noise.total_noise(tb)
                sigma_s = self.noise.total_noise(tb - dt)
                mc_t = (1 - torch.exp(-sigma_t))[:, None]        # (B, 1)
                mc_s = (1 - torch.exp(-sigma_s))[:, None]
                z, _ = self.forward_logits(
                    x, sequence_tokens, sigma_t[:, None],
                    shield_specials=shield_specials, sequence_id=sequence_id,
                    lengths=lengths, pack=pack, positions=positions,
                    positions_valid=positions_valid)
                copy = x != cfg.mask_index
                if i == num_steps:
                    # noise removal: argmax of p(x0) at still-masked
                    # positions; unmasked positions carry over (the SUBS
                    # rule on tokens)
                    with tracing.span("sample.update"):
                        x = torch.where(copy, x, z.argmax(dim=-1))
                    continue
                # Two-stage form of the reference posterior sample: a
                # masked position stays masked w.p. mc_s/mc_t, else draws
                # x0 ~ softmax(z) by Gumbel-max (no normalisation needed).
                with tracing.span("sample.draws"):
                    gumbel, stay_u = noise_source(i)
                with tracing.span("sample.update"):
                    x_new = (z + gumbel.to(dev)).argmax(dim=-1)
                    stay = stay_u.to(dev) * mc_t < mc_s
                    x_new = torch.where(stay, cfg.mask_index, x_new)
                    x = torch.where(copy, x, x_new)
        return x
