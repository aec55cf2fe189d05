"""Autoregressive structure-token generation (CLM, JLM): port of
``esmdiff_tpu/api/ar_generation.py``.

JAX scans one jitted step over the positions; here the steps are a Python
loop over caches allocated once and written in place.  Each step samples
with temperature, top-p (``diffusion/gibbs.py::top_p_filter``) and the
Gumbel-max of a uniform draw, after the special-token shield.  The sampled
token stays on the device and the loop makes no host copy, so the host only
enqueues work.

Randomness is a draw source ``step -> u``, a (B, V) float32 uniform in
[0, 1) for step ``step`` (CLM: step = position; JLM: step 0 samples the
prefill's token, step i the token after decode step i).  The CLI's
source, ``RowGeneratorDraws``, draws one row's uniforms for every step
from that row's own ``torch.Generator`` (seeded by ``api/generation.py::
request_row_seeds``), so a sample does not depend on how the request is
batched, and draws them once a batch, so a step launches no draw; the
parity tests inject JAX's draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.diffusion.gibbs import top_p_filter
from esmdiff_tpu_torch.diffusion.mdlm import row_generators
from esmdiff_tpu_torch.models.clm import CLM, causal_table
from esmdiff_tpu_torch.models.jlm import JLM

DrawSource = Callable[[int], torch.Tensor]


class RowGeneratorDraws:
    """Default draw source: row b's uniforms for all ``steps`` come from
    one ``torch.Generator`` seeded with ``row_seeds[b]``, drawn once into a
    (B, steps, V) table on ``device``; step s reads column s."""

    def __init__(self, row_seeds: Sequence[int], steps: int, vocab: int,
                 device):
        self.table = torch.empty((len(row_seeds), steps, vocab),
                                 dtype=torch.float32, device=device)
        for row, g in zip(self.table, row_generators(row_seeds, device)):
            torch.rand(row.shape, generator=g, out=row)

    def __call__(self, step: int) -> torch.Tensor:
        return self.table[:, step]


def sample_token(u, logits, temperature: float, top_p: float):
    """Temperature, top-p, then the Gumbel-max of the uniforms ``u``
    (B, V): -> (B,) int64."""
    logits = logits / max(temperature, 1e-4)
    logits = top_p_filter(logits, top_p)
    gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    return (logits + gumbel).argmax(dim=-1)


def shield_specials(logits, shield: Optional[torch.Tensor] = None):
    """-1e9 on the 5 structure specials (4096-4100): they are never
    sampled.  ``shield`` is the (V,) additive vector (``special_shield``),
    made here when not given."""
    if shield is None:
        shield = special_shield(logits.device)
    return logits + shield


def special_shield(device) -> torch.Tensor:
    shield = torch.zeros(C.STRUCTURE_VOCAB_SIZE, device=device)
    shield[C.VQVAE_CODEBOOK_SIZE:] = -1e9
    return shield


@torch.no_grad()
def clm_generate(model: CLM, embeddings, length: int, temperature: float,
                 top_p: float, draws: DrawSource, attention_mask=None):
    """Encoder over (B, Lenc, cond_dim) embeddings, then ``length``
    structure tokens decoded from the start token -> (B, length) int64 on
    the embeddings' device; step ``pos`` samples with ``draws(pos)``."""
    B, dev = embeddings.shape[0], embeddings.device
    enc = model.encode(embeddings, attention_mask)
    caches = model.init_cache(B, length)
    context = model.decode_context(enc, length, attention_mask)
    shield = special_shield(dev)
    out = torch.empty((B, length), dtype=torch.long, device=dev)
    token = torch.full((B,), model.cfg.decoder_start_token_id,
                       dtype=torch.long, device=dev)
    for pos in range(length):
        cond = enc[:, pos] if model.cfg.dec_add_input_emb else None
        logits = model.decode_step(token, pos, enc, caches, attention_mask,
                                   cond, context=context)
        token = sample_token(draws(pos), shield_specials(logits, shield),
                             temperature, top_p)
        out[:, pos] = token
    return out


@torch.no_grad()
def jlm_generate(model: JLM, embeddings, length: int, temperature: float,
                 top_p: float, draws: DrawSource):
    """Prefill the sequence segment (+ separator + BOS structure token),
    then decode ``length`` structure tokens -> (B, length) int64; token i
    samples with ``draws(i)``.  The caches hold T_max = L + offset +
    length + 1 rows."""
    B, L = embeddings.shape[:2]
    dev = embeddings.device
    cfg = model.cfg
    T_max = L + cfg.offset + length + 1
    caches = model.init_cache(B, T_max)
    causal = causal_table(T_max, dev)
    shield = special_shield(dev)
    bos = torch.full((B, 1), C.STRUCTURE_BOS_TOKEN, dtype=torch.long,
                     device=dev)
    logits, prompt_len = model.prefill(embeddings, bos, caches, causal)
    out = torch.empty((B, length), dtype=torch.long, device=dev)
    token = sample_token(draws(0), shield_specials(logits, shield),
                         temperature, top_p)
    out[:, 0] = token
    for i in range(length - 1):
        pos = prompt_len + i
        pos_id = i + 1 if cfg.sep_strategy == "position" else pos
        logits = model.decode_step(token, pos, caches, pos_id, causal)
        token = sample_token(draws(i + 1), shield_specials(logits, shield),
                             temperature, top_p)
        out[:, i + 1] = token
    return out
