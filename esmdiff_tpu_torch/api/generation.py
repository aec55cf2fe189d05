"""Ensemble generation engine, ddpm subset (port of
``esmdiff_tpu/api/generation.py``): the memory-aware batch planner, length
buckets, per-row seeding, the ddpm ensemble and the batched VQ decode.

Sequence packing (``EnsembleSampler._pack`` in JAX) is a TPU MXU schedule
and is not ported yet: the trunk runs unpacked (pack=1) with prefix-length
masking, which computes the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core.tokenizer import StructureTokenizer
from esmdiff_tpu_torch.diffusion.mdlm import (MDLM, MDLMConfig, NoiseSource,
                                              RowGeneratorNoise)
from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise, Noise
from .protein_api import ESM3Runtime, ESMProtein

# Reference inference memory budget (sample_esmdiff.py:75).
N_MAX_RESIDUE_SQUARE = 200 * 200 * 105

# (rows (B, 2) of (request seed, sample index), L, V, device) -> draws
NoiseFactory = Callable[[np.ndarray, int, int, torch.device], NoiseSource]


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Parity with esm.sdk.api.GenerationConfig as used by the reference."""

    track: str = "structure"
    num_steps: int = 16
    temperature: float = 1.4
    top_p: float = 0.9


def plan_batches(length_with_specials: int, num_samples: int,
                 budget: int = N_MAX_RESIDUE_SQUARE,
                 max_batch: Optional[int] = None,
                 policy: str = "ladder") -> list[int]:
    """Split num_samples into batches with L^2 * B <= budget.

    Batch sizes come from the power-of-two ladder (>= 8, capped by the
    memory budget; the JAX package's mesh ``granularity`` is 1 here).
    ``"ladder"`` walks the ladder greedily downward (100 -> 64+32+8);
    ``"single"`` uses one size for every batch (100 -> [64, 64]).  Callers
    trim the surplus rows."""
    per = max(1, budget // (length_with_specials * length_with_specials))
    if max_batch is not None:
        per = min(per, max_batch)
    min_b = 8
    if per >= min_b:
        per = 1 << (per.bit_length() - 1)

    def cap(v: int) -> int:
        return min(v, per)  # memory budget always wins

    if policy == "single":
        b = 1 << max(1, num_samples).bit_length() - 1
        b = cap(max(min_b, b))
        return [b] * (-(-num_samples // b))
    if policy != "ladder":
        raise ValueError(f"unknown plan policy: {policy!r}")

    sizes = []
    left = num_samples
    while left > 0:
        if left >= min_b:
            b = 1 << (left.bit_length() - 1)  # largest pow2 <= left
        else:
            b = min_b  # final round-up: waste < min_b
        sizes.append(cap(b))
        left -= sizes[-1]
    return sizes


def bucket_length(n: int, multiple: int = 32) -> int:
    """Pad length to a bucket (shared shapes across targets)."""
    return ((n + multiple - 1) // multiple) * multiple


def request_row_seeds(rows: np.ndarray) -> list[int]:
    """(B, 2) rows of (request seed, sample index) -> one 63-bit generator
    seed per row, a pure function of the pair (replaces the JAX package's
    ``request_row_keys``)."""
    return [int(np.random.SeedSequence([int(s), int(j)])
                .generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s, j in np.asarray(rows)]


def generator_noise(rows: np.ndarray, length: int, vocab: int,
                    device) -> NoiseSource:
    """The default noise factory: ``RowGeneratorNoise`` seeded per row."""
    return RowGeneratorNoise(request_row_seeds(rows), length, vocab, device)


class EnsembleSampler:
    """Runs ddpm (fine-tuned MDLM) ensemble generation over an
    :class:`ESM3Runtime`."""

    def __init__(self, runtime: ESM3Runtime, noise: Optional[Noise] = None,
                 mdlm_cfg: MDLMConfig = MDLMConfig(),
                 plan_policy: str = "ladder",
                 noise_factory: NoiseFactory = generator_noise):
        """noise_factory: builds each batch's noise source from its rows'
        (request seed, sample index) pairs — the default draws from one
        ``torch.Generator`` per row; tests inject JAX's draws here."""
        self.runtime = runtime
        self.plan_policy = plan_policy
        self.noise = noise or LogLinearNoise()
        self.mdlm_cfg = mdlm_cfg
        self.noise_factory = noise_factory
        self.mdlm = MDLM(runtime.trunk, runtime.sigma_embedder,
                         noise=self.noise, cfg=mdlm_cfg)

    # -- shared helpers -------------------------------------------------------
    def _padded_tokens(self, sequence: str, pad_to: Optional[int]):
        seq_tokens = self.runtime.seq_tokenizer.encode(sequence)
        Lw = len(seq_tokens)
        Lpad = bucket_length(Lw) if pad_to is None else pad_to
        padded = np.full((Lpad,), C.SEQUENCE_PAD_TOKEN, dtype=np.int32)
        padded[:Lw] = seq_tokens
        return padded, Lw

    def _multi_rows(self, sequences: Sequence[str], counts: Sequence[int]):
        """Per-request padded sequence rows, replicated to each request's
        sample count, concatenated into one (N, Lpad) array.  All sequences
        must land in the same length bucket."""
        padded, lws = [], []
        for s in sequences:
            row, lw = self._padded_tokens(s, None)
            padded.append(row)
            lws.append(lw)
        Lpad = len(padded[0])
        if any(len(p) != Lpad for p in padded):
            raise ValueError(
                "coalesced sequences must share a length bucket: got pads "
                f"{sorted({len(p) for p in padded})}")
        seq_rows = np.concatenate(
            [np.tile(p[None], (c, 1)) for p, c in zip(padded, counts)])
        return seq_rows, lws, Lpad

    @staticmethod
    def _split_rows(all_tokens: np.ndarray, lws: Sequence[int],
                    counts: Sequence[int]) -> list[np.ndarray]:
        """Split (N, Lpad) batch rows back per request, trimming each to its
        own interior length (strip BOS/EOS + bucket padding)."""
        out, r = [], 0
        for lw, c in zip(lws, counts):
            out.append(all_tokens[r:r + c, 1:lw - 1])
            r += c
        return out

    # -- ddpm -----------------------------------------------------------------
    def ddpm_ensemble(self, sequence: str, num_samples: int,
                      num_steps: int = 25, eps: float = 1e-5, seed: int = 0,
                      mask_ids: Optional[Sequence[int]] = None,
                      filled_ids: Optional[Sequence[int]] = None,
                      sample_max_t: float = 1.0,
                      budget: int = N_MAX_RESIDUE_SQUARE,
                      max_batch: Optional[int] = None) -> np.ndarray:
        """Generate ``num_samples`` structure-token strings for ``sequence``:
        (num_samples, L) int32 tokens, BOS/EOS stripped."""
        if mask_ids is not None or filled_ids is not None:
            raise NotImplementedError(
                "ddpm inpainting needs the structure encoder, which is not "
                "ported yet")
        return self.ddpm_ensemble_multi(
            [sequence], [num_samples], num_steps=num_steps, eps=eps,
            seed=seed, sample_max_t=sample_max_t, budget=budget,
            max_batch=max_batch)[0]

    def ddpm_ensemble_multi(self, sequences: Sequence[str],
                            counts: Sequence[int], num_steps: int = 25,
                            eps: float = 1e-5, seed: int = 0,
                            sample_max_t: float = 1.0,
                            budget: int = N_MAX_RESIDUE_SQUARE,
                            max_batch: Optional[int] = None,
                            seeds: Optional[Sequence[int]] = None,
                            ) -> list[np.ndarray]:
        """Coalesced ddpm generation: same-bucket requests share one batch
        plan.  Returns one (counts[i], L_i) interior-token array per request.

        seeds: one seed PER REQUEST (default ``seed + i``); a row's draws are
        a function of (its request's seed, its sample index) only."""
        seq_rows, lws, Lpad = self._multi_rows(sequences, counts)
        N = seq_rows.shape[0]
        if seeds is None:
            seeds = [seed + i for i in range(len(sequences))]
        id_rows = np.concatenate([
            np.stack([np.full(c, s), np.arange(c)], axis=1)
            for s, c in zip(seeds, counts)])
        prior_rows = np.full((N, Lpad), C.STRUCTURE_PAD_TOKEN, dtype=np.int64)
        r = 0
        for lw, c in zip(lws, counts):
            prior_rows[r:r + c, :lw] = C.STRUCTURE_MASK_TOKEN
            r += c

        dev = self.runtime.device
        sizes = plan_batches(max(lws), N, budget, max_batch,
                             policy=self.plan_policy)
        outs = []
        start = 0
        for B in sizes:
            # the plan's final round-up batch may exceed the remaining rows:
            # surplus rows re-sample the last row and are trimmed below
            idx = np.minimum(np.arange(start, start + B), N - 1)
            seq_b = torch.as_tensor(seq_rows[idx], dtype=torch.long,
                                    device=dev)
            # padding is a contiguous suffix, so prefix lengths fully
            # describe the mask (the kernel path)
            lengths = (seq_b != C.SEQUENCE_PAD_TOKEN).sum(
                dim=-1, dtype=torch.int32)
            toks = self.mdlm.ddpm_sample(
                seq_b, self.noise_factory(id_rows[idx], Lpad,
                                          self.mdlm_cfg.vocab_size, dev),
                num_steps=num_steps, eps=eps,
                input_prior=torch.as_tensor(prior_rows[idx], device=dev),
                sample_max_t=sample_max_t, lengths=lengths)
            outs.append(toks.cpu().numpy().astype(np.int32))
            start += B
        return self._split_rows(np.concatenate(outs, axis=0), lws, counts)

    # -- decode to proteins ---------------------------------------------------
    def decode_ensemble(self, sequence: str, tokens: np.ndarray,
                        decode_batch: int = 32) -> list[ESMProtein]:
        return decode_tokens_to_proteins(self.runtime, sequence, tokens,
                                         decode_batch)


def _decode_padded_chunk(runtime: ESM3Runtime, rows: list, seqs: list,
                         Lpad: int, decode_batch: int) -> list[ESMProtein]:
    """Decode <= ``decode_batch`` token rows at the fixed (decode_batch,
    Lpad) shape: each row pads to Lpad with STRUCTURE_PAD_TOKEN (masked out
    of decoder attention via ``lengths``), surplus rows repeat the last real
    row, and the output is trimmed back to the real row count."""
    n = len(rows)
    toks_pad = np.full((decode_batch, Lpad), C.STRUCTURE_PAD_TOKEN,
                       dtype=np.int32)
    lens = np.zeros((decode_batch,), np.int32)
    seqs_pad = list(seqs) + [seqs[-1]] * (decode_batch - n)
    for r, row in enumerate(rows):
        toks_pad[r, :len(row)] = row
        lens[r] = len(row)
    for r in range(n, decode_batch):
        toks_pad[r] = toks_pad[n - 1]
        lens[r] = lens[n - 1]
    return runtime.decode_batch(toks_pad, seqs_pad, lengths=lens)[:n]


def decode_tokens_to_proteins(runtime: ESM3Runtime, sequence: str,
                              tokens: np.ndarray,
                              decode_batch: int = 32) -> list[ESMProtein]:
    """Batched VQ-VAE decode of (N, L) interior tokens, ``decode_batch``
    rows per decoder call, rows padded to the 32-multiple length bucket."""
    rows = [StructureTokenizer.add_bos_eos(t.astype(np.int32))
            for t in tokens]
    Lpad = bucket_length(len(rows[0]))
    prots: list[ESMProtein] = []
    for s in range(0, len(rows), decode_batch):
        chunk = rows[s:s + decode_batch]
        prots.extend(_decode_padded_chunk(
            runtime, chunk, [sequence] * len(chunk), Lpad, decode_batch))
    return prots
