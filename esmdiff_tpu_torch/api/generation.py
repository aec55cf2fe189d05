"""Ensemble generation engine (port of ``esmdiff_tpu/api/generation.py``):
the memory-aware batch planner, length buckets, per-row seeding, sequence
packing of short buckets, the ddpm engines (solo, same-bucket coalesced,
cross-length packed, and the cost-routed mixed one that picks between the
last two), the gibbs engines (solo, coalesced, and mixed as per-bucket
sub-groups), the eb engine, block diffusion over an SDAR trunk
(``block_ensemble``), inpainting from an encoded structure (ddpm's
``mask_ids``/``filled_ids``, gibbs's coordinate prior), and the batched VQ
decode, also coalesced across requests.

A sample's draws depend only on (its request's seed, its index in the
request): a noise factory builds them for a row of the sample's own length
bucket, and the packed engine places each sample's draws where its segment
lies (``SegmentNoise``), so a sample draws the same solo, coalesced or
packed.  The gibbs and eb samplers take their uniforms from a second
factory of the same form (``uniform_factory``).

Data parallelism (``devices=``): one replica of the trunk and the sigma
embedder a device, in one process, and each batch's rows split across
them, each part on a thread of its own (the JAX sampler is one controller
too, and the server one process).  A row's draws depend only on (its
request's seed, its index), so the ensemble is the same with or without
the split, up to the trunk's floating-point reduction order at the
parts' row counts.

Tracing (``utils/tracing.py``): each ensemble call is a root
``sample.request`` span; inside it ``sample.plan`` (the rows, the batch
plan, the pack factors), ``sample.batch`` a batch (each part's spans on
its replica's thread under it), the sampler's ``sample.step`` /
``sample.draws`` / ``trunk.forward`` / ``sample.update``, and
``sample.to_host``; ``decode`` around a decode call.  Counters, from the
host's rows: ``plan.rows_asked`` and ``plan.rows_run`` (the samples and
the rows the plan runs, surplus rows included), the trunk's
``trunk.positions_valid`` and ``trunk.positions_run`` a forward (real and
run positions, ``diffusion/mdlm.py::count_trunk``), ``decode.rows_valid``
and ``decode.rows_run``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import inspect
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core.tokenizer import StructureTokenizer
from esmdiff_tpu_torch.diffusion.block import block_sample
from esmdiff_tpu_torch.diffusion.gibbs import (RowGeneratorUniform,
                                               UniformSource,
                                               entropy_bounded_unmask_sample,
                                               iterative_unmask_sample)
from esmdiff_tpu_torch.diffusion.mdlm import (MDLM, MDLMConfig, NoiseSource,
                                              RowGeneratorNoise, count_trunk,
                                              shield_special_tokens)
from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise, Noise
from esmdiff_tpu_torch.models.sdar import SEQUENCE_OFFSET, STRUCTURE_CODES
from esmdiff_tpu_torch.ops.packing import (PACK_TARGET_LEN, pack_factor,
                                           packed_positions,
                                           packed_segment_ids,
                                           plan_segment_rows)
from esmdiff_tpu_torch.utils import tracing
from .protein_api import ESM3Runtime, ESMProtein

# Reference inference memory budget (sample_esmdiff.py:75).
N_MAX_RESIDUE_SQUARE = 200 * 200 * 105

# (rows (B, 2) of (request seed, sample index), L, V, device) -> draws
NoiseFactory = Callable[[np.ndarray, int, int, torch.device], NoiseSource]
UniformFactory = Callable[[np.ndarray, int, int, torch.device],
                          UniformSource]


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
    ``"single"`` uses one size for every batch (100 -> [64, 64]);
    ``"even"`` takes the fewest batches the cap allows, of one size off the
    ladder (100 at a cap of 128 -> [100]; 200 -> [100, 100]).  Callers
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
    if policy == "even":
        k = -(-max(1, num_samples) // per)
        return [-(-max(1, num_samples) // k)] * k
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


def generator_uniforms(rows: np.ndarray, length: int, vocab: int,
                       device) -> UniformSource:
    """The default uniform factory of the gibbs and eb samplers:
    ``RowGeneratorUniform`` seeded per row."""
    return RowGeneratorUniform(request_row_seeds(rows), length, vocab, device)


class SegmentNoise:
    """The draws of a packed (R, T) layout: each segment (one sample)
    gets exactly the draws of its solo run.  Segments are grouped by their
    length bucket; one source per group, from ``factory`` at the bucket's
    length (the solo run's row length), and each segment's positions
    0..lw-1 are copied into its span.  Positions outside every segment
    draw nothing (they are padding, which the sampler copies through).

    placed: (request seed, sample index, lw, row, offset) per segment."""

    def __init__(self, factory: NoiseFactory, placed, R: int, T: int,
                 vocab: int, device):
        self.R, self.T, self.vocab = R, T, vocab
        self.device = torch.device(device)
        by_bucket: dict[int, list] = {}
        for seg in placed:
            by_bucket.setdefault(bucket_length(seg[2]), []).append(seg)
        self.groups = []
        for Lb, segs in sorted(by_bucket.items()):
            rows = np.array([[s, j] for s, j, _, _, _ in segs])
            src = np.concatenate([i * Lb + np.arange(lw)
                                  for i, (_, _, lw, _, _) in enumerate(segs)])
            dst = np.concatenate([r * T + off + np.arange(lw)
                                  for _, _, lw, r, off in segs])
            self.groups.append((
                factory(rows, Lb, vocab, self.device),
                torch.as_tensor(src, device=self.device),
                torch.as_tensor(dst, device=self.device)))

    def __call__(self, step: int):
        kw = dict(device=self.device, dtype=torch.float32)
        gumbel = torch.zeros((self.R * self.T, self.vocab), **kw)
        stay_u = torch.ones((self.R * self.T,), **kw)
        for source, src, dst in self.groups:
            g, u = source(step)
            gumbel[dst] = g.to(self.device).reshape(-1, self.vocab)[src]
            stay_u[dst] = u.to(self.device).reshape(-1)[src]
        return (gumbel.view(self.R, self.T, self.vocab),
                stay_u.view(self.R, self.T))


def _request(mode: str):
    """An ensemble call (its first arguments the sequence or sequences
    and the sample count or counts) as a ``sample.request`` span: attrs
    mode, residues and samples."""
    def wrap(fn):
        sig = inspect.signature(fn)
        seq_arg, count_arg = list(sig.parameters)[1:3]

        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            if not tracing.enabled():
                return fn(self, *args, **kwargs)
            given = sig.bind(self, *args, **kwargs).arguments
            seqs, counts = given[seq_arg], given[count_arg]
            one = isinstance(seqs, str)
            with tracing.span(
                    "sample.request", mode=mode,
                    residues=len(seqs) if one else [len(q) for q in seqs],
                    samples=int(counts) if one else [int(c) for c in counts]):
                return fn(self, *args, **kwargs)
        return call
    return wrap


@dataclasses.dataclass
class Replica:
    """A copy of the runtime's trunk (and sigma embedder) on one device."""

    device: torch.device
    trunk: torch.nn.Module
    mdlm: MDLM


class EnsembleSampler:
    """Runs ddpm (fine-tuned MDLM), gibbs (iterative unmasking) or eb
    (entropy-bounded unmasking) ensemble generation over an
    :class:`ESM3Runtime`."""

    def __init__(self, runtime: ESM3Runtime, noise: Optional[Noise] = None,
                 mdlm_cfg: MDLMConfig = MDLMConfig(),
                 plan_policy: str = "ladder",
                 noise_factory: NoiseFactory = generator_noise,
                 uniform_factory: UniformFactory = generator_uniforms,
                 devices: Optional[Sequence] = None):
        """noise_factory: builds each ddpm batch's noise source from its
        rows' (request seed, sample index) pairs; uniform_factory does the
        same for the gibbs and eb samplers.  The defaults draw from one
        ``torch.Generator`` per row; tests inject JAX's draws here.
        devices: split each batch's rows across one replica a device (the
        runtime's own modules on its device, copies elsewhere); None = the
        runtime's device alone.  The VQ decode and the encoder stay on the
        runtime's device."""
        self.runtime = runtime
        self.plan_policy = plan_policy
        self.noise = noise or LogLinearNoise()
        self.mdlm_cfg = mdlm_cfg
        self.noise_factory = noise_factory
        self.uniform_factory = uniform_factory
        self.mdlm = MDLM(runtime.trunk, runtime.sigma_embedder,
                         noise=self.noise, cfg=mdlm_cfg)
        self.replicas = [Replica(runtime.device, runtime.trunk, self.mdlm)]
        if devices:
            self.replicas = [self._replica(torch.device(d), i)
                             for i, d in enumerate(devices)]
        # the step count of each batch (each part of a split batch) of the
        # last eb_ensemble call
        self.eb_steps: list[int] = []
        # block_ensemble's steps and commits as CUDA graphs on a card,
        # captured once a batch shape (diffusion/block.py), or eagerly
        self.block_graphs = True
        self.block_forwards: dict = {}

    def _replica(self, dev: torch.device, i: int) -> Replica:
        rt = self.runtime
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        if i == 0 and dev == rt.device:
            return Replica(dev, rt.trunk, self.mdlm)
        trunk = copy.deepcopy(rt.trunk).to(dev)
        sigma = (None if rt.sigma_embedder is None
                 else copy.deepcopy(rt.sigma_embedder).to(dev))
        return Replica(dev, trunk, MDLM(trunk, sigma, noise=self.noise,
                                        cfg=self.mdlm_cfg))

    def _parallel(self, jobs: list) -> list:
        """Run ``jobs`` (replica, fn) -> [fn(replica), ...] in order: in
        this thread on one replica, else on a thread a replica, its spans
        under the caller's."""
        def call(job):
            rep, fn = job
            with (torch.cuda.device(rep.device) if rep.device.type == "cuda"
                  else contextlib.nullcontext()):
                return fn(rep)

        if len(self.replicas) == 1:
            return [call(j) for j in jobs]
        parent = tracing.current()

        def adopted(job):
            with tracing.within(parent):
                return call(job)

        with ThreadPoolExecutor(len(self.replicas)) as pool:
            return list(pool.map(adopted, jobs))

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

    def _request_rows(self, sequences: Sequence[str], counts: Sequence[int],
                     seeds: Sequence[int]):
        """Every sample row of a same-bucket group of requests: sequence
        (``_multi_rows``), initial structure tokens (MASK on every valid
        position, PAD past it), decode mask (the interior) and (request
        seed, sample index); and each request's length with specials."""
        with tracing.span("sample.plan"):
            seq_rows, lws, Lpad = self._multi_rows(sequences, counts)
            N = seq_rows.shape[0]
            id_rows = np.concatenate([
                np.stack([np.full(c, s), np.arange(c)], axis=1)
                for s, c in zip(seeds, counts)])
            init_rows = np.full((N, Lpad), C.STRUCTURE_PAD_TOKEN,
                                dtype=np.int64)
            dmask_rows = np.zeros((N, Lpad), dtype=bool)
            r = 0
            for lw, c in zip(lws, counts):
                init_rows[r:r + c, :lw] = C.STRUCTURE_MASK_TOKEN
                dmask_rows[r:r + c, 1:lw - 1] = True
                r += c
        return seq_rows, init_rows, dmask_rows, id_rows, lws

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
    @_request("ddpm")
    def ddpm_ensemble(self, sequence: str, num_samples: int,
                      num_steps: int = 25, eps: float = 1e-5, seed: int = 0,
                      mask_ids: Optional[Sequence[int]] = None,
                      filled_ids: Optional[Sequence[int]] = None,
                      structure_tokens: Optional[np.ndarray] = None,
                      sample_max_t: float = 1.0,
                      budget: int = N_MAX_RESIDUE_SQUARE,
                      max_batch: Optional[int] = None,
                      ref_compat: bool = False) -> np.ndarray:
        """Generate ``num_samples`` structure-token strings for ``sequence``:
        (num_samples, L) int32 tokens, BOS/EOS stripped.

        Inpainting: with ``mask_ids`` (residues to generate) or
        ``filled_ids`` (residues to keep, every other one generated),
        ``structure_tokens`` (L+2,) with BOS/EOS (``ESM3Runtime.encode``)
        is the prior; the other positions keep its tokens (the SUBS
        carry-over).  ref_compat: mask TOKEN position ``idx`` of the
        BOS-led row, i.e. residue ``idx - 1``, as the reference sampler
        does; the default masks residue ``idx``."""
        seq_rows, prior_rows, _, id_rows, lws = self._request_rows(
            [sequence], [num_samples], [seed])
        if mask_ids is not None or filled_ids is not None:
            if structure_tokens is None:
                raise ValueError("inpainting (mask_ids/filled_ids) needs the "
                                 "prior's structure_tokens")
            Lw = lws[0]
            off = 0 if ref_compat else 1  # +1 maps residue idx -> token idx
            prior = prior_rows[0]
            prior[:Lw] = structure_tokens
            if mask_ids is not None:
                for idx in mask_ids:
                    prior[idx + off] = C.STRUCTURE_MASK_TOKEN
            else:
                keep = set(filled_ids)
                for idx in range(Lw - 2):
                    if idx not in keep:
                        prior[idx + off] = C.STRUCTURE_MASK_TOKEN
            prior_rows[:] = prior
        return self._ddpm(seq_rows, prior_rows, id_rows, lws, [num_samples],
                          num_steps, eps, sample_max_t, budget, max_batch)[0]

    @_request("ddpm")
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
        if seeds is None:
            seeds = [seed + i for i in range(len(sequences))]
        seq_rows, prior_rows, _, id_rows, lws = self._request_rows(
            sequences, counts, seeds)
        return self._ddpm(seq_rows, prior_rows, id_rows, lws, counts,
                          num_steps, eps, sample_max_t, budget, max_batch)

    def _ddpm(self, seq_rows, prior_rows, id_rows, lws, counts, num_steps,
              eps, sample_max_t, budget, max_batch) -> list[np.ndarray]:
        """``MDLM.ddpm_sample`` over a same-bucket group's rows, from
        ``prior_rows``, batch by batch: one interior-token array per
        request."""
        Lpad = seq_rows.shape[1]

        def run(rep, idx, seq_b, lengths, pack, valid):
            return rep.mdlm.ddpm_sample(
                seq_b, self.noise_factory(id_rows[idx], Lpad,
                                          self.mdlm_cfg.vocab_size,
                                          rep.device),
                num_steps=num_steps, eps=eps,
                input_prior=torch.as_tensor(prior_rows[idx],
                                            device=rep.device),
                sample_max_t=sample_max_t, lengths=lengths, pack=pack,
                positions_valid=valid)

        toks, _ = self._run_batches(seq_rows, max(lws), budget, max_batch,
                                    run)
        return self._split_rows(toks, lws, counts)

    def _run_batches(self, seq_rows: np.ndarray, length_with_specials: int,
                     budget: int, max_batch: Optional[int], run):
        """Plan the (N, Lpad) rows into batches (``plan_batches``) and run
        each through ``run(replica, idx, seq_b, lengths, pack, valid)`` ->
        (B, Lpad) tokens, or (tokens, info), where idx are the batch's row
        indices (with several replicas, each a contiguous part of the
        batch's rows) and valid the real positions of its rows that are
        not surplus (a host integer, for the trunk's counters); returns
        the N rows' tokens and the infos in order.  The plan's final
        round-up batch may exceed the remaining rows: its surplus rows
        re-sample the last row and are trimmed."""
        N, Lpad = seq_rows.shape

        def part(idx, valid, pack):
            def on(rep):
                seq_b = torch.as_tensor(seq_rows[idx], dtype=torch.long,
                                        device=rep.device)
                # padding is a contiguous suffix, so prefix lengths fully
                # describe the mask (the kernel path)
                lengths = (seq_b != C.SEQUENCE_PAD_TOKEN).sum(
                    dim=-1, dtype=torch.int32)
                out = run(rep, idx, seq_b, lengths, pack, valid)
                toks, info = out if isinstance(out, tuple) else (out, None)
                with tracing.span("sample.to_host"):
                    toks = toks.cpu()
                return toks.numpy().astype(np.int32), info
            return on

        with tracing.span("sample.plan"):
            sizes = plan_batches(length_with_specials, N, budget, max_batch,
                                 policy=self.plan_policy)
            row_valid = (seq_rows != C.SEQUENCE_PAD_TOKEN).sum(axis=1)
            batches, start = [], 0
            for B in sizes:
                rows = np.arange(start, start + B)
                batches.append((B, [
                    (np.minimum(p, N - 1), int(row_valid[p[p < N]].sum()),
                     self._pack(len(p), Lpad))
                    for p in np.array_split(rows, len(self.replicas))
                    if len(p)]))
                start += B
        tracing.count("plan.rows_asked", N)
        tracing.count("plan.rows_run", sum(sizes))
        outs, infos = [], []
        for B, parts in batches:
            with tracing.span("sample.batch", B=B, L=Lpad, pack=parts[0][2]):
                for toks, info in self._parallel(
                        [(rep, part(*p))
                         for rep, p in zip(self.replicas, parts)]):
                    outs.append(toks)
                    if info is not None:
                        infos.append(info)
        return np.concatenate(outs, axis=0)[:N], infos

    @staticmethod
    def _pack(B: int, L: int) -> int:
        """Sequence-packing factor of a (B, L) batch (ops/packing.py): k
        same-length rows share one device row under a block-diagonal
        segment mask.  The sampler's state and draws stay at (B, L)."""
        return pack_factor(B, L)

    # -- cross-length packed ddpm ---------------------------------------------
    # The JAX package's routing curve: per-row step cost of the int8 trunk
    # at row width T (relative costs; measured on a TPU v5e by the JAX
    # package, not on this card).  Kept so that routes match JAX's; only
    # its shape matters to the router.
    _ROW_COST_POINTS = ((64, 1.12), (128, 2.02), (256, 4.99),
                        (512, 10.8), (1024, 21.5))

    @classmethod
    def _row_step_cost(cls, T: int) -> float:
        pts = cls._ROW_COST_POINTS
        if T <= pts[0][0]:
            return pts[0][1] * T / pts[0][0]
        for (t0, c0), (t1, c1) in zip(pts, pts[1:]):
            if T <= t1:
                return c0 + (c1 - c0) * (T - t0) / (t1 - t0)
        t1, c1 = pts[-1]
        return c1 * T / t1

    def _mixed_route(self, lws: Sequence[int], counts: Sequence[int],
                     T: int) -> tuple[str, float, float]:
        """('packed'|'split', packed_cost, split_cost) for a mixed group.

        split: each bucket runs its own batches; same-bucket packing to
        PACK_TARGET_LEN means a segment of bucket Lb shares a
        W=max(Lb, 128)-wide row with W//Lb peers.  packed: first-fit-
        decreasing layout into T-wide rows."""
        split = 0.0
        for lw, c in zip(lws, counts):
            Lb = bucket_length(lw)
            W = max(Lb, PACK_TARGET_LEN)
            split += c * self._row_step_cost(W) / max(1, W // Lb)
        seg_lens = [lw for lw, c in zip(lws, counts) for _ in range(c)]
        packed = len(plan_segment_rows(seg_lens, T)) * self._row_step_cost(T)
        return ("packed" if packed < split * 0.98 else "split",
                packed, split)

    @_request("ddpm")
    def ddpm_ensemble_mixed(self, sequences: Sequence[str],
                            counts: Sequence[int], num_steps: int = 25,
                            eps: float = 1e-5,
                            seeds: Optional[Sequence[int]] = None,
                            max_batch: Optional[int] = None,
                            budget: int = N_MAX_RESIDUE_SQUARE,
                            ) -> list[np.ndarray]:
        """Cost-routed coalescing of a group spanning length buckets: one
        cross-length packed program (:meth:`ddpm_ensemble_packed`) when the
        routing curve says it is cheaper, else each bucket's sub-group
        through :meth:`ddpm_ensemble_multi`.  Per-request seeds keep the
        draws independent of co-batched traffic on both routes."""
        if seeds is None:
            seeds = list(range(len(sequences)))
        lws = [len(self.runtime.seq_tokenizer.encode(s)) for s in sequences]
        T = max(128, bucket_length(max(lws), 64))
        route, _, _ = self._mixed_route(lws, counts, T)
        if route == "packed":
            return self.ddpm_ensemble_packed(
                sequences, counts, num_steps=num_steps, eps=eps,
                seeds=seeds, budget=budget)
        results: list = [None] * len(sequences)
        by_bucket: dict[int, list[int]] = {}
        for i, lw in enumerate(lws):
            by_bucket.setdefault(bucket_length(lw), []).append(i)
        for _, idxs in sorted(by_bucket.items()):
            outs = self.ddpm_ensemble_multi(
                [sequences[i] for i in idxs], [counts[i] for i in idxs],
                num_steps=num_steps, eps=eps,
                seeds=[seeds[i] for i in idxs], max_batch=max_batch,
                budget=budget)
            for i, o in zip(idxs, outs):
                results[i] = o
        return results

    @_request("ddpm")
    def ddpm_ensemble_packed(self, sequences: Sequence[str],
                             counts: Sequence[int], num_steps: int = 25,
                             eps: float = 1e-5, sample_max_t: float = 1.0,
                             budget: int = N_MAX_RESIDUE_SQUARE,
                             seeds: Optional[Sequence[int]] = None,
                             ) -> list[np.ndarray]:
        """Cross-length coalesced ddpm: requests from different length
        buckets share device rows.  Each sample is a segment; segments pack
        first-fit-decreasing into rows of width T (>= the largest bucket)
        under a block-diagonal segment mask, positions restarting per
        segment, in chunks of Rb rows (the L^2 * B memory budget on T,
        on the power-of-two ladder from 8).

        Each segment draws exactly its solo run's draws (``SegmentNoise``),
        so a request's tokens match its solo run up to the trunk's
        floating-point reduction order across layouts.
        Returns one (counts[i], L_i) interior-token array per request."""
        if seeds is None:
            seeds = list(range(len(sequences)))
        with tracing.span("sample.plan"):
            seq_toks = [np.asarray(self.runtime.seq_tokenizer.encode(s))
                        for s in sequences]
            lws = [len(t) for t in seq_toks]
            # (request, sample) -> one segment each, request-major
            segs = [(i, j) for i, c in enumerate(counts) for j in range(c)]
            T = max(128, bucket_length(max(lws), 64))
            rows = plan_segment_rows([lws[i] for i, _ in segs], T)
            R = len(rows)
            max_rows = max(1, budget // (T * T))
            Rb = min(1 << (max_rows.bit_length() - 1),
                     max(8, _pow2_at_least(R)))

        out_per_seg: list = [None] * len(segs)

        def chunk(start):
            seq_a = np.full((Rb, T), C.SEQUENCE_PAD_TOKEN, np.int64)
            prior = np.full((Rb, T), C.STRUCTURE_PAD_TOKEN, np.int64)
            segid = np.full((Rb, T), -1, np.int64)
            posit = np.zeros((Rb, T), np.int64)
            placed = []                      # (global seg, row, offset, lw)
            for r, row in enumerate(rows[start:start + Rb]):
                off = 0
                for s_local, gseg in enumerate(row):
                    i, _ = segs[gseg]
                    lw = lws[i]
                    seq_a[r, off:off + lw] = seq_toks[i]
                    prior[r, off:off + lw] = C.STRUCTURE_MASK_TOKEN
                    segid[r, off:off + lw] = s_local
                    posit[r, off:off + lw] = np.arange(lw)
                    placed.append((gseg, r, off, lw))
                    off += lw

            def on(rep):
                dev = rep.device
                noise = SegmentNoise(
                    self.noise_factory,
                    [(seeds[segs[g][0]], segs[g][1], lw, r, off)
                     for g, r, off, lw in placed],
                    Rb, T, self.mdlm_cfg.vocab_size, dev)
                toks = rep.mdlm.ddpm_sample(
                    torch.as_tensor(seq_a, device=dev), noise,
                    num_steps=num_steps, eps=eps,
                    input_prior=torch.as_tensor(prior, device=dev),
                    sample_max_t=sample_max_t,
                    sequence_id=torch.as_tensor(segid, device=dev),
                    positions=torch.as_tensor(posit, device=dev),
                    positions_valid=sum(lw for _, _, _, lw in placed))
                with tracing.span("sample.to_host"):
                    toks = toks.cpu()
                return placed, toks.numpy().astype(np.int32)
            return on

        # each chunk of Rb rows on one replica, the chunks round robin
        starts = list(range(0, R, Rb))
        n = len(self.replicas)
        for i in range(0, len(starts), n):
            jobs = [(self.replicas[j], chunk(st))
                    for j, st in enumerate(starts[i:i + n])]
            with tracing.span("sample.batch", B=Rb * len(jobs), L=T):
                done = self._parallel(jobs)
            for placed, toks in done:
                for gseg, r, off, lw in placed:
                    out_per_seg[gseg] = toks[r, off + 1:off + lw - 1]
        res, k = [], 0
        for c in counts:
            res.append(np.stack(out_per_seg[k:k + c]))
            k += c
        return res

    # -- gibbs and eb ---------------------------------------------------------
    def _trunk_forward(self, pack: int = 1, trunk=None):
        """(tokens, seq_tokens, lengths, positions_valid=None) -> float32
        raw structure logits (B, L, V) of ``trunk`` (default the
        runtime's), a ``trunk.forward`` span, counted (``count_trunk``):
        the specials
        shielded unless the head is the stock 4096-way one, optionally
        through the sequence-packed view (the caller keeps (B, L)).  No
        mask-token shield: on the stock head the mask token lies past V,
        so gibbs and eb do not go through ``MDLM.forward_logits``."""
        trunk = self.runtime.trunk if trunk is None else trunk
        stock_head = trunk.cfg.head_type == "esm3"

        def forward(tokens, seq_tokens, lengths, positions_valid=None):
            B, L = tokens.shape
            count_trunk(B, L, positions_valid)
            with tracing.span("trunk.forward"):
                if pack > 1:
                    out = trunk(
                        structure_tokens=tokens.reshape(B // pack, pack * L),
                        sequence_tokens=seq_tokens.reshape(B // pack,
                                                           pack * L),
                        sequence_id=packed_segment_ids(lengths, L, pack),
                        positions=packed_positions(L, pack,
                                                   device=tokens.device))
                else:
                    out = trunk(structure_tokens=tokens,
                                sequence_tokens=seq_tokens, lengths=lengths)
            # the head's float32 output is fresh: shield it in place
            logits = out.structure_logits.float().reshape(B, L, -1)
            if not stock_head:
                shield_special_tokens(logits)
            return logits

        return forward

    def _unmask(self, rows, counts: Sequence[int], budget: int,
                max_batch: Optional[int], sample):
        """An unmasking sampler, ``sample(forward, uniforms, init,
        dmask)`` -> tokens or (tokens, info), over a same-bucket group's
        ``rows`` (``_request_rows``), batch by batch through
        ``_trunk_forward``: (one (counts[i], L_i) interior-token array per
        request, the infos in batch order)."""
        seq_rows, init_rows, dmask_rows, id_rows, lws = rows
        Lpad = seq_rows.shape[1]

        def run(rep, idx, seq_b, lengths, pack, valid):
            forward = self._trunk_forward(pack, rep.trunk)
            dev = rep.device
            return sample(
                lambda tokens: forward(tokens, seq_b, lengths, valid),
                self.uniform_factory(id_rows[idx], Lpad,
                                     self._logits_width(), dev),
                torch.as_tensor(init_rows[idx], device=dev),
                torch.as_tensor(dmask_rows[idx], device=dev))

        toks, infos = self._run_batches(seq_rows, max(lws), budget,
                                        max_batch, run)
        return self._split_rows(toks, lws, counts), infos

    def _logits_width(self) -> int:
        cfg = self.runtime.trunk.cfg
        return (C.VQVAE_CODEBOOK_SIZE if cfg.head_type == "esm3"
                else cfg.n_structure_heads)

    @_request("gibbs")
    def gibbs_ensemble(self, sequence: str, num_samples: int,
                       config: GenerationConfig = GenerationConfig(),
                       seed: int = 0,
                       coordinates: Optional[np.ndarray] = None,
                       mask_ids: Optional[Sequence[int]] = None,
                       budget: int = N_MAX_RESIDUE_SQUARE,
                       max_batch: Optional[int] = None) -> np.ndarray:
        """Iterative confidence-ranked unmasking with the (pretrained)
        trunk: (num_samples, L) int32 structure tokens, BOS/EOS stripped.

        coordinates: (L, 37, 3) atom37, NaN/inf where unknown: residues
        with a finite backbone start at their encoded tokens and stay
        fixed; only the others are decoded.  mask_ids: residues to
        inpaint, which become '_' in the sequence and inf in the
        coordinates (needs ``coordinates``)."""
        if mask_ids is not None:
            if coordinates is None:
                raise ValueError("inpainting (mask_ids) needs coordinates")
            masked = set(mask_ids)
            sequence = "".join("_" if i in masked else ch
                               for i, ch in enumerate(sequence))
            coordinates = coordinates.copy()
            coordinates[list(mask_ids)] = np.inf
        rows = self._request_rows([sequence], [num_samples], [seed])
        if coordinates is not None:
            _, init_rows, dmask_rows, _, (Lw,) = rows
            pt = self.runtime.encode(ESMProtein(sequence=sequence,
                                                coordinates=coordinates))
            # "known" on the backbone slots only: the unused atom37 slots
            # are NaN for every residue
            known = np.isfinite(coordinates[:, :3]).all(axis=(-1, -2))
            init_rows[:, 1:Lw - 1] = np.where(known, pt.structure[1:-1],
                                              C.STRUCTURE_MASK_TOKEN)
            dmask_rows[:, 1:Lw - 1] = ~known

        return self._unmask(rows, [num_samples], budget, max_batch,
                            _gibbs_sample(config))[0][0]

    @_request("gibbs")
    def gibbs_ensemble_multi(self, sequences: Sequence[str],
                             counts: Sequence[int],
                             config: GenerationConfig = GenerationConfig(),
                             seed: int = 0,
                             budget: int = N_MAX_RESIDUE_SQUARE,
                             max_batch: Optional[int] = None,
                             seeds: Optional[Sequence[int]] = None,
                             ) -> list[np.ndarray]:
        """Coalesced gibbs generation: same-bucket requests share one batch
        plan.  Returns one (counts[i], L_i) interior-token array per
        request.  seeds: one seed PER REQUEST (default ``seed + i``)."""
        if seeds is None:
            seeds = [seed + i for i in range(len(sequences))]

        return self._unmask(self._request_rows(sequences, counts, seeds),
                            counts, budget, max_batch,
                            _gibbs_sample(config))[0]

    @_request("gibbs")
    def gibbs_ensemble_mixed(self, sequences: Sequence[str],
                             counts: Sequence[int],
                             config: GenerationConfig = GenerationConfig(),
                             seeds: Optional[Sequence[int]] = None,
                             max_batch: Optional[int] = None,
                             budget: int = N_MAX_RESIDUE_SQUARE,
                             ) -> list[np.ndarray]:
        """A gibbs group spanning length buckets: each bucket's sub-group
        through :meth:`gibbs_ensemble_multi` (no cross-length packed route:
        the unmasking quotas are per row)."""
        if seeds is None:
            seeds = list(range(len(sequences)))
        results: list = [None] * len(sequences)
        by_bucket: dict[int, list[int]] = {}
        for i, s in enumerate(sequences):
            lw = len(self.runtime.seq_tokenizer.encode(s))
            by_bucket.setdefault(bucket_length(lw), []).append(i)
        for _, idxs in sorted(by_bucket.items()):
            outs = self.gibbs_ensemble_multi(
                [sequences[i] for i in idxs], [counts[i] for i in idxs],
                config=config, seeds=[seeds[i] for i in idxs],
                max_batch=max_batch, budget=budget)
            for i, o in zip(idxs, outs):
                results[i] = o
        return results

    @_request("eb")
    def eb_ensemble(self, sequence: str, num_samples: int,
                    entropy_budget: float = 1.0, temperature: float = 1.0,
                    top_p: float = 1.0, max_steps: int = 64, seed: int = 0,
                    budget: int = N_MAX_RESIDUE_SQUARE,
                    max_batch: Optional[int] = None) -> np.ndarray:
        """Adaptive-step unmasking (``entropy_bounded_unmask_sample``):
        (num_samples, L) interior tokens.  Each batch's step count is kept
        in ``self.eb_steps``."""
        def sample(fwd, uniforms, init, dmask):
            return entropy_bounded_unmask_sample(
                fwd, uniforms, init, dmask, entropy_budget=entropy_budget,
                temperature=temperature, top_p=top_p, max_steps=max_steps)

        (toks,), self.eb_steps = self._unmask(
            self._request_rows([sequence], [num_samples], [seed]),
            [num_samples], budget, max_batch, sample)
        return toks

    # -- block diffusion (SDAR) -----------------------------------------------
    @_request("block")
    def block_ensemble(self, sequence: str, num_samples: int,
                       block_length: int = 4, steps: int = 4,
                       temperature: float = 1.0, seed: int = 0,
                       budget: int = N_MAX_RESIDUE_SQUARE,
                       max_batch: Optional[int] = None) -> np.ndarray:
        """Block-diffusion sampling (``diffusion/block.py``) with the
        runtime's SDAR model as its trunk: (num_samples, L) int32 structure
        tokens, as ``ddpm_ensemble`` returns them.  Each batch's rows share
        the prompt [BOS, residues, EOS]; a row's draws come from
        ``uniform_factory`` over (block_length, 4096) a step."""
        seq_rows, _, _, id_rows, lws = self._request_rows(
            [sequence], [num_samples], [seed])
        lw, Lpad = lws[0], seq_rows.shape[1]

        def run(rep, idx, seq_b, lengths, pack, valid):
            toks = block_sample(
                rep.trunk, seq_b[:, :lw] + SEQUENCE_OFFSET, lw - 2,
                self.uniform_factory(id_rows[idx], block_length,
                                     STRUCTURE_CODES, rep.device),
                block_length=block_length, steps=steps,
                temperature=temperature, graphs=self.block_graphs,
                held=self.block_forwards)
            out = torch.full((len(idx), Lpad), C.STRUCTURE_PAD_TOKEN,
                             dtype=torch.long, device=rep.device)
            out[:, 1:lw - 1] = toks
            return out

        toks, _ = self._run_batches(seq_rows, lw, budget, max_batch, run)
        return self._split_rows(toks, lws, [num_samples])[0]

    # -- decode to proteins ---------------------------------------------------
    def decode_ensemble(self, sequence: str, tokens: np.ndarray,
                        decode_batch: int = 32) -> list[ESMProtein]:
        with tracing.span("decode", rows=len(tokens)):
            return decode_tokens_to_proteins(self.runtime, sequence, tokens,
                                             decode_batch)

    def decode_ensemble_multi(self, sequences: Sequence[str],
                              tokens_list: Sequence[np.ndarray],
                              decode_batch: int = 32,
                              ) -> list[list[ESMProtein]]:
        """Coalesced VQ decode: rows of several requests share decoder
        batches, grouped by length bucket (rows padded to the bucket, pad
        masked out through ``lengths``); a chunk of n rows decodes at
        min(decode_batch, the power of two >= n) rows."""
        results: list[list] = [[None] * t.shape[0] for t in tokens_list]
        by_bucket: dict[int, list] = {}
        with tracing.span("decode", rows=sum(len(t) for t in tokens_list)):
            for i, (seq, toks) in enumerate(zip(sequences, tokens_list)):
                for j in range(toks.shape[0]):
                    row = StructureTokenizer.add_bos_eos(
                        toks[j].astype(np.int32))
                    by_bucket.setdefault(bucket_length(len(row)), []).append(
                        (i, j, row, seq))
            for Lpad, rows in by_bucket.items():
                for s in range(0, len(rows), decode_batch):
                    chunk = rows[s:s + decode_batch]
                    B = min(decode_batch, _pow2_at_least(len(chunk)))
                    prots = _decode_padded_chunk(
                        self.runtime, [r[2] for r in chunk],
                        [r[3] for r in chunk], Lpad, B)
                    for (i, j, _, _), p in zip(chunk, prots):
                        results[i][j] = p
        return results


def _gibbs_sample(config: GenerationConfig):
    """The gibbs sampler as ``_unmask`` calls it."""
    def sample(fwd, uniforms, init, dmask):
        return iterative_unmask_sample(
            fwd, uniforms, init, dmask, num_steps=config.num_steps,
            temperature=config.temperature, top_p=config.top_p)
    return sample


def _pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (batch-dimension bucketing)."""
    return 1 << max(0, n - 1).bit_length()


def _decode_padded_chunk(runtime: ESM3Runtime, rows: list, seqs: list,
                         Lpad: int, decode_batch: int) -> list[ESMProtein]:
    """Decode <= ``decode_batch`` token rows at the fixed (decode_batch,
    Lpad) shape: each row pads to Lpad with STRUCTURE_PAD_TOKEN (masked out
    of decoder attention via ``lengths``), surplus rows repeat the last real
    row, and the output is trimmed back to the real row count.  Counts
    ``decode.rows_valid`` (n) and ``decode.rows_run`` (decode_batch)."""
    n = len(rows)
    tracing.count("decode.rows_valid", n)
    tracing.count("decode.rows_run", decode_batch)
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
