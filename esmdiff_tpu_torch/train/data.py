"""Training data pipeline: precomputed-encoding dataset + bucketed batching.

The port's own copy of ``esmdiff_tpu/train/data.py``.  The code is numpy
only, so for the same corpus and seed it yields the same batches, bit for
bit, as the JAX package's (``tests/test_torch_train.py``):

  - corpus = a directory of ``.npz`` encodings (one per chain) produced by
    ``cli/dump.py``;
  - per-item BOS/EOS strip, dtype fix, and random (optionally pinned)
    truncation to ``max_len``;
  - length-bucketed padded batches (every batch padded to a multiple of
    ``bucket_multiple``), or, with ``pack_len`` > 0, sequence-packed rows
    (first-fit-decreasing over a sliding window of the shuffled stream);
  - the loader yields the global batch as numpy arrays; the trainer moves
    it to the device.

Building one batch is a ``train.data`` span (``utils/tracing.py``),
closed before the batch is yielded; it counts ``train.tokens_real`` (the
batch's mask) and ``train.tokens_run`` (its rows x width).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.utils import tracing


@dataclasses.dataclass
class DataConfig:
    path: str = "data/encodings"
    max_len: int = 512               # crop length (configs/data/pdb.yaml:11)
    batch_size: int = 16             # global batch (mdlm.yaml:24)
    bucket_multiple: int = 64        # pad lengths up to a multiple of this
    train_val_split: float = 0.95    # (protein_datamodule.py:243-249)
    seed: int = 42
    cluster_rep_csv: Optional[str] = None
    with_embeddings: bool = False    # CLM/JLM need precomputed embeddings
    # Sequence-packed training (MDLM only; ops/packing.py rationale): >0
    # bin-packs ragged chains into ``batch_size`` rows of exactly this many
    # tokens (one static shape, near-zero pad waste) instead of bucketed
    # padding.  Opt-in: packing segment-masks attention (pads and other
    # chains excluded), whereas the reference's unpacked trainer attends
    # into padding (slm/models/model.py:476-483 passes no attention mask).
    pack_len: int = 0
    pack_max_segments: int = 0       # static per-row segment cap; 0 = auto


def resolve_pack_segments(cfg: DataConfig) -> int:
    """Static per-row segment-slot count S for packed batches (per-segment
    diffusion times are sampled into an (B, S) array)."""
    if cfg.pack_max_segments > 0:
        return cfg.pack_max_segments
    return max(1, cfg.pack_len // 8)


def random_truncate(rng: np.random.RandomState, arrays: dict, max_len: int,
                    pin_center: bool = False) -> dict:
    """Crop all per-residue arrays to max_len with a shared random offset
    (reference random_truncate, protein_datamodule.py:21-36)."""
    L = len(arrays["structure_tokens"])
    if L <= max_len:
        return arrays
    if pin_center:
        start = max(0, (L - max_len) // 2)
    else:
        start = rng.randint(0, L - max_len + 1)
    out = {}
    for k, v in arrays.items():
        if hasattr(v, "shape") and v.shape[:1] == (L,):
            out[k] = v[start:start + max_len]
        else:
            out[k] = v
    return out


class EncodingDataset:
    """Random access over a directory of .npz encodings."""

    def __init__(self, cfg: DataConfig, training: bool = True):
        self.cfg = cfg
        self.training = training
        root = Path(cfg.path)
        files = sorted(root.glob("*.npz"))
        if cfg.cluster_rep_csv:
            keep = set()
            import csv

            with open(cfg.cluster_rep_csv) as f:
                for row in csv.reader(f):
                    if row:
                        keep.add(row[0])
            files = [f for f in files if f.stem in keep]
        if not files:
            raise FileNotFoundError(f"no .npz encodings under {root}")
        self.files = files
        self._cache: dict[int, dict] = {}

    def __len__(self):
        return len(self.files)

    def load(self, idx: int, rng: np.random.RandomState) -> dict:
        if idx in self._cache:
            item = self._cache[idx]
        else:
            with np.load(self.files[idx], allow_pickle=False) as z:
                item = {k: z[k] for k in z.files}
            # strip BOS/EOS (reference protein_datamodule.py:99-112)
            for k in ("sequence_tokens", "structure_tokens", "embeddings"):
                if k in item and item[k].shape[0] >= 2:
                    item[k] = item[k][1:-1]
            item["sequence_tokens"] = item["sequence_tokens"].astype(np.int32)
            item["structure_tokens"] = item["structure_tokens"].astype(np.int32)
            if len(self._cache) < 100:  # lru-ish cache (reference :89)
                self._cache[idx] = item
        keys = ["sequence_tokens", "structure_tokens"]
        if self.cfg.with_embeddings and "embeddings" in item:
            keys.append("embeddings")
        out = {k: item[k] for k in keys if k in item}
        return random_truncate(rng, out, self.cfg.max_len,
                               pin_center=not self.training)


def pad_collate(items: Sequence[dict], bucket_multiple: int) -> dict:
    """Pad to a shared bucket length with track-aware pad values
    (reference BatchTensorConverter, protein_datamodule.py:115-172)."""
    max_l = max(len(it["structure_tokens"]) for it in items)
    Lpad = ((max_l + bucket_multiple - 1) // bucket_multiple) * bucket_multiple
    B = len(items)
    batch = {
        "sequence_tokens": np.full((B, Lpad), C.SEQUENCE_PAD_TOKEN, np.int32),
        "structure_tokens": np.full((B, Lpad), C.STRUCTURE_PAD_TOKEN, np.int32),
        "mask": np.zeros((B, Lpad), np.float32),
    }
    has_emb = all("embeddings" in it for it in items)
    if has_emb:
        D = items[0]["embeddings"].shape[-1]
        batch["embeddings"] = np.zeros((B, Lpad, D), np.float32)
    for i, it in enumerate(items):
        L = len(it["structure_tokens"])
        batch["sequence_tokens"][i, :L] = it["sequence_tokens"]
        batch["structure_tokens"][i, :L] = it["structure_tokens"]
        batch["mask"][i, :L] = 1.0
        if has_emb:
            batch["embeddings"][i, :L] = it["embeddings"]
    return batch


def _counted(batch: dict) -> dict:
    """``batch``, its real and run tokens counted."""
    mask = batch["mask"]
    tracing.count("train.tokens_real", int(mask.sum()))
    tracing.count("train.tokens_run", mask.size)
    return batch


def pack_collate(rows: Sequence[Sequence[dict]], pack_len: int) -> dict:
    """Materialize pre-assigned rows of items into one packed batch.

    rows: list of B lists of items; each row's total length must be
    <= pack_len.  Emits the same token tracks as :func:`pad_collate` plus
    the packing metadata the segment-masked trunk path consumes
    (ops/packing.py semantics: valid tokens of segment s carry id s,
    padding carries -1; rotary positions restart per segment).
    """
    B = len(rows)
    batch = {
        "sequence_tokens": np.full((B, pack_len), C.SEQUENCE_PAD_TOKEN,
                                   np.int32),
        "structure_tokens": np.full((B, pack_len), C.STRUCTURE_PAD_TOKEN,
                                    np.int32),
        "mask": np.zeros((B, pack_len), np.float32),
        "segment_ids": np.full((B, pack_len), -1, np.int32),
        "positions": np.zeros((B, pack_len), np.int32),
    }
    for i, row in enumerate(rows):
        off = 0
        for s, it in enumerate(row):
            L = min(len(it["structure_tokens"]), pack_len - off)
            sl = slice(off, off + L)
            batch["sequence_tokens"][i, sl] = it["sequence_tokens"][:L]
            batch["structure_tokens"][i, sl] = it["structure_tokens"][:L]
            batch["mask"][i, sl] = 1.0
            batch["segment_ids"][i, sl] = s
            batch["positions"][i, sl] = np.arange(L)
            off += L
    return batch


def packed_batches(split: Split, cfg: DataConfig, shuffle: bool,
                   seed: int) -> Iterator[dict]:
    """Yield packed (batch_size, pack_len) batches via first-fit-decreasing
    over a sliding window of the (shuffled) item stream.

    Every item appears exactly once per epoch; the final batch may carry
    underfull (or empty) rows — shapes stay static so there is still only
    one shape.  Items longer than pack_len are truncated (the dataset
    already crops to max_len; set pack_len >= max_len to avoid this).
    """
    rng = np.random.RandomState(seed)
    idx = split.indices.copy()
    if shuffle:
        rng.shuffle(idx)
    P, B = cfg.pack_len, cfg.batch_size
    S = resolve_pack_segments(cfg)
    stream = iter(idx)
    buf: list[dict] = []
    window = 8 * B
    exhausted = False
    while True:
        with tracing.span("train.data"):
            while not exhausted and len(buf) < window:
                try:
                    buf.append(split.dataset.load(int(next(stream)), rng))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            # first-fit-decreasing into B rows
            order = sorted(range(len(buf)),
                           key=lambda j: -len(buf[j]["structure_tokens"]))
            rows: list[list[dict]] = [[] for _ in range(B)]
            space = [P] * B
            placed = set()
            for j in order:
                L = min(len(buf[j]["structure_tokens"]), P)
                for r in range(B):
                    if space[r] >= L and len(rows[r]) < S:
                        rows[r].append(buf[j])
                        space[r] -= L
                        placed.add(j)
                        break
            buf = [it for j, it in enumerate(buf) if j not in placed]
            batch = _counted(pack_collate(rows, P))
        yield batch


@dataclasses.dataclass
class Split:
    dataset: EncodingDataset
    indices: np.ndarray


def train_val_split(dataset: EncodingDataset, cfg: DataConfig):
    """Seeded random split (reference protein_datamodule.py:243-249)."""
    rng = np.random.RandomState(cfg.seed)
    perm = rng.permutation(len(dataset))
    n_train = max(1, int(round(len(dataset) * cfg.train_val_split)))
    if n_train == len(dataset) and len(dataset) > 1:
        n_train -= 1
    return Split(dataset, perm[:n_train]), Split(dataset, perm[n_train:])


def batches(split: Split, cfg: DataConfig, shuffle: bool, seed: int,
            drop_last: bool = True) -> Iterator[dict]:
    """Yield padded global batches (shuffled fixed-size chunks).  Each batch
    pads to the next ``bucket_multiple`` boundary, so the number of distinct
    batch shapes is bounded by max_len / bucket_multiple regardless of the
    corpus's length distribution.

    With ``cfg.pack_len > 0`` batches are sequence-packed instead (see
    :func:`packed_batches`)."""
    if cfg.pack_len > 0:
        yield from packed_batches(split, cfg, shuffle, seed)
        return
    rng = np.random.RandomState(seed)
    idx = split.indices.copy()
    if shuffle:
        rng.shuffle(idx)
    bs = cfg.batch_size
    n = len(idx)
    if n == 0:
        return
    for s in range(0, n, bs):
        chunk = idx[s:s + bs]
        if len(chunk) < bs:
            if drop_last and n >= bs:
                continue
            # pad the batch by repeating items so shapes stay static
            chunk = np.concatenate(
                [chunk, chunk[np.zeros(bs - len(chunk), dtype=int)]])
        with tracing.span("train.data"):
            items = [split.dataset.load(int(i), rng) for i in chunk]
            batch = _counted(pad_collate(items, cfg.bucket_multiple))
        yield batch
