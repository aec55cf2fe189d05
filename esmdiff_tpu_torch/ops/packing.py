"""Sequence packing for short-chain sampling (port of
``esmdiff_tpu/ops/packing.py``).

``k`` same-bucket rows share one device row of length ``k*L`` under a
block-diagonal segment mask, with rotary positions restarting per segment
(``positions``), so every token attends the same keys as in its unpacked
row: the packed forward computes the same function.  Samplers keep their
state at (B, L) and reshape only around the trunk call.  A packed row's
mask is a ``sequence_id`` mask, so its attention takes the plain path
(``nn.attention``), as JAX sends masks to XLA.

``PACK_TARGET_LEN`` keeps the JAX package's value so that pack factors
match JAX's: it was chosen on a TPU v5e and is not measured on this card.
"""

from __future__ import annotations

import torch

PACK_TARGET_LEN = 128


def pack_factor(B: int, L: int, target: int = PACK_TARGET_LEN,
                max_pack: int = 16) -> int:
    """Largest power-of-two k dividing B with k*L <= target."""
    k = 1
    while k < max_pack and B % (2 * k) == 0 and 2 * k * L <= target:
        k *= 2
    return k


def plan_segment_rows(seg_lengths, T: int) -> list[list[int]]:
    """First-fit-decreasing packing of variable-length segments into rows
    of width T: rows as lists of segment INDICES, laid out back to back in
    the returned order.  Ties between equal lengths keep ascending index
    order, so a request mix always gets the same layout."""
    order = sorted(range(len(seg_lengths)),
                   key=lambda i: (-int(seg_lengths[i]), i))
    rows: list[list[int]] = []
    room: list[int] = []
    for i in order:
        ln = int(seg_lengths[i])
        if ln > T:
            raise ValueError(f"segment {i} length {ln} exceeds row width {T}")
        for r, free in enumerate(room):
            if free >= ln:
                rows[r].append(i)
                room[r] -= ln
                break
        else:
            rows.append([i])
            room.append(T - ln)
    return rows


def packed_positions(L: int, k: int, device=None):
    """(k*L,) int64 rotary positions restarting at each segment."""
    return torch.arange(L, device=device).repeat(k)


def packed_segment_ids(lengths, L: int, k: int, device=None):
    """(B, L)-batch prefix lengths -> (B//k, k*L) int64 segment ids.

    Valid tokens of packed segment s carry id s; padding carries -1 (a
    shared id, so pads attend only pads).  lengths: (B,) ints or None
    (every position valid: a (1, k*L) row that broadcasts); the ids lie on
    ``device``, by default the device of ``lengths``."""
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=device)
        device = lengths.device
    seg = torch.arange(k, device=device).repeat_interleave(L)       # (k*L,)
    if lengths is None:
        return seg[None, :]
    pos_in_seg = torch.arange(L, device=device).repeat(k)           # (k*L,)
    lens_p = lengths.reshape(-1, k)                                 # (B', k)
    valid = pos_in_seg[None, :] < lens_p[:, seg]                    # (B', k*L)
    return torch.where(valid, seg[None, :], -1)
