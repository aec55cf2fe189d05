"""Sequence alignment and NaN-masked coordinate mapping for the apo suite
(port of ``esmdiff_tpu/eval/align.py``).

Each parsed chain's sequence is globally aligned to the target's reference
sequence and its CA coordinates are scattered into a reference-length frame
with NaN at gaps, so per-residue deviations stay on register across
internal gaps and numbering offsets.  The alignment is string work and
stays on the host in numpy (own copies of ``nw_align`` and
``map_to_reference``); the rigid fits run in torch, batched:
``pair_deviations`` fits every (j, k) pair of an ensemble at once.

Scoring mirrors Biopython's ``globalxx``: match 1, mismatch 0, gap 0, so the
alignment maximises the matched positions (an LCS), as numpy row sweeps.
"""

from __future__ import annotations

import numpy as np
import torch

from .geo import _rotation, masked_kabsch

# pairs a block in pair_deviations: bounds the (pairs, L, 3) copies
_PAIR_ELEMENTS = 1 << 24


def nw_align(a: str, b: str) -> tuple[str, str]:
    """Global alignment of ``a`` vs ``b`` with globalxx scoring.

    Returns the two gapped strings (same length, '-' = gap).  Tie-breaking
    prefers diagonal (match/mismatch) moves, then consuming ``a``.
    """
    la, lb = len(a), len(b)
    if la == 0:
        return "-" * lb, b
    if lb == 0:
        return a, "-" * la
    aa = np.frombuffer(a.encode("latin1"), dtype=np.uint8)
    bb = np.frombuffer(b.encode("latin1"), dtype=np.uint8)
    match = (aa[:, None] == bb[None, :]).astype(np.int32)

    H = np.zeros((la + 1, lb + 1), dtype=np.int32)
    for i in range(1, la + 1):
        # H[i, j] = max(H[i-1, j-1] + m, H[i-1, j], H[i, j-1]); with zero gap
        # penalties the j-recurrence collapses to a prefix maximum
        tmp = np.maximum(H[i - 1, :-1] + match[i - 1], H[i - 1, 1:])
        H[i, 1:] = np.maximum.accumulate(tmp)

    # traceback (prefer diag > up > left)
    out_a, out_b = [], []
    i, j = la, lb
    while i > 0 and j > 0:
        if H[i, j] == H[i - 1, j - 1] + match[i - 1, j - 1]:
            out_a.append(a[i - 1])
            out_b.append(b[j - 1])
            i -= 1
            j -= 1
        elif H[i, j] == H[i - 1, j]:
            out_a.append(a[i - 1])
            out_b.append("-")
            i -= 1
        else:
            out_a.append("-")
            out_b.append(b[j - 1])
            j -= 1
    while i > 0:
        out_a.append(a[i - 1])
        out_b.append("-")
        i -= 1
    while j > 0:
        out_a.append("-")
        out_b.append(b[j - 1])
        j -= 1
    return "".join(reversed(out_a)), "".join(reversed(out_b))


def map_to_reference(ref_seq: str, obs_seq: str,
                     coords: np.ndarray) -> np.ndarray:
    """Scatter per-residue ``coords`` (len(obs_seq), ...) into a
    reference-frame array (len(ref_seq), ...) via global alignment;
    positions with no observed counterpart are NaN."""
    coords = np.asarray(coords, dtype=np.float64)
    assert coords.shape[0] == len(obs_seq), (coords.shape, len(obs_seq))
    out = np.full((len(ref_seq),) + coords.shape[1:], np.nan)
    if obs_seq == ref_seq:
        out[:] = coords
        return out
    ga, gb = nw_align(ref_seq, obs_seq)
    i = j = 0
    for c, d in zip(ga, gb):
        if c != "-" and d != "-":
            out[i] = coords[j]
        if c != "-":
            i += 1
        if d != "-":
            j += 1
    return out


def kabsch_rotation(P, Q):
    """Rotation R minimising ||P @ R^T - Q|| for centred point sets
    (..., N, 3)."""
    return _rotation(P.transpose(-1, -2) @ Q)


def nan_pair_deviation(s1, s2):
    """Per-residue deviation of NaN-masked reference-frame CA sets
    (..., L, 3) after a rigid fit of s2 onto s1 on their mutual finite mask,
    each pair on its own mask; NaN where either side is unresolved.  A pair
    with fewer than 3 mutual residues is compared as it stands (no fit).

    The translation is fit on the mutual mask, so identical structures with
    different unresolved stretches measure exactly zero deviation."""
    s1, s2 = torch.broadcast_tensors(s1, s2)
    m = torch.isfinite(s1).all(dim=-1) & torch.isfinite(s2).all(dim=-1)
    R, t = masked_kabsch(s2, s1, m)
    fit = (m.sum(dim=-1) >= 3)[..., None, None]
    s2 = torch.where(fit, s2 @ R.transpose(-1, -2) + t[..., None, :], s2)
    return torch.sqrt(torch.sum((s1 - s2) ** 2, dim=-1))


def pair_deviations(ens):
    """``nan_pair_deviation`` of every pair (j, k), j < k, of an (M, L, 3)
    ensemble, in the order of the loops ``for j: for k > j`` -> (pairs, L);
    pairs in blocks that bound the copies' memory."""
    M, L, _ = ens.shape
    j, k = torch.triu_indices(M, M, offset=1, device=ens.device)
    block = max(1, _PAIR_ELEMENTS // max(1, L * 3))
    return torch.cat([nan_pair_deviation(ens[j[i:i + block]],
                                         ens[k[i:i + block]])
                      for i in range(0, len(j), block)]
                     or [ens.new_zeros(0, L)], dim=0)
