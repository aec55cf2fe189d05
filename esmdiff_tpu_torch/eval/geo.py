"""Rigid alignment and RMSD, batched over leading axes (port of
``esmdiff_tpu/eval/geo.py``, which maps single-pair functions with
``vmap``).  Every function takes (..., N, 3) tensors and broadcasts their
leading axes, so a batch of pairs is one call: no Python loop over pairs.
``masked_kabsch`` fits each pair on its own subset of residues (the apo
suite's mutual finite mask).
"""

from __future__ import annotations

import torch

# pairs a block in pairwise_rmsd_matrix: bounds the (rows, M, N, 3) copies
_PAIR_ELEMENTS = 1 << 24


def _rotation(H):
    """R = V diag(1, 1, sign det(V U^T)) U^T from H = U S V^T (..., 3, 3):
    the proper rotation that maximises tr(R H)."""
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    D = torch.ones(d.shape + (3,), dtype=H.dtype, device=H.device)
    D[..., 2] = d
    return (V * D[..., None, :]) @ Ut


def kabsch(P, Q):
    """Optimal rotation and translation aligning P onto Q, (..., N, 3) each:
    R (..., 3, 3), t (..., 3) with ``P @ R^T + t ~= Q``."""
    P, Q = torch.broadcast_tensors(P, Q)
    cp = P.mean(dim=-2)
    cq = Q.mean(dim=-2)
    R = _rotation((P - cp[..., None, :]).transpose(-1, -2)
                  @ (Q - cq[..., None, :]))
    return R, cq - (R @ cp[..., None])[..., 0]


def masked_kabsch(P, Q, mask):
    """``kabsch`` fitted on the residues where ``mask`` (..., N) is true,
    each batch entry on its own mask; values off the mask (NaN included)
    take no part.  A pair with fewer than 3 residues gets a rotation that
    is not meaningful: the caller decides what to do with it."""
    m = mask[..., None]
    n = mask.sum(dim=-1, keepdim=True).clamp_min(1).to(P.dtype)
    P0 = torch.where(m, P, 0.0)
    Q0 = torch.where(m, Q, 0.0)
    cp = P0.sum(dim=-2) / n
    cq = Q0.sum(dim=-2) / n
    Pc = torch.where(m, P0 - cp[..., None, :], 0.0)
    Qc = torch.where(m, Q0 - cq[..., None, :], 0.0)
    R = _rotation(Pc.transpose(-1, -2) @ Qc)
    return R, cq - (R @ cp[..., None])[..., 0]


def align(P, Q):
    """P aligned onto Q."""
    R, t = kabsch(P, Q)
    return P @ R.transpose(-1, -2) + t[..., None, :]


def rmsd(P, Q, align_first: bool = True):
    """Root-mean-square deviation of (..., N, 3) point sets."""
    if align_first:
        P = align(P, Q)
    return torch.sqrt(torch.mean(torch.sum((P - Q) ** 2, dim=-1), dim=-1))


def align_batched(X, Q):
    """(B, N, 3) each aligned onto one (N, 3)."""
    return align(X, Q.expand_as(X))


def rmsd_batched(X, Q):
    """(B, N, 3) against one (N, 3) -> (B,)."""
    return rmsd(X, Q.expand_as(X))


def rmsd_pairwise_batched(X, Y):
    """(B, N, 3) against (B, N, 3), row by row -> (B,)."""
    return rmsd(X, Y)


def pairwise_rmsd_matrix(X):
    """(M, N, 3) ensemble -> (M, M) aligned RMSD, entry (i, j) = X[i]
    aligned onto X[j]; rows in blocks that bound the copies' memory."""
    M, N, _ = X.shape
    rows = max(1, _PAIR_ELEMENTS // max(1, M * N * 3))
    out = []
    for i in range(0, M, rows):
        P = X[i:i + rows, None].expand(-1, M, N, 3)
        out.append(rmsd(P, X[None].expand_as(P)))
    return torch.cat(out, dim=0)


def radius_of_gyration(X):
    """(..., N, 3) -> (...,) Rg."""
    center = X.mean(dim=-2, keepdim=True)
    return torch.sqrt(torch.mean(torch.sum((X - center) ** 2, dim=-1),
                                 dim=-1))


def pairwise_distances(X):
    """(..., N, 3) -> (..., N*(N-1)/2) condensed pairwise CA distances."""
    N = X.shape[-2]
    d = torch.sqrt(torch.sum((X[..., :, None, :] - X[..., None, :, :]) ** 2,
                             dim=-1) + 1e-12)
    iu = torch.triu_indices(N, N, offset=1, device=X.device)
    return d[..., iu[0], iu[1]]


def rmsf(X):
    """(M, N, 3) aligned ensemble -> (N,) per-residue fluctuation."""
    mean = X.mean(dim=0, keepdim=True)
    return torch.sqrt(torch.mean(torch.sum((X - mean) ** 2, dim=-1), dim=0))
