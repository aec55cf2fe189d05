"""Post-decode geometry projection (port of ``esmdiff_tpu/ops/refine.py``).

Decoded CA traces are projected onto the validity-feasible set: every
adjacent CA-CA distance inside [bond_lo, bond_hi] and no non-bonded pair
(|i - j| >= min_sep) closer than ``clash_min``.  Each iteration applies a
damped Jacobi clash push (all pair corrections of the iteration summed,
an (M, L, L, 3) field), then an exact sequential bond projection down the
chain that re-places each residue at a clamped distance from its already
projected predecessor; the bond projection also runs first and last, so
the returned trace is exactly in band.  Plain tensor ops on the given
device; JAX's ``fori_loop`` and ``lax.scan`` are Python loops here.
"""

from __future__ import annotations

import numpy as np
import torch

from esmdiff_tpu_torch.device import resolve_device

# the JAX package's feasible band: trans-peptide CA-CA at 3.73-4.01 A, the
# clash bar 3.0 A with a margin
BOND_LO = 3.76
BOND_HI = 3.92
CLASH_MIN = 3.10
MIN_SEP = 2          # |i-j| >= 2 pairs are "non-bonded" for the clash push


def _norm(d):
    """Euclidean norm over the last axis as sqrt(sum(d * d))."""
    return torch.sqrt((d * d).sum(dim=-1))


def _bond_scan(x, valid, bond_lo: float, bond_hi: float):
    """Sequential bond projection of (M, L, 3) traces: each residue is
    re-placed at a clamped distance from its projected predecessor, across
    consecutive VALID residues only (a chain break leaves it in place)."""
    prev, prev_valid = x[:, 0], valid[:, 0]
    out = [prev]
    for i in range(1, x.shape[1]):
        xi, vi = x[:, i], valid[:, i]
        d = xi - prev
        dist = _norm(d) + 1e-8
        cand = prev + d / dist[:, None] * dist.clamp(bond_lo, bond_hi)[:, None]
        new = torch.where((prev_valid & vi)[:, None], cand, xi)
        out.append(new)
        prev = torch.where(vi[:, None], new, prev)
        prev_valid = vi
    return torch.stack(out, dim=1)


@torch.no_grad()
def _refine_batch(ca, valid, *, iters: int, bond_lo: float, bond_hi: float,
                  clash_min: float, min_sep: int, damping: float):
    """(M, L, 3) float32 CA traces + (M, L) validity -> projected traces."""
    L = ca.shape[1]
    idx = torch.arange(L, device=ca.device)
    pair_ok = (idx[:, None] - idx[None, :]).abs() >= min_sep
    pair_ok = pair_ok[None] & valid[:, :, None] & valid[:, None, :]
    x = _bond_scan(ca, valid, bond_lo, bond_hi)
    for _ in range(iters):
        diff = x[:, :, None, :] - x[:, None, :, :]               # (M, L, L, 3)
        pd = _norm(diff) + 1e-8
        viol = torch.where(pair_ok & (pd < clash_min),
                           (clash_min - pd) / pd * 0.5, 0.0)
        dx = (diff * viol[..., None]).sum(dim=2)
        x = x + damping * dx * valid[..., None]
        x = _bond_scan(x, valid, bond_lo, bond_hi)
    return x


def refine_ca_ensemble(ca: np.ndarray, *, iters: int = 120,
                       bond_lo: float = BOND_LO, bond_hi: float = BOND_HI,
                       clash_min: float = CLASH_MIN, min_sep: int = MIN_SEP,
                       damping: float = 0.55, device=None) -> np.ndarray:
    """Project an (M, L, 3) CA ensemble (or one (L, 3) trace) onto the
    validity-feasible set, on ``device`` (default: the card).

    NaN rows (missing residues) are held fixed and returned as NaN.
    Returns a new float32 (M, L, 3) array; the input is untouched."""
    ca = np.asarray(ca, np.float32)
    if ca.ndim == 2:
        ca = ca[None]
    valid = np.isfinite(ca).all(-1)                       # (M, L)
    dev = resolve_device(device)
    out = _refine_batch(
        torch.as_tensor(np.nan_to_num(ca, nan=0.0), device=dev),
        torch.as_tensor(valid, device=dev), iters=iters,
        bond_lo=float(bond_lo), bond_hi=float(bond_hi),
        clash_min=float(clash_min), min_sep=int(min_sep),
        damping=float(damping)).cpu().numpy()
    out[~valid] = np.nan
    return out


def refine_backbone_ensemble(bb: np.ndarray, **kw) -> np.ndarray:
    """(M, L, 3, 3) N/CA/C backbones (or one (L, 3, 3)): refine the CA
    trace, then translate each residue's N and C rigidly by its CA
    displacement."""
    bb = np.asarray(bb, np.float32)
    squeeze = bb.ndim == 3
    if squeeze:
        bb = bb[None]
    ca = bb[:, :, 1]
    shift = np.nan_to_num(refine_ca_ensemble(ca, **kw) - ca, nan=0.0)
    out = bb + shift[:, :, None, :]
    return out[0] if squeeze else out
