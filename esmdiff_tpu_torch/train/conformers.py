"""Synthetic conformers: elastic-network decoys for tokenizer training.

Port of ``esmdiff_tpu/train/conformers.py``.  A corpus of a few hundred
single-frame chains is small for training the VQ-VAE tokenizer; this
module expands it with physically plausible decoys of the TRAIN chains
only (a holdout stays untouched):

  1. an anisotropic network model (ANM) on the CA trace: a Hessian from
     contact topology (unit springs within ``cutoff``), whose low-frequency
     normal modes are the classic basis of collective motion;
  2. decoys displace along random low-mode combinations, scaled to a
     target CA displacement RMS (drawn per decoy), applied rigidly per
     residue (N/CA/C move with their CA);
  3. a bond-band projection (``ops/refine.py``, on ``device``) repairs the
     slight CA-CA bond stretch that a linear displacement introduces.

Host numpy apart from the projection (eigh of a 3N x 3N Hessian), run
once before training.
"""

from __future__ import annotations

import numpy as np

from esmdiff_tpu_torch.ops.refine import refine_backbone_ensemble


def anm_modes(ca: np.ndarray, n_modes: int = 20, cutoff: float = 15.0):
    """Low-frequency ANM normal modes of a CA trace.

    ca: (N, 3) finite coordinates.  Returns (modes (n_modes, N, 3),
    eigenvalues (n_modes,)) — the lowest non-rigid modes (6 zero modes of
    the connected network are skipped by eigenvalue threshold).
    """
    ca = np.asarray(ca, np.float64)
    N = len(ca)
    diff = ca[:, None, :] - ca[None, :, :]            # (N, N, 3)
    dist = np.linalg.norm(diff, axis=-1)
    contact = (dist < cutoff) & (dist > 1e-6)
    H = np.zeros((N, 3, N, 3))
    with np.errstate(invalid="ignore", divide="ignore"):
        e = diff / dist[..., None]                    # unit bond vectors
    blocks = np.einsum("ija,ijb->ijab", e, e)         # (N, N, 3, 3)
    blocks = np.where(contact[..., None, None], blocks, 0.0)
    H -= blocks.transpose(0, 2, 1, 3)                 # off-diagonal -outer
    H[np.arange(N), :, np.arange(N), :] += blocks.sum(axis=1)
    H = H.reshape(3 * N, 3 * N)
    w, v = np.linalg.eigh(H)
    nonrigid = w > max(1e-8, w[-1] * 1e-10)
    w, v = w[nonrigid], v[:, nonrigid]
    k = min(n_modes, v.shape[1])
    return v[:, :k].T.reshape(k, N, 3), w[:k]


def enm_conformers(bb: np.ndarray, n_conf: int, *,
                   rs: np.random.RandomState,
                   n_modes: int = 20, cutoff: float = 15.0,
                   amp_range: tuple = (0.8, 3.0),
                   refine: bool = True, device=None) -> np.ndarray:
    """(L, 3, 3) N/CA/C backbone -> (n_conf, L, 3, 3) decoy conformers.

    Each decoy displaces residues along a random low-mode combination with
    per-mode weights ~ N(0, 1)/sqrt(lambda) (softer modes move more — the
    thermal-ensemble weighting), rescaled to a uniform random CA
    displacement RMS in ``amp_range`` Angstroms, then bond-band-projected
    (refine=True, on ``device``) so adjacent CA-CA distances stay physical.
    Missing residues (NaN) stay NaN and do not move their neighbors.
    """
    bb = np.asarray(bb, np.float32)
    L = bb.shape[0]
    valid = np.isfinite(bb).all(axis=(-1, -2))        # (L,)
    idx = np.where(valid)[0]
    if len(idx) < 8:
        return np.repeat(bb[None], n_conf, axis=0)
    ca = bb[idx, 1]
    modes, lam = anm_modes(ca, n_modes=n_modes, cutoff=cutoff)
    if len(lam) == 0:
        return np.repeat(bb[None], n_conf, axis=0)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(lam, 1e-8))

    out = np.empty((n_conf, L, 3, 3), np.float32)
    for c in range(n_conf):
        w = rs.randn(len(lam)) * inv_sqrt
        disp = np.einsum("m,mna->na", w, modes)        # (Nv, 3)
        rms = np.sqrt((disp ** 2).sum(-1).mean()) + 1e-9
        amp = rs.uniform(*amp_range)
        disp = disp * (amp / rms)
        conf = bb.copy()
        conf[idx] += disp[:, None, :].astype(np.float32)  # rigid per residue
        out[c] = conf
    if refine:
        # bonds only need a light projection (displacements are smooth);
        # clash push stays on to avoid teaching the decoder overlaps
        out = refine_backbone_ensemble(out, iters=40, device=device)
    return out


def synthesize_corpus(backbones: np.ndarray, lengths: np.ndarray,
                      train_idx: np.ndarray, per_chain: int, *,
                      seed: int = 0, log=print, device=None):
    """Expand a coordinate corpus with ENM decoys of the TRAIN chains only.

    backbones: (N, Lp, 3, 3) NaN-padded; lengths: (N,).  Returns
    (backbones', lengths', origin_idx') where the first N entries are the
    originals and decoys follow — origin_idx maps every row to its source
    chain so downstream splits stay contamination-free.  ``device``: where
    the bond-band projection runs.
    """
    rs = np.random.RandomState(seed)
    extra_bb, extra_len, origin = [], [], list(range(len(lengths)))
    for i in np.asarray(train_idx):
        L = int(lengths[i])
        decoys = enm_conformers(backbones[i, :L], per_chain, rs=rs,
                                device=device)
        pad = np.full((per_chain, backbones.shape[1], 3, 3), np.nan,
                      np.float32)
        pad[:, :L] = decoys
        extra_bb.append(pad)
        extra_len.extend([L] * per_chain)
        origin.extend([int(i)] * per_chain)
    if not extra_bb:
        return backbones, lengths, np.asarray(origin)
    bb = np.concatenate([backbones] + extra_bb)
    lens = np.concatenate([lengths, np.asarray(extra_len, lengths.dtype)])
    if log:
        log(f"[conformers] +{len(extra_len)} ENM decoys "
            f"({per_chain}/chain x {len(train_idx)} train chains) "
            f"-> corpus {len(lens)}")
    return bb, lens, np.asarray(origin)
