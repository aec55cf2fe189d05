"""Secondary-structure assignment (Kabsch-Sander H-bonds), on a torch device.

Port of ``esmdiff_tpu/core/secondary_structure.py``, the dependency-free
stand-in for the reference's mdtraj DSSP (scripts/preprocess.py::
compute_dssp_feats), from backbone atoms (N, CA, C, O):

  - amide H placed 1.01 A from N along the bisector of the C(i-1)->N and
    O(i-1)->N directions;
  - Kabsch-Sander electrostatic H-bond energy
      E = 0.084 * 332 * (1/d_ON + 1/d_CH - 1/d_OH - 1/d_CN)  [kcal/mol]
    with a bond when E < -0.5 (|i - j| > 1, no proline donor);
  - 3-state assignment: H (two consecutive i->i+4 turns mark i..i+3),
    E (a parallel or antiparallel bridge, never over an H), C otherwise.

The O(L^2) energy matrix and the helix and bridge patterns are float64
torch ops on the resolved device (as ``eval/geo.py``), batched over chains
padded to a common length, where the JAX package runs numpy and a Python
double loop over residue pairs; the strings are the same (E never
overwrites H and marking E twice is a no-op, so the loop's order does not
matter).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from esmdiff_tpu_torch.device import resolve_device

from . import residue_constants as rc

HBOND_ENERGY_CUTOFF = -0.5  # kcal/mol
_Q1Q2_F = 0.084 * 332.0
# padded (B, L, L) float64 elements a batch holds at most
BATCH_ELEMENTS = 1 << 24


def _backbone(prots: Sequence, device) -> dict:
    """N, C, O (B, Lmax, 3) float64 and their masks (B, Lmax) bool, the
    proline flags and the lengths, zero-padded."""
    B = len(prots)
    Lmax = max(len(p.aatype) for p in prots)
    n_i, _, c_i = rc.BACKBONE_ATOM_INDICES
    pos = np.zeros((B, Lmax, 3, 3), np.float64)
    ok = np.zeros((B, Lmax, 3), bool)
    pro = np.zeros((B, Lmax), bool)
    for b, p in enumerate(prots):
        L = len(p.aatype)
        idx = [n_i, c_i, rc.OXYGEN_INDEX]
        pos[b, :L] = p.atom_positions[:, idx].astype(np.float64)
        ok[b, :L] = p.atom_mask[:, idx] > 0.5
        pro[b, :L] = p.aatype == rc.restype_order.get("P", -1)
    pos = torch.from_numpy(pos).to(device)
    ok = torch.from_numpy(ok).to(device)
    return {"n": pos[:, :, 0], "c": pos[:, :, 1], "o": pos[:, :, 2],
            "n_ok": ok[:, :, 0], "c_ok": ok[:, :, 1], "o_ok": ok[:, :, 2],
            "pro": torch.from_numpy(pro).to(device),
            "lengths": torch.tensor([len(p.aatype) for p in prots],
                                    device=device)}


def _unit(d):
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(
        1e-8)


def _amide_h(n, c, o, n_ok, co_ok):
    """H_i = N_i + 1.01 * unit(unit(N_i - C_{i-1}) + unit(N_i - O_{i-1}));
    NaN and not ok at i = 0."""
    h = torch.full_like(n, float("nan"))
    h_ok = torch.zeros_like(n_ok)
    if n.shape[1] >= 2:
        b = _unit(_unit(n[:, 1:] - c[:, :-1]) + _unit(n[:, 1:] - o[:, :-1]))
        h[:, 1:] = n[:, 1:] + 1.01 * b
        h_ok[:, 1:] = n_ok[:, 1:] & co_ok[:, :-1]
    return h, h_ok


def _energy(bb: dict):
    """(energy (B, L, L) float64 [donor i, acceptor j], the pairs it
    counts (B, L, L) bool)."""
    n, c, o = bb["n"], bb["c"], bb["o"]
    co_ok = bb["c_ok"] & bb["o_ok"]
    h, h_ok = _amide_h(n, c, o, bb["n_ok"], co_ok)

    def dist(a, b):
        # NaN (a missing H) stays NaN, as np.maximum keeps it
        return torch.maximum(
            torch.linalg.vector_norm(a[:, :, None] - b[:, None], dim=-1),
            torch.tensor(1e-3, dtype=a.dtype, device=a.device))

    e = _Q1Q2_F * (1.0 / dist(n, o) + 1.0 / dist(h, c)
                   - 1.0 / dist(h, o) - 1.0 / dist(n, c))
    L = n.shape[1]
    idx = torch.arange(L, device=n.device)
    near = (idx[:, None] - idx[None, :]).abs() <= 1
    valid = (h_ok[:, :, None] & co_ok[:, None, :] & ~near[None]
             & ~bb["pro"][:, :, None])
    return e, valid


def _hbonds(bb: dict):
    e, valid = _energy(bb)
    return (e < HBOND_ENERGY_CUTOFF) & valid


def _assign(bb: dict) -> torch.Tensor:
    """(B, L) int8 codes, 0 C, 1 E, 2 H, from the batch's H-bonds."""
    hb = _hbonds(bb)                                 # [donor, acceptor]
    B, L = hb.shape[:2]
    lengths = bb["lengths"]
    dev = hb.device
    pos = torch.arange(L, device=dev)
    # 4-turn at i: the CO of i accepts from the NH of i + 4 (padding rows
    # hold no bond, so i + 4 >= length never turns)
    t4 = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if L > 4:
        t4[:, :L - 4] = torch.diagonal(hb, offset=-4, dim1=1, dim2=2)
    start = torch.zeros_like(t4)
    start[:, 1:] = t4[:, :-1] & t4[:, 1:]
    start &= (pos[None] >= 1) & (pos[None] < lengths[:, None] - 4)
    helix = start.clone()
    for s in (1, 2, 3):
        helix[:, s:] |= start[:, :-s]
    strand = torch.zeros_like(t4)
    if L >= 3:
        hbt = hb.transpose(1, 2)                     # hbt[x, y] = hb[y, x]
        mid, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        # [i - 1, j - 1] over interior i, j (1 .. L-2)
        parallel = ((hb[:, mid, lo] & hbt[:, mid, hi])       # i,j-1 j+1,i
                    | (hbt[:, lo, mid] & hb[:, hi, mid]))    # j,i-1 i+1,j
        anti = ((hb[:, mid, mid] & hbt[:, mid, mid])         # i,j   j,i
                | (hb[:, hi, lo] & hbt[:, lo, hi]))          # i+1,j-1 j+1,i-1
        inner = pos[1:-1]
        ok = ((inner[None, :] - inner[:, None]) >= 3)[None] \
            & (inner[None, :, None] <= lengths[:, None, None] - 2) \
            & (inner[None, None, :] <= lengths[:, None, None] - 2)
        bridge = (parallel | anti) & ok
        strand[:, 1:-1] = bridge.any(dim=2) | bridge.any(dim=1)
    return torch.where(helix, 2, torch.where(strand, 1, 0)).to(torch.int8)


def _batches(prots: Sequence):
    """Index groups of ``prots`` by length, each within BATCH_ELEMENTS."""
    order = sorted(range(len(prots)), key=lambda i: len(prots[i].aatype))
    group = []
    for i in order:
        L = max(len(prots[i].aatype), 1)
        if group and (len(group) + 1) * L * L > BATCH_ELEMENTS:
            yield group
            group = []
        group.append(i)
    if group:
        yield group


def hbond_energy(prot, device=None) -> np.ndarray:
    """(L, L) float64 Kabsch-Sander energy [donor i, acceptor j], NaN where
    the donor has no H; every pair, the ones ``hbond_matrix`` drops too."""
    e, _ = _energy(_backbone([prot], resolve_device(device)))
    return e[0].cpu().numpy()


def hbond_matrix(prot, device=None) -> np.ndarray:
    """(L, L) bool: donor residue i's NH bonded to acceptor j's CO
    (Kabsch-Sander energy < -0.5; |i-j| > 1; prolines have no NH donor)."""
    return _hbonds(_backbone([prot], resolve_device(device)))[0].cpu().numpy()


def assign_secondary_structure_batch(prots: Sequence, device=None
                                     ) -> list[str]:
    """The 3-state string of each of ``prots``, batched by length."""
    dev = resolve_device(device)
    out = [""] * len(prots)
    for group in _batches(prots):
        codes = _assign(_backbone([prots[i] for i in group], dev)).cpu()
        for row, i in zip(codes.numpy(), group):
            out[i] = "".join("CEH"[k] for k in row[:len(prots[i].aatype)])
    return out


def assign_secondary_structure(prot, device=None) -> str:
    """3-state DSSP reduction: 'H' alpha helix, 'E' strand, 'C' coil."""
    return assign_secondary_structure_batch([prot], device)[0]


def ss_fractions(ss: str) -> dict:
    L = max(1, len(ss))
    return {
        "frac_helix": ss.count("H") / L,
        "frac_sheet": ss.count("E") / L,
        "frac_coil": ss.count("C") / L,
    }
