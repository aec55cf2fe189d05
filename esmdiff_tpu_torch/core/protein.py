"""Protein structure container + PDB I/O (the subset the ddpm slice uses).

The port's copy of ``esmdiff_tpu/core/protein.py``: the ``Protein``
container (with its N/CA/C and CA views), backbone -> atom37 with inferred
carbonyl oxygens, the pure-Python
PDB parser, and the multi-MODEL ensemble writer.  Pure numpy.
"""

from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from . import residue_constants as rc


@dataclasses.dataclass
class Protein:
    """Single-chain protein in atom37 layout.

    atom_positions: (L, 37, 3) float32
    atom_mask:      (L, 37) float32, 1.0 where the atom exists
    aatype:         (L,) int32 restype indices (X = 20)
    residue_index:  (L,) int32 author residue numbering
    b_factors:      (L, 37) float32
    """

    atom_positions: np.ndarray
    atom_mask: np.ndarray
    aatype: np.ndarray
    residue_index: np.ndarray
    b_factors: np.ndarray

    def __post_init__(self):
        L = self.atom_positions.shape[0]
        assert self.atom_positions.shape == (L, rc.atom_type_num, 3)
        assert self.atom_mask.shape == (L, rc.atom_type_num)
        assert self.aatype.shape == (L,)

    @property
    def sequence(self) -> str:
        rts = rc.restypes + ["X"]
        return "".join(rts[min(a, rc.restype_num)] for a in self.aatype)

    def backbone_coords(self) -> np.ndarray:
        """(L, 3, 3) N/CA/C coordinates, NaN where missing."""
        idx = list(rc.BACKBONE_ATOM_INDICES)
        coords = self.atom_positions[:, idx, :].astype(np.float32).copy()
        coords[~(self.atom_mask[:, idx] > 0.5)] = np.nan
        return coords

    def ca_coords(self) -> np.ndarray:
        return self.atom_positions[:, rc.atom_order["CA"], :].astype(
            np.float32)


def from_backbone(
    bb: np.ndarray,
    sequence: str | None = None,
    infer_oxygen_atoms: bool = True,
) -> Protein:
    """Build a Protein from (L, 3, 3) N/CA/C backbone coordinates."""
    bb = np.asarray(bb, dtype=np.float32)
    L = bb.shape[0]
    assert bb.shape == (L, 3, 3), bb.shape
    pos = np.zeros((L, rc.atom_type_num, 3), dtype=np.float32)
    mask = np.zeros((L, rc.atom_type_num), dtype=np.float32)
    finite = np.isfinite(bb).all(axis=-1)  # (L, 3)
    for k, ai in enumerate(rc.BACKBONE_ATOM_INDICES):
        pos[:, ai] = np.where(finite[:, k, None], bb[:, k], 0.0)
        mask[:, ai] = finite[:, k].astype(np.float32)
    if sequence is None:
        aatype = np.full((L,), rc.restype_order["G"], dtype=np.int32)
    else:
        aatype = rc.sequence_to_restype_indices(sequence)
        assert len(aatype) == L, (len(aatype), L)
    prot = Protein(
        atom_positions=pos,
        atom_mask=mask,
        aatype=aatype,
        residue_index=np.arange(1, L + 1, dtype=np.int32),
        b_factors=np.zeros((L, rc.atom_type_num), dtype=np.float32),
    )
    if infer_oxygen_atoms:
        prot = infer_oxygen(prot)
    return prot


def infer_oxygen(prot: Protein) -> Protein:
    """Place carbonyl O from the C->N(i+1) peptide geometry.

    O lies in the CA-C-N(i+1) plane at ~120 deg from CA, 1.231 A from C.  The
    final residue gets no oxygen (no next N).
    """
    pos = prot.atom_positions.copy()
    mask = prot.atom_mask.copy()
    n_i, ca_i, c_i = rc.BACKBONE_ATOM_INDICES
    if pos.shape[0] < 2:
        return prot
    c = pos[:-1, c_i]
    ca = pos[:-1, ca_i]
    n_next = pos[1:, n_i]
    ok = (
        (mask[:-1, c_i] > 0.5)
        & (mask[:-1, ca_i] > 0.5)
        & (mask[1:, n_i] > 0.5)
    )

    def _unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

    # O is opposite the bisector of (CA, N_next) in their plane.
    bis = _unit(_unit(ca - c) + _unit(n_next - c))
    o = c - bis * rc.CO_BOND_LENGTH
    pos[:-1, rc.OXYGEN_INDEX] = np.where(ok[:, None], o, 0.0)
    mask[:-1, rc.OXYGEN_INDEX] = ok.astype(np.float32)
    return dataclasses.replace(prot, atom_positions=pos, atom_mask=mask)


# ---------------------------------------------------------------------------
# PDB parsing (pure Python; the native parser waits for a later slice)
# ---------------------------------------------------------------------------

def _parse_model_lines(lines: list[str], chain_id: str | None) -> Protein:
    residues: dict[tuple[str, int, str], dict] = {}
    order: list[tuple[str, int, str]] = []
    picked_chain = chain_id
    for line in lines:
        if not (line.startswith("ATOM") or line.startswith("HETATM")):
            continue
        resname = line[17:20].strip()
        if line.startswith("HETATM") and resname not in rc.restype_3to1:
            continue
        ch = line[21]
        if picked_chain is None:
            picked_chain = ch
        if ch != picked_chain:
            continue
        altloc = line[16]
        if altloc not in (" ", "A", "1"):
            continue
        atom_name = line[12:16].strip()
        if atom_name not in rc.atom_order:
            continue
        resseq = int(line[22:26])
        icode = line[26]
        key = (ch, resseq, icode)
        if key not in residues:
            residues[key] = {"resname": resname, "atoms": {}, "bfac": {}}
            order.append(key)
        x = float(line[30:38])
        y = float(line[38:46])
        z = float(line[46:54])
        try:
            b = float(line[60:66])
        except ValueError:
            b = 0.0
        residues[key]["atoms"].setdefault(atom_name, (x, y, z))
        residues[key]["bfac"].setdefault(atom_name, b)

    L = len(order)
    pos = np.zeros((L, rc.atom_type_num, 3), dtype=np.float32)
    mask = np.zeros((L, rc.atom_type_num), dtype=np.float32)
    bfac = np.zeros((L, rc.atom_type_num), dtype=np.float32)
    aatype = np.zeros((L,), dtype=np.int32)
    residx = np.zeros((L,), dtype=np.int32)
    for i, key in enumerate(order):
        rec = residues[key]
        one = rc.restype_3to1.get(rec["resname"], "X")
        aatype[i] = rc.restype_order.get(one, rc.unk_restype_index)
        residx[i] = key[1]
        for name, xyz in rec["atoms"].items():
            ai = rc.atom_order[name]
            pos[i, ai] = xyz
            mask[i, ai] = 1.0
            bfac[i, ai] = rec["bfac"][name]
    return Protein(pos, mask, aatype, residx, bfac)


def _python_parse_models(pdb_str: str,
                         chain_id: str | None) -> list[Protein]:
    models: list[list[str]] = []
    current: list[str] = []
    seen_model_rec = False
    for line in pdb_str.splitlines():
        if line.startswith("MODEL"):
            seen_model_rec = True
            current = []
        elif line.startswith("ENDMDL"):
            models.append(current)
            current = []
        else:
            current.append(line)
    if not seen_model_rec:
        models = [current]
    elif current and any(
        l.startswith(("ATOM", "HETATM")) for l in current
    ):
        models.append(current)

    prots = [_parse_model_lines(m, chain_id) for m in models if m]
    return [p for p in prots if len(p.aatype) > 0]


def from_pdb_string(
    pdb_str: str, chain_id: str | None = None, model: int | None = None
) -> Protein | list[Protein]:
    """Parse a PDB string.  Returns one Protein, or a list when the file has
    multiple MODEL records and ``model`` is None.  Raises ValueError when
    the text holds no residue."""
    prots = _python_parse_models(pdb_str, chain_id)
    if not prots:
        raise ValueError("no residues in the PDB text")
    if model is not None:
        return prots[model]
    seen_model_rec = pdb_str.startswith("MODEL") or "\nMODEL" in pdb_str
    if not seen_model_rec or len(prots) == 1:
        return prots[0]
    return prots


def from_pdb_file(
    path: str | Path, chain_id: str | None = None, model: int | None = None
) -> Protein | list[Protein]:
    return from_pdb_string(Path(path).read_text(), chain_id, model)


# ---------------------------------------------------------------------------
# PDB writing
# ---------------------------------------------------------------------------

def to_pdb_body(prot: Protein, chain_id: str = "A",
                serial_start: int = 1) -> str:
    lines = []
    serial = serial_start
    rts3 = [rc.restype_1to3[r] for r in rc.restypes] + ["UNK"]
    for i in range(len(prot.aatype)):
        res3 = rts3[min(int(prot.aatype[i]), rc.restype_num)]
        for ai, atom_name in enumerate(rc.atom_types):
            if prot.atom_mask[i, ai] < 0.5:
                continue
            x, y, z = prot.atom_positions[i, ai]
            if not (math.isfinite(x) and math.isfinite(y)
                    and math.isfinite(z)):
                continue
            name = atom_name if len(atom_name) == 4 else f" {atom_name:<3s}"
            lines.append(
                f"ATOM  {serial:>5d} {name}{'':1s}{res3:>3s} {chain_id}"
                f"{int(prot.residue_index[i]):>4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.00:6.2f}"
                f"{float(prot.b_factors[i, ai]):6.2f}          "
                f"{atom_name[0]:>2s}  "
            )
            serial += 1
    lines.append(
        f"TER   {serial:>5d}      {res3:>3s} {chain_id}"
        f"{int(prot.residue_index[-1]):>4d}"
    )
    return "\n".join(lines)


def ensemble_to_pdb(prots: Sequence[Protein], chain_id: str = "A") -> str:
    """Write an ensemble as a multi-MODEL PDB."""
    out = []
    for k, p in enumerate(prots, start=1):
        out.append(f"MODEL     {k:>4d}")
        out.append(to_pdb_body(p, chain_id))
        out.append("ENDMDL")
    out.append("END")
    return "\n".join(out) + "\n"


def ensemble_to_pdb_file(
    prots: Sequence[Protein], path: str | Path, chain_id: str = "A"
) -> None:
    """Atomic write (temp file + rename), so a file killed mid-write is never
    left behind under the final name."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(ensemble_to_pdb(prots, chain_id))
    os.replace(tmp, path)
