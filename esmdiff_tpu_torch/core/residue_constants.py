"""Minimal atom37 residue constants (the port's copy of
``esmdiff_tpu/core/residue_constants.py``).

Covers the subset of the AlphaFold residue tables the framework needs
(PDB parse/write, backbone extraction, oxygen inference).  Replaces the
reference's vendored slm/utils/residue_constants.py (910 LoC) with the
load-bearing ~10%.
"""

from __future__ import annotations

import numpy as np

# Canonical AlphaFold residue ordering.
restypes = [
    "A", "R", "N", "D", "C", "Q", "E", "G", "H", "I",
    "L", "K", "M", "F", "P", "S", "T", "W", "Y", "V",
]
restype_order = {r: i for i, r in enumerate(restypes)}
restype_num = len(restypes)  # 20
unk_restype_index = restype_num  # 'X'

restype_1to3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}
restype_3to1 = {v: k for k, v in restype_1to3.items()}
# Common modified residues folded onto their parents for parsing.
restype_3to1.update({"MSE": "M", "SEC": "C", "PYL": "K", "UNK": "X"})

# atom37: the fixed 37-slot atom layout.
atom_types = [
    "N", "CA", "C", "CB", "O", "CG", "CG1", "CG2", "OG", "OG1", "SG", "CD",
    "CD1", "CD2", "ND1", "ND2", "OD1", "OD2", "SD", "CE", "CE1", "CE2", "CE3",
    "NE", "NE1", "NE2", "OE1", "OE2", "CH2", "NH1", "NH2", "OH", "CZ", "CZ2",
    "CZ3", "NZ", "OXT",
]
atom_order = {a: i for i, a in enumerate(atom_types)}
atom_type_num = len(atom_types)  # 37

# Per-residue heavy atoms (names within atom37) — used by the PDB writer to
# emit only chemically valid atoms.
residue_atoms = {
    "ALA": ["C", "CA", "CB", "N", "O"],
    "ARG": ["C", "CA", "CB", "CG", "CD", "CZ", "N", "NE", "O", "NH1", "NH2"],
    "ASN": ["C", "CA", "CB", "CG", "N", "ND2", "O", "OD1"],
    "ASP": ["C", "CA", "CB", "CG", "N", "O", "OD1", "OD2"],
    "CYS": ["C", "CA", "CB", "N", "O", "SG"],
    "GLN": ["C", "CA", "CB", "CG", "CD", "N", "NE2", "O", "OE1"],
    "GLU": ["C", "CA", "CB", "CG", "CD", "N", "O", "OE1", "OE2"],
    "GLY": ["C", "CA", "N", "O"],
    "HIS": ["C", "CA", "CB", "CG", "CD2", "CE1", "N", "ND1", "NE2", "O"],
    "ILE": ["C", "CA", "CB", "CG1", "CG2", "CD1", "N", "O"],
    "LEU": ["C", "CA", "CB", "CG", "CD1", "CD2", "N", "O"],
    "LYS": ["C", "CA", "CB", "CG", "CD", "CE", "N", "NZ", "O"],
    "MET": ["C", "CA", "CB", "CG", "CE", "N", "O", "SD"],
    "PHE": ["C", "CA", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "N", "O"],
    "PRO": ["C", "CA", "CB", "CG", "CD", "N", "O"],
    "SER": ["C", "CA", "CB", "N", "O", "OG"],
    "THR": ["C", "CA", "CB", "CG2", "N", "O", "OG1"],
    "TRP": ["C", "CA", "CB", "CG", "CD1", "CD2", "CE2", "CE3", "CZ2", "CZ3",
            "CH2", "N", "NE1", "O"],
    "TYR": ["C", "CA", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "N", "O",
            "OH"],
    "VAL": ["C", "CA", "CB", "CG1", "CG2", "N", "O"],
}

# Backbone slots in atom37.
BACKBONE_ATOM_INDICES = (atom_order["N"], atom_order["CA"], atom_order["C"])
OXYGEN_INDEX = atom_order["O"]

# Idealized local backbone geometry (angstroms) in the residue frame with CA
# at the origin, C on the +x axis, N in the xy-plane.  Used by the structure
# decoder head to place backbone atoms from predicted frames.
IDEALIZED_N = np.array([-0.5272, 1.3593, 0.0], dtype=np.float32)
IDEALIZED_CA = np.array([0.0, 0.0, 0.0], dtype=np.float32)
IDEALIZED_C = np.array([1.5233, 0.0, 0.0], dtype=np.float32)

# C=O geometry for oxygen inference (angstroms / radians).
CO_BOND_LENGTH = 1.231
CA_C_O_ANGLE = 2.0944  # ~120 degrees


def sequence_to_restype_indices(sequence: str) -> np.ndarray:
    """Map a 1-letter sequence to AlphaFold restype indices (X/unknown -> 20)."""
    return np.array(
        [restype_order.get(c, unk_restype_index) for c in sequence],
        dtype=np.int32,
    )
