"""Protein structure container + PDB I/O.

The port's copy of ``esmdiff_tpu/core/protein.py``: the ``Protein``
container (with its N/CA/C and CA views), backbone -> atom37 with inferred
carbonyl oxygens, the PDB parser (the C++ parser of ``native/pdbio``, built
by ``utils/native.py``, and the pure-Python parser it defers to), the
single- and multi-MODEL writers, the merge/split helpers and the CA loader
of the evaluation suites.  Pure numpy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import os
import threading
from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from esmdiff_tpu_torch.utils import native

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
# PDB parsing: the C++ parser (native/pdbio, through ctypes), which defers
# to the pure-Python parser on input it cannot parse as Python would
# ---------------------------------------------------------------------------

_pdbio = None
_pdbio_lock = threading.Lock()


def _load_pdbio():
    """Build (once) and load the native parser, its vocabularies injected
    from residue_constants so Python stays their one source; None when
    ESMDIFF_NO_NATIVE_PDB is set (the pure-Python parser then).  A failed
    build raises."""
    global _pdbio
    if os.environ.get("ESMDIFF_NO_NATIVE_PDB"):
        return None
    with _pdbio_lock:
        if _pdbio is not None:
            return _pdbio
        lib = native.load("pdbio")
        c = ctypes
        lib.pdbio_init.restype = None
        lib.pdbio_init.argtypes = [c.c_char_p, c.c_char_p,
                                   c.POINTER(c.c_int), c.c_int, c.c_int]
        lib.pdbio_parse.restype = c.c_void_p
        lib.pdbio_parse.argtypes = [c.c_char_p, c.c_int64, c.c_char]
        lib.pdbio_n_models.restype = c.c_int
        lib.pdbio_n_models.argtypes = [c.c_void_p]
        lib.pdbio_model_len.restype = c.c_int
        lib.pdbio_model_len.argtypes = [c.c_void_p, c.c_int]
        lib.pdbio_model_fill.restype = None
        lib.pdbio_model_fill.argtypes = [
            c.c_void_p, c.c_int, c.POINTER(c.c_float), c.POINTER(c.c_float),
            c.POINTER(c.c_float), c.POINTER(c.c_int), c.POINTER(c.c_int)]
        lib.pdbio_free.restype = None
        lib.pdbio_free.argtypes = [c.c_void_p]

        res3 = sorted(rc.restype_3to1.items())
        idxs = (c.c_int * len(res3))(*[
            rc.restype_order.get(one, rc.unk_restype_index)
            for _, one in res3])
        lib.pdbio_init(",".join(rc.atom_types).encode(),
                       ",".join(k for k, _ in res3).encode(), idxs,
                       len(res3), rc.unk_restype_index)
        _pdbio = lib
        return lib


def _native_parse_models(pdb_str: str,
                         chain_id: str | None) -> list[Protein] | None:
    """The native parse, or None where the Python parser decides: the
    parser is switched off, the text is not ASCII (native byte columns
    would shift against Python's character columns), or a line holds what
    the C++ cannot parse exactly as Python does."""
    lib = _load_pdbio()
    if lib is None:
        return None
    try:
        data = pdb_str.encode("ascii")
    except UnicodeEncodeError:
        return None
    h = lib.pdbio_parse(data, len(data),
                        chain_id.encode()[:1] if chain_id else b"\x00")
    if not h:
        return None
    ptr = ctypes.POINTER
    try:
        prots = []
        for m in range(lib.pdbio_n_models(h)):
            L = lib.pdbio_model_len(h, m)
            pos = np.zeros((L, rc.atom_type_num, 3), np.float32)
            mask = np.zeros((L, rc.atom_type_num), np.float32)
            bfac = np.zeros((L, rc.atom_type_num), np.float32)
            aatype = np.zeros((L,), np.int32)
            residx = np.zeros((L,), np.int32)
            if L:
                lib.pdbio_model_fill(
                    h, m, pos.ctypes.data_as(ptr(ctypes.c_float)),
                    mask.ctypes.data_as(ptr(ctypes.c_float)),
                    bfac.ctypes.data_as(ptr(ctypes.c_float)),
                    aatype.ctypes.data_as(ptr(ctypes.c_int)),
                    residx.ctypes.data_as(ptr(ctypes.c_int)))
                prots.append(Protein(pos, mask, aatype, residx, bfac))
        return prots
    finally:
        lib.pdbio_free(h)


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
    the text holds no residue.  The native parser and the Python one give
    the same Proteins (tests/test_torch_protein_io.py)."""
    prots = _native_parse_models(pdb_str, chain_id)
    if prots is None:
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


def to_pdb(prot: Protein, chain_id: str = "A") -> str:
    return to_pdb_body(prot, chain_id) + "\nEND\n"


def to_pdb_file(prot: Protein, path: str | Path, chain_id: str = "A") -> None:
    Path(path).write_text(to_pdb(prot, chain_id))


def merge_pdb_files(paths: Iterable[str | Path], out_path: str | Path) -> None:
    """Concatenate single-model PDBs into one multi-MODEL file."""
    prots: list[Protein] = []
    for p in paths:
        got = from_pdb_file(p)
        prots.extend(got if isinstance(got, list) else [got])
    ensemble_to_pdb_file(prots, out_path)


def split_pdb_file(path: str | Path, out_dir: str | Path) -> list[Path]:
    """Split a multi-MODEL PDB into per-model files ``<stem>.<i>.pdb``."""
    got = from_pdb_file(path)
    prots = got if isinstance(got, list) else [got]
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    outs = []
    for i, p in enumerate(prots):
        fp = out_dir / f"{Path(path).stem}.{i}.pdb"
        to_pdb_file(p, fp)
        outs.append(fp)
    return outs


def load_ca_ensemble(path: str | Path,
                     max_n_model: int | None = None) -> np.ndarray:
    """(N_models, L, 3) CA coordinates from a (multi-model) PDB, a ``.npy``
    trajectory in nm ((N, L, 3), or (N, L, atoms, 3) with CA at atom 1;
    scaled x10 to angstrom), or a directory of PDBs concatenated in sorted
    order; ``max_n_model`` keeps that many models at a stride."""
    path = Path(path)
    if path.is_dir():
        arr = np.concatenate([load_ca_ensemble(f)
                              for f in sorted(path.iterdir())
                              if f.suffix == ".pdb"], axis=0)
    elif path.suffix == ".npy":
        arr = np.load(path) * 10.0
        if arr.ndim == 4:
            arr = arr[:, :, 1]
    else:
        got = from_pdb_file(path)
        prots = got if isinstance(got, list) else [got]
        arr = np.stack([p.ca_coords() for p in prots], axis=0)
    if max_n_model is not None and len(arr) > max_n_model > 0:
        arr = arr[::len(arr) // max_n_model][:max_n_model]
    return arr
