"""Minimal mmCIF parser: atom_site records -> per-chain atom37 Proteins.

The port's own copy of ``esmdiff_tpu/core/mmcif.py`` (the port imports
nothing of the JAX package): it runs on the host and gives the same
``MmcifObject`` field for field.  A dependency-free stand-in for the
reference's Biopython-based AlphaFold parser
(scripts/mmcif_parsing.py:165-384), covering the fields the pipeline
needs: model 1 atom_site rows, header resolution/method/release date, the
oligomeric details (key-value and loop forms), ``.cif.gz`` files.
"""

from __future__ import annotations

import dataclasses
import gzip
import shlex
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from . import residue_constants as rc
from .protein import Protein


class ParseError(Exception):
    pass


@dataclasses.dataclass
class MmcifHeader:
    entry_id: str = ""
    resolution: Optional[float] = None
    method: str = ""
    release_date: str = ""
    # comma-joined _pdbx_struct_assembly.oligomeric_details values, e.g.
    # "monomeric" or "monomeric,monomeric" (reference metadata convention
    # consumed by filter_metadata.py:77-81)
    oligomeric_detail: str = ""


@dataclasses.dataclass
class MmcifChain:
    chain_id: str
    protein: Protein


@dataclasses.dataclass
class MmcifObject:
    header: MmcifHeader
    chains: dict[str, Protein]


def _tokenize(line: str) -> list[str]:
    # cif tokens: whitespace-separated, quoted with ' or "
    try:
        return shlex.split(line, posix=True)
    except ValueError:
        return line.split()


def _iter_lines(path: str | Path) -> Iterator[str]:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        yield from f


def parse_mmcif(path: str | Path) -> MmcifObject:
    """Parse model-1 polymer atoms and basic header info."""
    header = MmcifHeader()
    atom_cols: list[str] = []
    in_atom_loop = False
    pending_loop: Optional[list[str]] = None
    assembly_cols: list[str] = []
    in_assembly_loop = False
    oligomeric: list[str] = []
    residues: dict[tuple[str, int, str], dict] = {}
    order: list[tuple[str, int, str]] = []
    atom_idx: Optional[dict] = None
    atom_idx_cols: Optional[list] = None
    _i_group = _i_model = _i_comp = _i_atom = _i_alt = None
    _i_chain = _i_seq = _i_icode = _i_x = _i_y = _i_z = _i_b = None

    for raw in _iter_lines(path):
        line = raw.rstrip("\n")
        if line.startswith("#"):
            in_atom_loop = False
            in_assembly_loop = False
            pending_loop = None
            continue
        if line.startswith("loop_"):
            pending_loop = []
            in_atom_loop = False
            in_assembly_loop = False
            continue
        if line.startswith("_atom_site."):
            if pending_loop is not None:
                pending_loop.append(line.strip().split(".")[1].strip())
                atom_cols = pending_loop
                in_atom_loop = True
            continue
        if line.startswith("_pdbx_struct_assembly."):
            key_name = line.strip().split(".", 1)[1].split()[0].strip()
            if pending_loop is not None:
                pending_loop.append(key_name)
                assembly_cols = pending_loop
                in_assembly_loop = True
            else:
                # key-value form: _pdbx_struct_assembly.oligomeric_details val
                toks = _tokenize(line)
                if key_name == "oligomeric_details" and len(toks) > 1:
                    oligomeric.append(toks[1])
            continue
        if line.startswith("_"):
            if pending_loop is not None and not in_atom_loop:
                pending_loop.append(line)
                continue
            toks = _tokenize(line)
            if not toks:
                continue
            key = toks[0]
            val = toks[1] if len(toks) > 1 else ""
            if key == "_entry.id":
                header.entry_id = val
            elif key in ("_refine.ls_d_res_high",
                         "_em_3d_reconstruction.resolution",
                         "_reflns.d_resolution_high"):
                try:
                    if header.resolution is None:
                        header.resolution = float(val)
                except ValueError:
                    pass
            elif key == "_exptl.method":
                header.method = val
            elif key == "_pdbx_audit_revision_history.revision_date":
                if not header.release_date:
                    header.release_date = val
            continue
        if in_assembly_loop and line and not line.startswith("_"):
            toks = _tokenize(line)
            if len(toks) == len(assembly_cols):
                rec = dict(zip(assembly_cols, toks))
                od = rec.get("oligomeric_details", "")
                if od not in ("", ".", "?"):
                    oligomeric.append(od)
            continue
        if in_atom_loop and line and not line.startswith("_"):
            # hot loop: index-based column access (one dict-of-indices per
            # loop header) instead of building a dict per row — measured
            # 1.3x on a 9k-atom entry (line.split + float() dominate)
            if atom_idx is None or atom_idx_cols is not atom_cols:
                atom_idx = {c: i for i, c in enumerate(atom_cols)}
                atom_idx_cols = atom_cols
                _i_group = atom_idx.get("group_PDB")
                _i_model = atom_idx.get("pdbx_PDB_model_num")
                _i_comp = atom_idx.get("label_comp_id")
                _i_atom = atom_idx.get("label_atom_id")
                _i_alt = atom_idx.get("label_alt_id")
                _i_chain = atom_idx.get("auth_asym_id",
                                        atom_idx.get("label_asym_id"))
                _i_seq = atom_idx.get("auth_seq_id",
                                      atom_idx.get("label_seq_id"))
                _i_icode = atom_idx.get("pdbx_PDB_ins_code")
                _i_x = atom_idx.get("Cartn_x")
                _i_y = atom_idx.get("Cartn_y")
                _i_z = atom_idx.get("Cartn_z")
                _i_b = atom_idx.get("B_iso_or_equiv")
            toks = line.split()
            if len(toks) != len(atom_cols):
                toks = _tokenize(line)
                if len(toks) != len(atom_cols):
                    continue
            if _i_group is None or toks[_i_group] not in ("ATOM", "HETATM"):
                continue
            if _i_model is not None and toks[_i_model] not in ("1", ".", "?"):
                continue
            resname = toks[_i_comp] if _i_comp is not None else ""
            if resname not in rc.restype_3to1:
                continue
            atom_name = (toks[_i_atom] if _i_atom is not None else ""
                         ).strip('"')
            if atom_name not in rc.atom_order:
                continue
            alt = toks[_i_alt] if _i_alt is not None else "."
            if alt not in (".", "A", "1", "?"):
                continue
            chain = toks[_i_chain] if _i_chain is not None else "A"
            try:
                resseq = int(toks[_i_seq]) if _i_seq is not None else 0
            except ValueError:
                continue
            icode = toks[_i_icode] if _i_icode is not None else "?"
            key = (chain, resseq, icode)
            rec = residues.get(key)
            if rec is None:
                rec = residues[key] = {"resname": resname, "atoms": {},
                                       "b": {}}
                order.append(key)
            if _i_x is None or _i_y is None or _i_z is None:
                continue
            try:
                xyz = (float(toks[_i_x]), float(toks[_i_y]),
                       float(toks[_i_z]))
            except ValueError:
                continue
            rec["atoms"].setdefault(atom_name, xyz)
            try:
                rec["b"].setdefault(
                    atom_name,
                    float(toks[_i_b]) if _i_b is not None else 0.0)
            except ValueError:
                rec["b"].setdefault(atom_name, 0.0)

    if not order:
        raise ParseError(f"no polymer atoms parsed from {path}")
    header.oligomeric_detail = ",".join(oligomeric)

    chains: dict[str, Protein] = {}
    chain_ids = sorted({k[0] for k in order})
    for cid in chain_ids:
        keys = [k for k in order if k[0] == cid]
        L = len(keys)
        pos = np.zeros((L, rc.atom_type_num, 3), np.float32)
        mask = np.zeros((L, rc.atom_type_num), np.float32)
        bfac = np.zeros((L, rc.atom_type_num), np.float32)
        aatype = np.zeros((L,), np.int32)
        residx = np.zeros((L,), np.int32)
        for i, k in enumerate(keys):
            rec = residues[k]
            one = rc.restype_3to1.get(rec["resname"], "X")
            aatype[i] = rc.restype_order.get(one, rc.unk_restype_index)
            residx[i] = k[1]
            for name, xyz in rec["atoms"].items():
                ai = rc.atom_order[name]
                pos[i, ai] = xyz
                mask[i, ai] = 1.0
                bfac[i, ai] = rec["b"].get(name, 0.0)
        chains[cid] = Protein(pos, mask, aatype, residx, bfac)
    return MmcifObject(header=header, chains=chains)
