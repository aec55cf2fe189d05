"""Offline data pipeline: mmCIF corpus -> filtered per-chain .npz + metadata.

Port of ``esmdiff_tpu/cli/preprocess.py`` (``esmdiff-torch-preprocess``),
the reference's scripts/preprocess.py + filter_metadata.py: parse each
mmCIF (``core/mmcif.py``), split it into chains (or merge them, ``--mode
complex``), apply the resolution and length filters, write per-chain
``.npz`` files (aatype, atom37 positions and mask, residue index,
sequence; ``chain_index`` in complex mode; ``secondary_structure`` with
``--with_dssp``) and a ``metadata.csv``, with the same keys and columns as
the JAX package.  ``--filter_only`` runs the curation stage alone.

Parsing and filtering fan out over ``--num_workers`` processes of a
``spawn`` pool, which stay on the host.  ``--with_dssp`` runs the
Kabsch-Sander assigner (``core/secondary_structure.py``) in this process
on ``--device`` (the card unless ``--device cpu``), batched over each chunk
of chains: a CUDA context cannot live in a forked worker.  The ``.npz``
files are then written by the pool.

    python -m esmdiff_tpu_torch.cli.preprocess <cif dir> <out dir> \\
        --with_dssp --num_workers 8
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import multiprocessing as mp
import string
from pathlib import Path

import numpy as np

from esmdiff_tpu_torch.core import mmcif
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.core.protein import Protein

# Chain-character -> integer map (reference scripts/preprocess.py:31-37);
# multi-char chain ids compose positionally (chain_str_to_int, :63-70).
ALPHANUMERIC = string.ascii_letters + string.digits + " "
CHAIN_TO_INT = {c: i for i, c in enumerate(ALPHANUMERIC)}
# files a worker pool takes per round of parse -> DSSP -> write
CHUNK_PER_WORKER = 64


def chain_str_to_int(chain_str: str) -> int:
    out = 0
    for i, ch in enumerate(chain_str):
        out += CHAIN_TO_INT.get(ch, 0) + i * len(ALPHANUMERIC)
    return out


def _row(obj, name, pdb_name, L, res, quaternary) -> dict:
    return {"file": name, "status": "ok", "length": L,
            "resolution": res if res is not None else "",
            "method": obj.header.method,
            "release_date": obj.header.release_date,
            "pdb_name": pdb_name, "num_chains": len(obj.chains),
            "quaternary_category": quaternary,
            "oligomeric_detail": obj.header.oligomeric_detail}


def _process_complex(obj, pdb_name, min_len, max_len, res, quaternary):
    """Merge all chains of one entry into one example (reference
    preprocess.py mode='complex', :400-426): per-residue ``chain_index``
    (chain_str_to_int, sequential ids where those collide: 'AB' == 'BA'),
    concatenated atom37 features, unmodeled (UNK) termini stripped
    (strip_feats_by_modeled_idx, :225-236).  The dump inserts chainbreak
    tokens at chain transitions."""
    items = sorted(obj.chains.items())
    aatype = np.concatenate([p.aatype for _, p in items])
    pos = np.concatenate([p.atom_positions for _, p in items])
    mask = np.concatenate([p.atom_mask for _, p in items])
    residx = np.concatenate([p.residue_index for _, p in items])
    ids = [chain_str_to_int(cid) for cid, _ in items]
    if len(set(ids)) != len(ids):
        ids = list(range(len(items)))
    chain_index = np.concatenate([
        np.full((len(p.aatype),), ids[k], np.int32)
        for k, (_, p) in enumerate(items)])
    seq = "".join(p.sequence for _, p in items)
    raw_len = len(aatype)

    modeled = np.where(aatype != rc.unk_restype_index)[0]
    if len(modeled) == 0:
        return {"file": pdb_name, "status": "no_modeled_residues"}
    lo, hi = int(modeled.min()), int(modeled.max()) + 1
    aatype, pos, mask, residx, chain_index = (
        a[lo:hi] for a in (aatype, pos, mask, residx, chain_index))
    seq = seq[lo:hi]
    L = len(aatype)
    if L < min_len or L > max_len:
        return {"file": pdb_name, "status": f"length_filtered ({L})"}
    return {**_row(obj, pdb_name, pdb_name, L, res, quaternary),
            "raw_seq_len": raw_len, "modeled_seq_len": L,
            "_arrays": dict(aatype=aatype, atom_positions=pos,
                            atom_mask=mask, residue_index=residx,
                            chain_index=chain_index, sequence=np.array(seq))}


def parse_one(args) -> list[dict]:
    """One mmCIF file -> its metadata rows; an ok row carries the arrays
    of its ``.npz`` under ``_arrays`` (nothing is written here)."""
    path, max_resolution, min_len, max_len, mode = args
    try:
        obj = mmcif.parse_mmcif(path)
    except Exception as e:
        return [{"file": Path(path).name, "status": f"parse_error: {e}"}]
    res = obj.header.resolution
    if res is not None and (res < 0.01 or res > max_resolution):
        return [{"file": Path(path).name,
                 "status": f"resolution_filtered ({res})"}]
    # quaternary category from the polymer chain content (consumed by
    # filter_metadata.py:60-74)
    pdb_name = Path(path).stem.split(".")[0]
    seqs = {p.sequence for p in obj.chains.values()}
    quaternary = "homomer" if len(seqs) <= 1 else "heteromer"
    if mode == "complex":
        return [_process_complex(obj, pdb_name, min_len, max_len, res,
                                 quaternary)]
    rows = []
    for cid, prot in obj.chains.items():
        L = len(prot.aatype)
        name = f"{pdb_name}_{cid}"
        if L < min_len or L > max_len:
            rows.append({"file": name, "status": f"length_filtered ({L})"})
            continue
        rows.append({**_row(obj, name, pdb_name, L, res, quaternary),
                     "_arrays": dict(
                         aatype=prot.aatype,
                         atom_positions=prot.atom_positions,
                         atom_mask=prot.atom_mask,
                         residue_index=prot.residue_index,
                         sequence=np.array(prot.sequence))})
    return rows


def write_one(item) -> None:
    path, arrays = item
    np.savez_compressed(path, **arrays)


def add_dssp(rows: list[dict], device) -> None:
    """The 3-state string and fractions of every ok row, in place: the
    ``secondary_structure`` array and the metadata columns."""
    from esmdiff_tpu_torch.core.secondary_structure import (
        assign_secondary_structure_batch, ss_fractions)

    prots = []
    for r in rows:
        a = r["_arrays"]
        prots.append(Protein(a["atom_positions"], a["atom_mask"],
                             a["aatype"], a["residue_index"],
                             np.zeros_like(a["atom_mask"])))
    for r, ss in zip(rows, assign_secondary_structure_batch(prots, device)):
        r["_arrays"]["secondary_structure"] = np.array(ss)
        r["secondary_structure"] = ss
        r.update({k: round(v, 4) for k, v in ss_fractions(ss).items()})


def filter_metadata(csv_path, output_csv=None, min_len: int = 10,
                    max_len: int = 1000, min_res: float = 0.01,
                    max_res: float = 5.0,
                    oligomeric: str = "monomeric") -> list[dict]:
    """Post-preprocess dataset curation (reference filter_metadata.py:11-87):
    length [10,1000], resolution [0.01,5.0], one chain per homomeric entry,
    and oligomeric_detail restricted to all-``monomeric`` assemblies.
    Returns the kept rows; writes them to ``output_csv`` when given."""
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("status") == "ok"]
    n0 = len(rows)

    rows = [r for r in rows if min_len <= int(r["length"]) <= max_len]
    n1 = len(rows)
    rows = [
        r for r in rows
        if r.get("resolution") not in ("", None)
        and min_res <= float(r["resolution"]) <= max_res
    ]
    n2 = len(rows)

    # homomer dedup: keep every heteromer chain, but only the first chain of
    # each multi-chain homomeric pdb (reference filter_metadata.py:60-74)
    kept, seen_homomer = [], set()
    for r in rows:
        if (r.get("quaternary_category") == "homomer"
                and int(r.get("num_chains", 1) or 1) > 1):
            if r["pdb_name"] in seen_homomer:
                continue
            seen_homomer.add(r["pdb_name"])
        kept.append(r)
    rows = kept
    n3 = len(rows)

    if oligomeric:
        # allow "monomeric", "monomeric,monomeric", ... (reference :77-81)
        rows = [
            r for r in rows
            if r.get("oligomeric_detail")
            and set(r["oligomeric_detail"].split(",")) == {oligomeric}
        ]
    print(f"[filter] {n0} chains -> {n1} after length [{min_len},{max_len}] "
          f"-> {n2} after resolution [{min_res},{max_res}] "
          f"-> {n3} after homomer dedup -> {len(rows)} after "
          f"oligomeric_detail == {oligomeric!r}")
    if output_csv is not None and rows:
        with open(output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return rows


def get_argparser():
    p = argparse.ArgumentParser(
        description="Preprocess mmCIF corpus into per-chain npz + metadata "
                    "(PyTorch port).")
    p.add_argument("input_dir", type=str)
    p.add_argument("output_dir", type=str)
    p.add_argument("--max_resolution", type=float, default=5.0)
    p.add_argument("--min_len", type=int, default=10)
    p.add_argument("--max_len", type=int, default=1000)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--filter_only", action="store_true",
                   help="input_dir is an existing metadata.csv: run only the "
                        "curation stage (reference filter_metadata.py) and "
                        "write filtered.csv next to it.")
    p.add_argument("--oligomeric", type=str, default="monomeric",
                   help="Keep only chains whose assemblies are all this "
                        "oligomeric_detail ('' disables; reference "
                        "filter_metadata.py:77-81).")
    p.add_argument("--mode", type=str, default="chain",
                   choices=["chain", "complex"],
                   help="'chain' = one example per chain; 'complex' = "
                        "merge all chains of an entry into one example with "
                        "per-residue chain_index and unmodeled-termini "
                        "stripping (the reference's default, "
                        "scripts/preprocess.py:450,400-426).")
    p.add_argument("--with_dssp", action="store_true",
                   help="Record 3-state secondary structure + fractions per "
                        "chain (Kabsch-Sander, core/secondary_structure.py, "
                        "on --device).")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the DSSP; 'cpu' runs it on the "
                        "host.")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns {"files", "rows" (the metadata rows), "ok"}."""
    args = get_argparser().parse_args(argv)
    if args.filter_only:
        csv_in = Path(args.input_dir)
        out_csv = Path(args.output_dir) / "filtered.csv"
        out_csv.parent.mkdir(parents=True, exist_ok=True)
        rows = filter_metadata(csv_in, out_csv, min_len=args.min_len,
                               max_len=args.max_len,
                               max_res=args.max_resolution,
                               oligomeric=args.oligomeric)
        return {"files": 0, "rows": rows, "ok": len(rows)}

    device = None
    if args.with_dssp:
        from esmdiff_tpu_torch.device import resolve_device

        device = resolve_device(args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(
        list(Path(args.input_dir).glob("*.cif"))
        + list(Path(args.input_dir).glob("*.cif.gz"))
    )
    print(f"[preprocess] {len(files)} mmCIF files")
    work = [(str(f), args.max_resolution, args.min_len, args.max_len,
             args.mode) for f in files]
    rows = []
    with contextlib.ExitStack() as stack:
        if args.num_workers > 1:
            pool = stack.enter_context(
                mp.get_context("spawn").Pool(args.num_workers))
            run = pool.map
        else:
            run = lambda f, items: list(map(f, items))  # noqa: E731
        chunk = max(1, args.num_workers) * CHUNK_PER_WORKER
        for start in range(0, len(work), chunk):
            chunk_rows = [r for rs in run(parse_one, work[start:start + chunk])
                          for r in rs]
            ok = [r for r in chunk_rows if r["status"] == "ok"]
            if args.with_dssp and ok:
                add_dssp(ok, device)
            run(write_one, [(out_dir / f"{r['file']}.npz", r.pop("_arrays"))
                            for r in ok])
            rows += chunk_rows
    fields = ["file", "status", "length", "resolution", "method",
              "release_date", "pdb_name", "num_chains",
              "quaternary_category", "oligomeric_detail"]
    if args.mode == "complex":
        fields += ["raw_seq_len", "modeled_seq_len"]
    if args.with_dssp:
        fields += ["secondary_structure", "frac_helix", "frac_sheet",
                   "frac_coil"]
    with open(out_dir / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fields})
    n_ok = sum(1 for r in rows if r["status"] == "ok")
    print(f"[preprocess] {n_ok} chains kept, "
          f"{len(rows) - n_ok} filtered/errored -> {out_dir}")
    return {"files": len(files), "rows": rows, "ok": n_ok}


if __name__ == "__main__":
    main()
