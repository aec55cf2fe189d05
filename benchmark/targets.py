"""The frozen table of target chains the traffic draws from.

    python -m benchmark.targets     # rewrites benchmark/traffic/targets.json

Reads every ``data/targets/<set>/<chain>.pdb`` with the benchmark's own
reader: the first model's CA atoms (altloc blank or A, one a residue
number and insertion code), standard residue names to one letter, any
other to X.  The table, not ``data/targets``, is what the benchmark runs.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
TABLE = HERE / "traffic" / "targets.json"
THREE_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C", "GLN": "Q",
    "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I", "LEU": "L", "LYS": "K",
    "MET": "M", "PHE": "F", "PRO": "P", "SER": "S", "THR": "T", "TRP": "W",
    "TYR": "Y", "VAL": "V"}


def read_sequence(path: Path) -> str:
    seq, seen = [], set()
    with open(path) as f:
        for line in f:
            if line.startswith("ENDMDL"):
                break
            if (line.startswith(("ATOM", "HETATM"))
                    and line[12:16].strip() == "CA" and line[16] in " A"):
                key = (line[21], line[22:27])
                if key not in seen:
                    seen.add(key)
                    seq.append(THREE_TO_ONE.get(line[17:20], "X"))
    return "".join(seq)


def build(root: Path) -> dict:
    chains = []
    for path in sorted(root.glob("*/*.pdb")):
        seq = read_sequence(path)
        chains.append({"name": f"{path.parent.name}/{path.stem}",
                       "length": len(seq), "sequence": seq})
    return {"source": "data/targets/*/*.pdb: first model, CA records",
            "chains": chains}


def load() -> list[dict]:
    return json.loads(TABLE.read_text())["chains"]


if __name__ == "__main__":
    table = build(HERE.parent / "data" / "targets")
    TABLE.write_text(json.dumps(table, indent=0) + "\n")
    print(f"{len(table['chains'])} chains -> {TABLE}")
