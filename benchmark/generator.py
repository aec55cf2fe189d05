"""The one generator of the benchmark's inputs, read from a traffic file.

A sampling mix (``"runner": "sample"``) is a closed loop of requests, one
chain each, from the chains of ``targets.json`` whose residue count lies in
``residues``: the pool, sorted by length, is cut into ``strata`` runs of
near-equal length, and request r takes a chain of stratum
order[r % strata], the order and the chain in each stratum drawn from the
seed.  So every seed sends the same spread of lengths, in another order,
and every request lands in the same length bucket.  Each request carries a
seed of its own.

A training mix (``"runner": "train"``) is a corpus of ``chains`` chains
whose lengths are drawn from the table's, cut at ``max_len``, with random
residues (token ids 4-23) and random structure codes (0-4095): token
values do not change the work.
"""

from __future__ import annotations

import numpy as np

from . import targets


def pool(traffic: dict) -> list[dict]:
    lo, hi = traffic["residues"]
    return sorted((c for c in targets.load() if lo <= c["length"] <= hi),
                  key=lambda c: (c["length"], c["name"]))


def requests(traffic: dict, seed: int, count: int) -> list[dict]:
    """The first ``count`` requests: {name, sequence, seed}."""
    chains = pool(traffic)
    strata = np.array_split(np.arange(len(chains)), traffic["strata"])
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(strata))
    out = []
    for r in range(count):
        stratum = strata[order[r % len(strata)]]
        c = chains[int(stratum[rng.integers(len(stratum))])]
        out.append({"name": c["name"], "sequence": c["sequence"],
                    "seed": int(rng.integers(0, 2 ** 31))})
    return out


def training_chains(traffic: dict, seed: int) -> list[tuple]:
    """[(sequence tokens, structure tokens)] without BOS and EOS."""
    lengths = np.array([c["length"] for c in targets.load()])
    rng = np.random.default_rng(seed)
    drawn = np.minimum(rng.choice(lengths, traffic["chains"]),
                       traffic["max_len"])
    return [(rng.integers(4, 24, n).astype(np.int32),
             rng.integers(0, 4096, n).astype(np.int32)) for n in drawn]
