"""The readings the SDAR cell's limits are set from, on the card, in one
process (``calibrate.py``'s form, with the cell's controls).

    python3 -m benchmark.calibrate_sdar --seeds 1,2,... [--top7 9,10] \\
        [--workload sdar.block4.L128]

For each of ``--seeds`` one run's numbers (the watched request the
window's first), each with the reference-side controls read beside them
(``runners/sample_block.py``: W8A8 experts on ``stage_err``, the reference
in float8 on ``logits_rel_err``, its router in float8 on
``route_mismatch``, also over each of ``MARGINS``); for each of ``--top7``
those of the program routing 7 experts a token.  One JSON line a reading,
then the largest program reading and the smallest control reading of
each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

from benchmark import harness, run

CONTROLS = ["int8", "fp8", "fp8_router"]


def reading(workload: str, seed: int, control: str = "none") -> dict:
    job = run.job_for(run.parse(["--workload", workload, "--seed",
                                 str(seed), "--seconds", "0"]))
    job["device"] = torch.device("cuda", 0)
    job["per_layer"] = []
    job["traffic"]["capture"]["requests"] = 1
    job["control"] = control
    job["controls"] = CONTROLS if control == "none" else []
    job["t_start"] = time.monotonic()
    out = harness.runner(job["traffic"]["runner"]).run(job)
    numbers = out["numbers"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="sdar.block4.L128")
    p.add_argument("--seeds", default="")
    p.add_argument("--top7", default="")
    a = p.parse_args()
    ints = (lambda s: [int(x) for x in s.split(",") if x])
    print(harness.power_limit(), flush=True)
    readings = {"none": [], "top7": []}
    for kind, seeds in (("none", ints(a.seeds)), ("top7", ints(a.top7))):
        for seed in seeds:
            t0 = time.monotonic()
            numbers = reading(a.workload, seed, kind)
            readings[kind].append(numbers)
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                              "s": time.monotonic() - t0}), flush=True)
    summary = {}
    for name in readings["none"][0] if readings["none"] else []:
        values = [r[name] for r in readings["none"]
                  if isinstance(r.get(name), (int, float))]
        if not values:
            continue
        control = name.split(".")[0] in CONTROLS
        summary[name] = {"min" if control else "max":
                         min(values) if control else max(values),
                         "median": float(np.median(values))}
    if readings["top7"]:
        summary["top7.route_mismatch"] = {"min": min(
            r["route_mismatch"] for r in readings["top7"])}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
