"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \\
        --control 7,8,9 [--faults 7,8,9]

For each of ``--seeds`` the program's numbers, as a run compares them (the
same forwards, rows or steps; the watched request is the window's first).
For each of ``--control`` the control's: a sampling cell's program on its
own int8 path (``quant="int8"``, trunk and decoder), a training cell's
reference computed in float8 in the program's place.  For each of
``--faults`` (training) the program with half of every batch left out, the
mean taken over the rest.  One JSON line a reading, then the largest
program reading and the smallest control and fault reading of each
number.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from benchmark import generator, harness, run


def half_batches():
    """Leave out the second half of every batch's rows from the loss
    (their mask zeroed, the mean taken over the rest)."""
    from esmdiff_tpu_torch.train import loop

    whole = loop.to_device

    def half(batch, device):
        b = dict(batch)
        b["mask"] = b["mask"].copy()
        b["mask"][len(b["mask"]) // 2:] = 0.0
        return whole(b, device)

    loop.to_device = half
    return lambda: setattr(loop, "to_device", whole)


def train_control(job, seed):
    drv = harness.runner("train")
    s_weights, s_data, s_run = harness.seeds(seed, 3)
    chains = generator.training_chains(job["traffic"], s_data)
    args = (job["config"], job["traffic"], chains, s_weights, s_run,
            job["device"])
    return drv.gaps(drv.reference_readings(*args, precision="fp8"),
                    drv.reference_readings(*args))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    a = p.parse_args()
    ints = (lambda s: [int(x) for x in s.split(",") if x])
    print(harness.power_limit(), flush=True)
    readings = {"program": [], "control": [], "fault": []}
    for kind, seeds in (("program", ints(a.seeds)),
                        ("control", ints(a.control)),
                        ("fault", ints(a.faults))):
        for seed in seeds:
            job = run.job_for(run.parse(["--workload", a.workload, "--seed",
                                         str(seed), "--seconds", "0"]))
            job["device"] = torch.device("cuda", 0)
            job["per_layer"] = []
            if "capture" in job["traffic"]:
                job["traffic"]["capture"]["requests"] = 1
            t0 = time.monotonic()
            job["t_start"] = t0
            runner = job["traffic"]["runner"]
            undo = None
            if kind == "control" and runner == "train":
                numbers = train_control(job, seed)
            else:
                if kind == "control":
                    job["quant"] = "int8"
                if kind == "fault":
                    undo = half_batches()
                out = harness.runner(runner).run(job)
                numbers = out["numbers"]
                for key in ("losses", "rows_rmsd_A"):
                    if key in out:
                        print(json.dumps({key: out[key]}), flush=True)
                if undo:
                    undo()
            readings[kind].append(numbers)
            print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                              "s": time.monotonic() - t0}), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for name in readings["program"][0] if readings["program"] else []:
        summary[name] = {
            "program_max": max(r[name] for r in readings["program"]),
            "program_median": float(np.median(
                [r[name] for r in readings["program"]])),
            **{f"{k}_min": min(r[name] for r in readings[k])
               for k in ("control", "fault") if readings[k]}}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
