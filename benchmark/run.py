"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration
(``benchmark/configs/``) and its traffic (``benchmark/traffic/<name>.json``),
whose ``runner`` (``benchmark/runners/<runner>.py``) runs it; the cell's
limits are ``benchmark/limits/<cell>.json`` and its per-layer metrics are
read by ``benchmark/metrics/<metric>.py``.  A traffic file with
``"launch": "torchrun"`` starts one rank a card under torchrun from this
same command; rank 0 prints the result.

Exits non-zero, printing no result, without as many cards as the cell asks
for, or when JAX, flax or the JAX package is loaded once the window has
closed.  The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device`` and, last, ``checks``: each
number compared with the reference beside its limit.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def launch_command(argv: list[str], chips: int) -> list[str]:
    """This command again under torchrun, one rank a card, on this host."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={chips}", "-m", "benchmark.run", *argv]


def job_for(args, root=None, bench=None) -> dict:
    """Everything a runner needs, read from the manifest (at ``root``) and
    the benchmark's files (at ``bench``)."""
    from benchmark import harness

    root, bench = root or harness.ROOT, bench or harness.HERE
    man = harness.manifest(root)
    cell = harness.cell(man, args.workload)
    return {"cell": cell, "config": harness.config(man, cell["config"], root),
            "traffic": harness.traffic(cell["traffic"], bench),
            "limits": harness.limits(cell["name"], bench),
            "per_layer": harness.per_layer(man, cell["name"]),
            "seed": args.seed, "seconds": args.seconds,
            "trace": bool(args.trace), "t_start": T_START}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from benchmark import harness

    job = job_for(args)
    chips = job["cell"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload}: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    if job["traffic"].get("launch") == "torchrun" and "RANK" not in os.environ:
        return subprocess.run(launch_command(argv, chips)).returncode
    rank = int(os.environ.get("RANK", "0"))
    card = harness.card()
    card["count"] = chips
    if rank == 0:
        print(f"card: {card['kind']} x {torch.cuda.device_count()} "
              f"(using {chips}); nvidia-smi: {harness.power_limit()}",
              flush=True)
    job["device"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                            "0")))
    torch.cuda.set_device(job["device"])
    result = harness.runner(job["traffic"]["runner"]).run(job)
    if rank != 0:
        return 0
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded in the measuring process: {loaded}", file=sys.stderr)
        return 1
    line = harness.result_line(job, result, card)
    harness.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
