"""``chip_smoke.py`` of two checkouts on one card, in the order other, this,
this, other, with every kernel time taken by this checkout's
``tools/timing.py``, so that two commits' kernel and end-to-end numbers
compare within one call on one yardstick.

    python -m esmdiff_tpu_torch.tools.smoke_ab OTHER   # from the repo root

OTHER is a checkout of the other commit (for example ``git archive``
unpacked into a directory that ``.gitignore`` lists).  Each run is its own
process, started in its checkout.  An older ``chip_smoke.py`` that timed
kernels with its own ``cuda_ms`` (CUDA events around back-to-back calls,
which time the host's enqueue where it is longer than the kernel) has that
function replaced by ``tools/timing.py``'s ``device_ms``; a newer one
already uses it.  Every run's output goes to stdout with a ``[run i
label]`` prefix; the last line is one JSON object with, per run, its
exit code, its paths' conf/s and ms/step per target, and each kernel's ms and
host ms per call at every shape it printed.  Exits non-zero if a run
failed.
"""

import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
TIMING = Path(__file__).resolve().parent / "timing.py"
RUNNER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("smoke_ab_timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)
sys.path.insert(0, ".")
import chip_smoke
chip_smoke.cuda_ms = lambda torch, fn, *args, **kw: timing.device_ms(fn)
sys.exit(chip_smoke.main())
"""
PATHS = {"[main path] ": "default", "[fused path] ": "fused"}
SHAPE_KEYS = ("B", "L", "H", "T", "M", "D")


def run(i, label, root):
    """One chip_smoke.py run in ``root``; its output echoed, its numbers
    returned."""
    proc = subprocess.Popen(
        [sys.executable, "-c", RUNNER, str(TIMING)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {"label": label, "paths": {}, "kernels": []}
    for line in proc.stdout:
        print(f"[run {i} {label}] {line}", end="", flush=True)
        for prefix, path in PATHS.items():
            if line.startswith(prefix):
                rec = json.loads(line[len(prefix):])
                # per target since the paths drive two; before, BPTI only
                targets = rec.get("targets", {"bpti": rec})
                out["paths"][path] = {
                    t: {k: r[k] for k in ("conformations_per_s",
                                          "ms_per_step")}
                    for t, r in targets.items()}
        if line.startswith("[kernel] "):
            name, rec = line[len("[kernel] "):].split(" ", 1)
            rec = json.loads(rec)
            out["kernels"].append({
                "name": name, **{k: rec[k] for k in SHAPE_KEYS if k in rec},
                "ms": rec["ms"], "library_ms": rec["library_ms"],
                "host_ms_per_call": rec.get("host_ms_per_call")})
    out["rc"] = proc.wait()
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    runs = [run(i, label, root) for i, (label, root) in enumerate(
        (("other", other), ("this", THIS), ("this", THIS),
         ("other", other)))]
    print(json.dumps({"other": str(other), "runs": runs}))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
