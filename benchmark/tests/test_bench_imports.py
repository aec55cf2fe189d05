"""The harness and the reference import with JAX, flax and the JAX package
blocked, top-level names compared whole (so ``esmdiff_tpu_torch`` is not
taken for ``esmdiff_tpu``); the reference also without the port; and no
file of the benchmark reads the JAX package's benchmark records."""

import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

BLOCK = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def run_blocked(blocked, body):
    code = BLOCK.format(blocked=set(blocked)) + body
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_imports_without_jax():
    out = run_blocked(("jax", "jaxlib", "flax", "esmdiff_tpu"), """
from pathlib import Path
from benchmark import (calibrate, counts, generator, harness, run, targets,
                       weights)
for f in sorted(Path("benchmark/runners").glob("*.py")):
    harness.load_file(f, "d_" + f.stem)
for f in sorted(Path("benchmark/metrics").glob("*.py")):
    harness.load_file(f, "m_" + f.stem.replace(".", "_"))
import esmdiff_tpu_torch.api.generation, esmdiff_tpu_torch.train.loop
print(sorted(m for m in sys.modules if m.split(".")[0] == "esmdiff_tpu_torch")[:1])
print(harness.forbidden_loaded())
""")
    assert "esmdiff_tpu_torch" in out
    assert out.strip().endswith("[]")


def test_reference_imports_without_the_port():
    out = run_blocked(
        ("jax", "jaxlib", "flax", "esmdiff_tpu", "esmdiff_tpu_torch"), """
from benchmark.reference import model, sampler, train
from benchmark import counts, weights
print("ok")
""")
    assert out.strip() == "ok"


def test_nothing_reads_the_jax_benchmark_records():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("bench.py", "BENCH_r", "MULTICHIP", "BASELINE.json",
                     "BENCH_RUN"):
            assert word not in text, (path, word)
