"""The port stands alone: it imports with JAX and flax blocked, pulls in no
module of the JAX package, and its entry points refuse to run on the CPU
unless asked to."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.models.esm3 import esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import esmdiff_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    esmdiff_tpu_torch.__path__, "esmdiff_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m == "esmdiff_tpu" or m.startswith("esmdiff_tpu.")]
assert not leaked, leaked
print(len(names))
"""


def test_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 31  # every module was imported


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|esmdiff_tpu)\b")
    files = sorted((ROOT / "esmdiff_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_runtime_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ESM3Runtime.random_init(
            trunk_cfg=esm3_tiny(head_type="structure", dtype="float32"),
            decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                      dtype="float32"))


def test_cli_without_device_raises(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--input", str(ROOT / "data/targets/bpti"), "--output",
                  str(tmp_path), "--model_scale", "tiny"])
    assert not (tmp_path / "bpti.pdb").exists()


def test_unported_modes_raise(tmp_path):
    for extra in (["--mode", "gibbs"], ["--quant", "int8"],
                  ["--mask_ids", "1,2"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            cli.main(["--output", str(tmp_path), "--model_scale", "tiny",
                      "--device", "cpu", *extra])
