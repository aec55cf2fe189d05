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
from esmdiff_tpu_torch.cli import analyze as analyze_cli
from esmdiff_tpu_torch.cli import dump as dump_cli
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.cli import serve as serve_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.cli import train_vqvae as train_vqvae_cli
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
    assert int(res.stdout.split()[-1]) >= 88  # every module was imported


def test_serving_modules_import_without_jax():
    """The serving, sampler and encode slices' modules by name (the walk
    above covers them as well): the int8 path, packing, the server, the
    gibbs and eb samplers, refinement, geometric attention, the encoder
    and the dump CLI."""
    probe = ("import sys\nsys.modules['jax'] = None\n"
             "sys.modules['flax'] = None\n"
             "import esmdiff_tpu_torch.ops.quant, esmdiff_tpu_torch.ops.packing"
             ", esmdiff_tpu_torch.cli.serve, esmdiff_tpu_torch.ops.refine"
             ", esmdiff_tpu_torch.diffusion.gibbs"
             ", esmdiff_tpu_torch.nn.geometric, esmdiff_tpu_torch.models.vqvae"
             ", esmdiff_tpu_torch.cli.dump\n"
             "from esmdiff_tpu_torch.models.vqvae import "
             "StructureTokenEncoder, knn_graph, nearest_code\n"
             "assert not [m for m in sys.modules if m.startswith("
             "'esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_parallel_modules_import_without_jax():
    """``parallel/*`` by name (mesh, fsdp, tp, pp, ring, multihost), with
    jax, flax, optax and orbax blocked, and the distributed pieces they
    use (the rank workers of the tests import the port alone)."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.parallel.mesh"
             ", esmdiff_tpu_torch.parallel.fsdp"
             ", esmdiff_tpu_torch.parallel.tp"
             ", esmdiff_tpu_torch.parallel.pp"
             ", esmdiff_tpu_torch.parallel.ring"
             ", esmdiff_tpu_torch.parallel.multihost\n"
             "from esmdiff_tpu_torch.parallel.mesh import RowShard, "
             "init_from_env, shard_batch\n"
             "from esmdiff_tpu_torch.parallel.tp import TPGroup, "
             "shard_modules\n"
             "from esmdiff_tpu_torch.parallel.pp import Pipeline, "
             "parse_pp_strategy\n"
             "from esmdiff_tpu_torch.train.state import distribute\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_training_modules_import_without_jax():
    """The training slice's modules by name, with jax, flax, optax and
    orbax blocked: config, data, state, loop, the train CLI, the
    checkpoint manager, the metric logger, the carry-over,
    ``load_runtime``, the orbax reader and the tensor and fixture
    helpers."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.train.config"
             ", esmdiff_tpu_torch.train.data, esmdiff_tpu_torch.train.state"
             ", esmdiff_tpu_torch.train.loop, esmdiff_tpu_torch.cli.train"
             ", esmdiff_tpu_torch.utils.checkpoint"
             ", esmdiff_tpu_torch.utils.logging"
             ", esmdiff_tpu_torch.convert.checkpoints"
             ", esmdiff_tpu_torch.convert.orbax"
             ", esmdiff_tpu_torch.utils.tensor"
             ", esmdiff_tpu_torch.utils.fixtures\n"
             "from esmdiff_tpu_torch.convert import (flax_names, "
             "load_flax_params, state_dict_to_flax)\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_tokenizer_modules_import_without_jax():
    """The tokenizer slice's modules by name, with jax, flax, optax and
    orbax blocked: the VQ-VAE trainer, its CLI, the conformers, the
    checkpoints' save_vqvae/load_vqvae and the sampling CLI."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.train.vqvae"
             ", esmdiff_tpu_torch.cli.train_vqvae"
             ", esmdiff_tpu_torch.train.conformers"
             ", esmdiff_tpu_torch.cli.sample\n"
             "from esmdiff_tpu_torch.convert.checkpoints import (save_vqvae, "
             "load_vqvae, read_vqvae_json, vqvae_from_flax)\n"
             "from esmdiff_tpu_torch.train.vqvae import (VQVAE, train_vqvae, "
             "export_vqvae, restart_dead_codes, augment_batch)\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_ar_modules_import_without_jax():
    """The AR slice's modules by name, with jax, flax, optax and orbax
    blocked: the CLM, the JLM, their generation, the HF rules, the
    checkpoint loader and the AR sampling CLI."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.models.clm"
             ", esmdiff_tpu_torch.models.jlm"
             ", esmdiff_tpu_torch.api.ar_generation"
             ", esmdiff_tpu_torch.convert.ar_rules"
             ", esmdiff_tpu_torch.cli.sample_ar\n"
             "from esmdiff_tpu_torch.convert.checkpoints import "
             "load_ar_params\n"
             "from esmdiff_tpu_torch.ops.quant import quantize_named_denses\n"
             "from esmdiff_tpu_torch.train.loop import build_clm, build_jlm\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_eval_modules_import_without_jax_pandas_or_matplotlib():
    """The evaluation slice's modules by name, with jax, flax, pandas and
    matplotlib blocked: the suites, the plots module (matplotlib is
    imported only when a plot is drawn) and esmdiff-torch-analyze."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'pandas', 'matplotlib'):\n"
             "    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.eval, esmdiff_tpu_torch.eval.plots"
             ", esmdiff_tpu_torch.cli.analyze, esmdiff_tpu_torch.utils.native\n"
             "from esmdiff_tpu_torch.eval import (align, analysis, geo, "
             "metrics, tmscore)\n"
             "from esmdiff_tpu_torch.eval.plots import scatterplot_apo\n"
             "try:\n"
             "    scatterplot_apo([0.5], [0.5], 'never.png')\n"
             "except ImportError as e:\n"
             "    assert 'needs matplotlib' in str(e), e\n"
             "else:\n"
             "    raise AssertionError('drew without matplotlib')\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert not (ROOT / "never.png").exists()


def test_weights_modules_import_without_jax():
    """The reference-checkpoint slice's modules by name, with jax, flax,
    optax and orbax blocked: the converter, the verifier (its CLI), the
    function decoder, load_runtime's torch-file path and the runbook."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.convert.torch_ckpt"
             ", esmdiff_tpu_torch.convert.verify"
             ", esmdiff_tpu_torch.models.function_decoder"
             ", esmdiff_tpu_torch.tools.real_weight_day\n"
             "from esmdiff_tpu_torch.convert.checkpoints import ("
             "load_runtime, vqvae_from_reference, convert_ar)\n"
             "from esmdiff_tpu_torch.convert.verify import (main, "
             "verify_trunk, verify_vqvae_decoder, verify_vqvae_encoder, "
             "verify_function_decoder, verify_clm, verify_jlm)\n"
             "from esmdiff_tpu_torch.train.loop import load_pretrained\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_pipeline_modules_import_without_jax():
    """The data-pipeline and training slice's modules by name, with jax,
    flax, optax and orbax blocked: the mmCIF parser, the secondary
    structure, the preprocess and sweep CLIs, the MLM corruption, the AR
    tasks and the training switches."""
    probe = ("import sys\n"
             "for m in ('jax', 'flax', 'optax', 'orbax', "
             "'orbax.checkpoint'):\n    sys.modules[m] = None\n"
             "import esmdiff_tpu_torch.core.mmcif"
             ", esmdiff_tpu_torch.core.secondary_structure"
             ", esmdiff_tpu_torch.cli.preprocess"
             ", esmdiff_tpu_torch.cli.sweep\n"
             "from esmdiff_tpu_torch.diffusion.noise import (MlmDraws, "
             "get_inputs_for_mlm, sample_mask_rate)\n"
             "from esmdiff_tpu_torch.train.loop import (build_task, "
             "cast_params, init_task, task_modules)\n"
             "from esmdiff_tpu_torch.train.state import AdamW\n"
             "from esmdiff_tpu_torch.models.esm3 import remat_kwargs\n"
             "assert not [m for m in sys.modules if m == 'esmdiff_tpu' or "
             "m.startswith('esmdiff_tpu.')]\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_sweep_cli_without_device_raises(no_cuda, tmp_path):
    """esmdiff-torch-sweep runs its trials on cuda by default: without a
    card it raises before it writes anything."""
    from esmdiff_tpu_torch.cli import sweep as sweep_cli

    space = tmp_path / "space.yaml"
    space.write_text("space:\n  optim.lr: {type: uniform, low: 0.1, "
                     "high: 0.2}\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_cli.main(["--space", str(space), "--output",
                        str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


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


def test_train_cli_without_device_raises(no_cuda, tmp_path):
    """esmdiff-torch-train without --device cpu and no card raises before
    it writes or trains anything."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", str(ROOT / "configs/mdlm_smoke.yaml"),
                        f"trainer.ckpt_dir={tmp_path}/run"])
    assert not (tmp_path / "run").exists()


def test_train_vqvae_cli_without_device_raises(no_cuda, tmp_path):
    """esmdiff-torch-train-vqvae without --device cpu and no card raises
    before it reads the corpus or writes anything, with --data_parallel
    too (no gloo group stands in for the card)."""
    args = ["--input", str(ROOT / "data/targets/bpti"), "--output",
            str(tmp_path / "vq"), "--scale", "tiny", "--steps", "1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vqvae_cli.main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vqvae_cli.main([*args, "--data_parallel"])
    assert not (tmp_path / "vq").exists()


def test_analyze_cli_without_device_raises(no_cuda, tmp_path):
    """esmdiff-torch-analyze runs on cuda by default: without a card it
    raises before it reads or writes anything, unless --device cpu."""
    for task in (["bpti", "--preds", "p.pdb", "--target", "t.npy"],
                 ["apo", "--samples", "s", "--pairs-csv", "p.csv",
                  "--structures", "d"],
                 ["ped", "--preds", "p.pdb", "--targets", "d"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            analyze_cli.main([*task, "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_server_without_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--model_scale", "tiny", "--quant", "int8",
                        "--port", "0"])


def test_unported_modes_raise(tmp_path):
    """Profiling and data parallelism are ported
    (tests/test_torch_mesh_sampling.py), as is inpainting, --mask_ids and
    --filled_ids (tests/test_torch_inpaint.py).  A --ckpt that names no
    file raises rather than falling back to random weights (PyTorch trunk
    files and the port's own runs load: tests/test_torch_convert_weights.py,
    tests/test_torch_train_loop.py)."""
    with pytest.raises(FileNotFoundError, match="trunk.pt"):
        cli.main(["--output", str(tmp_path), "--model_scale", "tiny",
                  "--device", "cpu", "--ckpt", "trunk.pt"])
    with pytest.raises(FileNotFoundError, match="trunk.pt"):
        dump_cli.main([str(ROOT / "data/targets/bpti"), str(tmp_path),
                       "--ckpt", "trunk.pt", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="trunk.pt"):
        serve_cli.main(["--model_scale", "tiny", "--device", "cpu",
                        "--port", "0", "--ckpt", "trunk.pt"])
