"""The port's AR sampling CLI (``esmdiff-torch-sample-ar``,
``esmdiff_tpu_torch/cli/sample_ar.py``) on the CPU: tiny CLM and JLM runs
writing an n-MODEL PDB, ``--quant int8``, the config precedence of the JAX
CLI, the geometry of ``configs/clm.yaml`` and ``configs/jlm.yaml`` against
JAX's ``build_clm``/``build_jlm`` (parameter counts, on no device), the
model-type inference, the sequence tokens against JAX's ``encode``,
``--runtime_ckpt`` with ``--vqvae_ckpt`` on the port's own tiny runs, and
what exits or raises."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.api.protein_api import ESMProtein as JProtein
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu_torch.cli import sample_ar as cli
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.ops.quant import QuantDense
from test_torch_vqvae_cli import (_assert_holds_export, _captured_runtime,
                                  mdlm_run, vq_export)  # noqa: F401

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BPTI = ROOT / "data/targets/bpti"


def _check_pdb(path: Path, n: int, L: int = 58):
    ens = protein_io.from_pdb_file(path)
    assert len(ens) == n
    for p in ens:
        assert p.atom_positions.shape[0] == L
        assert np.isfinite(p.atom_positions[p.atom_mask > 0]).all()
    text = path.read_text()
    assert text.count("\nMODEL") + text.startswith("MODEL") == n
    assert sum(line.startswith("ATOM") for line in text.splitlines()) == \
        n * (L * 4 - 1)


@pytest.mark.parametrize("model_type", ["clm", "jlm"])
def test_tiny_writes_n_model_pdb(model_type, tmp_path):
    report = cli.main(["--input", str(BPTI), "--output", str(tmp_path),
                       "--model_type", model_type, "--model_scale", "tiny",
                       "--n_samples", "3", "--batch_size", "2",
                       "--device", "cpu"])
    _check_pdb(tmp_path / "bpti.pdb", 3)
    (r,) = report
    assert (r["target"], r["L"], r["model_type"], r["batches"]) == \
        ("bpti", 58, model_type, 2)
    assert r["total_sec"] >= r["trunk_sec"] + r["ar_sec"]


def _tiny_runtime():
    """The runtime of ``--model_scale tiny`` (seed 0) on the CPU."""
    return cli.build_runtime(cli.get_argparser().parse_args(
        ["--model_scale", "tiny", "--device", "cpu"]))


def test_quant_int8(tmp_path, capsys):
    runtime = _tiny_runtime()
    for model_type in ("clm", "jlm"):
        cli.main(["--input", str(BPTI), "--output", str(tmp_path / model_type),
                  "--model_type", model_type, "--model_scale", "tiny",
                  "--n_samples", "2", "--quant", "int8", "--device", "cpu"],
                 runtime=runtime)
        _check_pdb(tmp_path / model_type / "bpti.pdb", 2)
    assert capsys.readouterr().out.count("W8A8 int8") == 2
    args = cli.get_argparser().parse_args(["--model_scale", "tiny",
                                           "--quant", "int8"])
    for model_type in ("clm", "jlm"):
        model = cli.prepare_model(
            cli.build_model(args, model_type, None, 64, "cpu"), args)
        quant = [m for m in model.modules() if isinstance(m, QuantDense)]
        # CLM: q/k/v/o x (enc self, dec self, dec cross) + 3 FFN a block;
        # JLM: qkv, attn_out, mlp_up, mlp_down a block
        assert len(quant) == (2 * 7 + 2 * 11 if model_type == "clm"
                              else 2 * 4)


def _args(argv):
    parser = cli.get_argparser()
    args = parser.parse_args(argv)
    return args, cli.resolve_config(args, parser)


def test_predict_config_defaults_and_explicit_flags_win(tmp_path):
    args, train_cfg = _args(["--config", str(ROOT / "configs/predict.yaml"),
                             "--top_p", "0.8", "--output", str(tmp_path)])
    assert train_cfg is None
    assert (args.input, args.batch_size, args.n_samples, args.temperature,
            args.seed) == ("data/targets/bpti", 32, 100, 1.0, 0)
    assert (args.top_p, args.output) == (0.8, str(tmp_path))
    assert cli.infer_model_type(args, train_cfg) == "clm"
    pred = tmp_path / "predict.yaml"
    pred.write_text(
        "task_name: predict\nseed: 5\nmodel_type: null\n"
        f"train_config: {ROOT / 'configs/jlm.yaml'}\n"
        "inference:\n  n_samples: 7\n  batch_size: 3\n  temperature: 1.2\n")
    args, train_cfg = _args(["--config", str(pred), "--n_samples", "4"])
    assert (args.n_samples, args.batch_size, args.temperature, args.seed) == \
        (4, 3, 1.2, 5)
    assert train_cfg.task_name == "jlm"
    assert cli.infer_model_type(args, train_cfg) == "jlm"


@pytest.mark.parametrize("model_type", ["clm", "jlm"])
def test_training_config_rebuilds_jax_geometry(model_type):
    """--config configs/<type>.yaml: the same net as JAX's build_<type>,
    counted parameter for parameter (no weights made: JAX traces shapes,
    the port builds on the meta device)."""
    yaml = str(ROOT / f"configs/{model_type}.yaml")
    args, train_cfg = _args(["--config", yaml])
    assert cli.infer_model_type(args, train_cfg) == model_type
    model = cli.build_model(args, model_type, train_cfg, 1536, "meta")
    n_port = sum(p.numel() for p in model.parameters())
    jcfg = jconfig.load_config(yaml)
    jmodel = (jloop.build_clm if model_type == "clm"
              else jloop.build_jlm)(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 1536)),
                            jnp.zeros((1, 8), jnp.int32))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    assert n_port == n_jax
    assert (n_port / 1e6) == pytest.approx(
        {"clm": 437, "jlm": 961}[model_type], rel=0.01)
    assert model.cfg.dtype == "bfloat16"


def test_model_type_inference_from_path():
    def infer(*argv):
        args, train_cfg = _args(list(argv))
        return cli.infer_model_type(args, train_cfg)

    assert infer() == "clm"
    assert infer("--ckpt", "runs/JLM_best.ckpt") == "jlm"
    assert infer("--ckpt", "runs/clm-jlm.pt") == "clm"   # clm checked first
    assert infer("--ckpt", "runs/jlm.pt", "--model_type", "clm") == "clm"
    assert infer("--config", str(ROOT / "configs/jlm.yaml"),
                 "--ckpt", "clm.pt") == "jlm"


def test_sequence_tokens_match_jax_encode():
    """The port tokenizes the sequence alone where JAX runs its runtime's
    whole encode (structure encoder included) for it."""
    jrt = JRuntime.random_init(
        trunk_cfg=jesm3_tiny(dtype="float32"),
        encoder_cfg=JEncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                   n_layers=2, d_out=16, knn=8),
        decoder_cfg=JDecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                   dtype="float32", scan_layers=False),
        with_sigma_embedder=False)
    port = _tiny_runtime()
    for path in (BPTI / "bpti.pdb", ROOT / "data/targets/apo/1jm4.B.pdb"):
        seq = JProtein.from_pdb(path).sequence
        np.testing.assert_array_equal(
            port.seq_tokenizer.encode(seq),
            jrt.encode(JProtein.from_pdb(path)).sequence)


def test_runtime_and_vqvae_ckpt(vq_export, mdlm_run, tmp_path,  # noqa: F811
                                monkeypatch):
    """--runtime_ckpt (the port's tiny MDLM run) with --vqvae_ckpt (its
    tiny tokenizer export; the runtime holds it bit for bit) and a tiny
    CLM geometry from --config."""
    _, export = vq_export
    loaded = _captured_runtime(monkeypatch)
    cfg = tmp_path / "clm_tiny.yaml"
    cfg.write_text("task_name: clm\nmodel:\n  clm:\n    d_model: 32\n"
                   "    d_ff: 64\n    n_layers: 2\n    n_heads: 4\n"
                   "    dtype: float32\n")
    out = tmp_path / "out"
    (r,) = cli.main(["--runtime_ckpt", str(mdlm_run), "--vqvae_ckpt",
                     str(export), "--config", str(cfg), "--input", str(BPTI),
                     "--output", str(out), "--n_samples", "2",
                     "--device", "cpu"])
    _check_pdb(out / "bpti.pdb", 2)
    _assert_holds_export(loaded[0], export)
    assert r["model_type"] == "clm"


def test_vqvae_ckpt_alone_exits(tmp_path):
    with pytest.raises(SystemExit, match="needs --runtime_ckpt"):
        cli.main(["--vqvae_ckpt", str(tmp_path), "--output", str(tmp_path),
                  "--model_scale", "tiny", "--device", "cpu"])


def test_orbax_directories_raise_not_ported(tmp_path):
    """A directory that is neither a run of the port nor an orbax
    checkpoint (no ``_METADATA``) raises for --ckpt and --runtime_ckpt
    (the JAX package's orbax runs load: tests/test_torch_orbax.py)."""
    orbax = tmp_path / "orbax_run"
    (orbax / "params").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        cli.main(["--ckpt", str(orbax), "--output", str(tmp_path / "o"),
                  "--model_scale", "tiny", "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        cli.main(["--runtime_ckpt", str(orbax), "--output",
                  str(tmp_path / "o"), "--device", "cpu"])


def test_without_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--output", str(tmp_path / "o"), "--model_scale", "tiny"])
    assert not (tmp_path / "o").exists()
