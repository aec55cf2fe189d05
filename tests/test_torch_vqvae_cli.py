"""The port's tokenizer CLI and ``--vqvae_ckpt`` on the CPU, and the
sampling CLI's output directories for several ``--input`` directories
against the JAX package's CLI.

``esmdiff-torch-train-vqvae --scale tiny`` trains on six small chains and
exports; the sampling CLI (and the server's ``build_runtime``) pairs the
export with a tiny MDLM run of ``configs/mdlm_smoke.yaml``: the runtime's
encoder and decoder hold the saved tensors bit for bit and the PDB is
finite.  ``--vqvae_ckpt`` without ``--ckpt`` exits; a ``vqvae.json`` as
the JAX package writes it loads its geometry; a ``params/`` that is no
orbax checkpoint raises (the JAX package's load:
tests/test_torch_orbax.py)."""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.cli import sample as jax_sample_cli
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.cli import serve as serve_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.cli import train_vqvae as vq_cli
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.utils.checkpoint import load_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BPTI = ROOT / "data/targets/bpti"
SMALL_APO = ("1bv2.A", "1gh1.A", "1lip.A", "1skt.A", "2cg7.A")


@pytest.fixture(scope="module")
def vq_export(tmp_path_factory):
    """``esmdiff-torch-train-vqvae --scale tiny --steps 3`` on BPTI and
    five small apo chains: (its summary, the export directory)."""
    root = tmp_path_factory.mktemp("vq")
    chains = root / "chains"
    chains.mkdir()
    shutil.copy(BPTI / "bpti.pdb", chains)
    for name in SMALL_APO:
        shutil.copy(ROOT / "data/targets/apo" / f"{name}.pdb", chains)
    out = root / "export"
    summary = vq_cli.main([
        "--input", str(chains), "--output", str(out), "--scale", "tiny",
        "--steps", "3", "--batch", "4", "--restart_every", "2",
        "--augment", "--device", "cpu"])
    return summary, out


@pytest.fixture(scope="module")
def mdlm_run(tmp_path_factory):
    """One epoch of ``configs/mdlm_smoke.yaml`` on a random-token corpus
    (8 chains of 20-69 residues): the checkpoint directory."""
    root = tmp_path_factory.mktemp("mdlm")
    rng = np.random.RandomState(0)
    for i in range(8):
        L = rng.randint(20, 70)
        np.savez(root / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32))
    run = root / "run"
    train_cli.main(["--config", str(ROOT / "configs/mdlm_smoke.yaml"),
                    "--device", "cpu", f"data.path={root}",
                    f"trainer.ckpt_dir={run}", "trainer.max_epochs=1",
                    "trainer.print_config=false"])
    return run / "ckpt"


def test_train_vqvae_cli_exports(vq_export):
    summary, out = vq_export
    assert summary["n_structures"] == 6 and summary["steps"] == 3
    assert np.isfinite(summary["final_loss"])
    assert 0 < summary["n_live_codes"] <= summary["n_codes"] == 256
    assert json.loads((out / "train_summary.json").read_text()) == summary
    assert {p.name for p in out.iterdir()} == {
        "params.pt", "vqvae.json", "train_summary.json"}
    enc_cfg, _, dec_cfg, dec = checkpoints.load_vqvae(out)
    assert (enc_cfg, dec_cfg) == vq_cli._geometry("tiny")
    assert dec["embed.weight"].shape == (C.STRUCTURE_VOCAB_SIZE, 96)
    assert dec["embed.weight"][256:C.VQVAE_CODEBOOK_SIZE].abs().sum() == 0


def _captured_runtime(monkeypatch):
    loaded = []
    orig = checkpoints.load_runtime

    def load(*args, **kwargs):
        loaded.append(orig(*args, **kwargs))
        return loaded[-1]

    monkeypatch.setattr(checkpoints, "load_runtime", load)
    return loaded


def _assert_holds_export(runtime, export):
    saved = load_params(export)
    own = {**{f"encoder.{k}": v
              for k, v in runtime.encoder.state_dict().items()},
           **{f"decoder.{k}": v
              for k, v in runtime.decoder.state_dict().items()}}
    assert own.keys() == saved.keys()
    for k, v in saved.items():
        assert own[k].dtype == torch.float32 and torch.equal(own[k], v), k


def test_sample_with_vqvae_ckpt(vq_export, mdlm_run, tmp_path, monkeypatch):
    _, export = vq_export
    loaded = _captured_runtime(monkeypatch)
    report = sample_cli.main([
        "--ckpt", str(mdlm_run), "--vqvae_ckpt", str(export), "--mode",
        "ddpm", "--input", str(BPTI), "--output", str(tmp_path),
        "--num_steps", "2", "--num_samples", "2", "--model_scale", "tiny",
        "--device", "cpu"])
    _assert_holds_export(loaded[0], export)
    ens = protein_io.from_pdb_file(tmp_path / "bpti.pdb")
    assert len(ens) == 2 and report[0]["L"] == 58
    assert all(np.isfinite(p.atom_positions[p.atom_mask > 0]).all()
               for p in ens)


def test_serve_builds_with_vqvae_ckpt(vq_export, mdlm_run):
    """The server builds its runtime through the sampling CLI's
    ``build_runtime``, so its --vqvae_ckpt is the same."""
    _, export = vq_export
    args = serve_cli.get_argparser().parse_args([
        "--ckpt", str(mdlm_run), "--vqvae_ckpt", str(export), "--mode",
        "ddpm", "--device", "cpu", "--port", "0"])
    _assert_holds_export(sample_cli.build_runtime(args), export)


def test_vqvae_ckpt_without_ckpt_exits(vq_export, tmp_path):
    _, export = vq_export
    with pytest.raises(SystemExit, match="needs --ckpt"):
        sample_cli.main(["--vqvae_ckpt", str(export), "--input", str(BPTI),
                         "--output", str(tmp_path), "--model_scale", "tiny",
                         "--device", "cpu"])
    assert not (tmp_path / "bpti.pdb").exists()


def test_jax_vqvae_json_loads_geometry(tmp_path):
    """``vqvae.json`` as the JAX package's ``save_vqvae`` writes it
    (``dataclasses.asdict`` of its configs, ``scan_layers`` included):
    the same geometry; a ``params/`` without orbax's ``_METADATA``
    raises."""
    for enc_kw, dec_kw in ((dict(), dict(predict_ptm=False, remat=True)),
                           (dict(d_model=64, n_heads=2, v_heads=8, d_out=16,
                                 n_codes=256, knn=8),
                            dict(d_model=96, n_heads=4, n_layers=3,
                                 dtype="float32", scan_layers=False))):
        jenc, jdec = JEncoderConfig(**enc_kw), JDecoderConfig(**dec_kw)
        (tmp_path / "vqvae.json").write_text(json.dumps({
            "encoder_cfg": dataclasses.asdict(jenc),
            "decoder_cfg": dataclasses.asdict(jdec)}, indent=2))
        enc_cfg, dec_cfg = checkpoints.read_vqvae_json(tmp_path /
                                                       "vqvae.json")
        assert dataclasses.asdict(enc_cfg) == dataclasses.asdict(jenc)
        want = dataclasses.asdict(jdec)
        want.pop("scan_layers")
        assert dataclasses.asdict(dec_cfg) == want
    (tmp_path / "params").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        checkpoints.load_vqvae(tmp_path)


def _tree(out: Path) -> set:
    return {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}


def test_multi_input_same_basename_matches_jax(tmp_path):
    """``--input a/targets b/targets`` (each holding bpti.pdb), tiny, 2
    ddpm steps, through both CLIs: the same output tree (``a--targets/``,
    ``b--targets/``) and the same timings.json keys; a --skip_existing
    resume over a report row that has no ``key`` (an earlier format)
    merges it, keyed by its target."""
    dirs = []
    for parent in ("a", "b"):
        d = tmp_path / "in" / parent / "targets"
        d.mkdir(parents=True)
        shutil.copy(BPTI / "bpti.pdb", d)
        dirs.append(str(d))
    common = ["--input", *dirs, "--mode", "ddpm", "--num_steps", "2",
              "--num_samples", "1", "--model_scale", "tiny"]
    outs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    jax_sample_cli.main([*common, "--output", str(outs["jax"])])
    sample_cli.main([*common, "--output", str(outs["port"]), "--device",
                     "cpu"])
    want = {"a--targets/bpti.pdb", "b--targets/bpti.pdb", "timings.json"}
    assert _tree(outs["jax"]) == _tree(outs["port"]) == want
    keys = {name: sorted(r["key"] for r in json.loads(
        (out / "timings.json").read_text())) for name, out in outs.items()}
    assert keys["jax"] == keys["port"] == ["a--targets/bpti",
                                           "b--targets/bpti"]

    out = outs["port"]
    (out / "b--targets" / "bpti.pdb").unlink()
    (out / "timings.json").write_text(json.dumps(
        [{"target": "old", "L": 10}]))
    sample_cli.main([*common, "--output", str(out), "--device", "cpu",
                     "--skip_existing"])
    rows = json.loads((out / "timings.json").read_text())
    assert sorted(r["key"] for r in rows) == ["b--targets/bpti", "old"]
    assert _tree(out) == want
