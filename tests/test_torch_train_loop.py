"""The port's trainer end to end on the CPU (tiny trunk): the
``esmdiff-torch-train`` CLI, the debug modes, resume, top-k checkpoints,
the configs both packages load alike, ``load_runtime`` and
``cli.sample --ckpt``, and what raises."""

import csv
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.convert import checkpoints, torch_ckpt
from esmdiff_tpu_torch.convert import verify as tverify
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train.loop import build_task, init_params, train
from esmdiff_tpu_torch.utils.checkpoint import CheckpointManager, load_params

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["model.size=tiny", "model.dtype=float32", "trainer.print_config=false"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("encodings")
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
    return str(root)


@pytest.fixture(scope="module")
def smoke_run(corpus, tmp_path_factory):
    """``esmdiff-torch-train --config configs/mdlm_smoke.yaml`` on the CPU
    (2 epochs of 3 steps, top 2 kept): (its result, its run directory)."""
    run = tmp_path_factory.mktemp("smoke") / "run"
    result = train_cli.main([
        "--config", str(ROOT / "configs/mdlm_smoke.yaml"), "--device", "cpu",
        f"data.path={corpus}", f"trainer.ckpt_dir={run}",
        "trainer.save_top_k=2", "trainer.print_config=false"])
    return result, run


def test_cli_trains_and_keeps_top_k(smoke_run):
    result, run = smoke_run
    assert result["steps"] == 6 and np.isfinite(result["best_val_loss"])
    index = json.loads((run / "ckpt" / "index.json").read_text())
    assert [e["step"] for e in index] and len(index) <= 2
    assert [e["metric"] for e in index] == sorted(e["metric"] for e in index)
    assert index[0]["metric"] == result["best_val_loss"]
    kept = {Path(e["path"]).name for e in index}
    assert {p.name for p in (run / "ckpt").glob("step_*")} == kept
    for e in index:
        assert {p.name for p in Path(e["path"]).iterdir()} == {
            "params.pt", "optimizer.pt", "state.json"}
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    train_rows = [r for r in rows if r["split"] == "train"]
    assert len(train_rows) == 6 and len(rows) == 8
    assert all(np.isfinite(float(r["grad_norm"])) for r in train_rows)
    assert tconfig.load_config(str(run / "config.yaml")).trainer.ckpt_dir \
        == str(run)


def test_checkpoint_manager_prunes_to_top_k(tmp_path):
    """Saves with val losses 3, 1, 2, 0.5 at top 2: the index keeps 0.5 and
    1, best first, and only their directories remain."""
    model = torch.nn.Linear(2, 2)

    class State:
        step = 0
        optimizer = type("O", (), {"adamw": torch.optim.AdamW(
            model.parameters())})()

    state = State()
    state.model = model
    mgr = CheckpointManager(tmp_path / "ckpt", save_top_k=2)
    for step, metric in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 0.5)):
        state.step = step
        mgr.save(state, step=step, metric=metric)
    index = json.loads((tmp_path / "ckpt" / "index.json").read_text())
    assert [(e["step"], e["metric"]) for e in index] == [(4, 0.5), (2, 1.0)]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "index.json", "step_2", "step_4"]
    assert mgr.best_path() == index[0]["path"]
    reopened = CheckpointManager(tmp_path / "ckpt", save_top_k=2)
    assert reopened.best_path() == index[0]["path"]


def test_resume_continues_the_step_count(smoke_run, corpus, tmp_path):
    _, run = smoke_run
    best = json.loads((run / "ckpt" / "index.json").read_text())[0]
    cfg = tconfig.load_config(None, [
        f"data.path={corpus}", "data.batch_size=2", "data.max_len=32",
        "data.bucket_multiple=16", *TINY, "model.remat=false",
        "trainer.max_epochs=1", "trainer.fast_dev_run=true",
        f"trainer.ckpt_dir={tmp_path}/run2",
        f"trainer.resume={best['path']}"])
    result = train(cfg, device="cpu")
    assert result["steps"] == best["step"] + 1


def test_fast_dev_run_with_check_nans(corpus, tmp_path):
    """fast_dev_run: one train step and one val batch; check_nans (anomaly
    detection) is on for the run and off after it."""
    cfg = tconfig.load_config(None, [
        f"data.path={corpus}", "data.batch_size=2", "data.max_len=32",
        *TINY, "trainer.fast_dev_run=true", "trainer.check_nans=true",
        f"trainer.ckpt_dir={tmp_path}/fdr"])
    result = train(cfg, device="cpu")
    assert result["steps"] == 1 and np.isfinite(result["best_val_loss"])
    assert not torch.is_anomaly_enabled()
    with open(tmp_path / "fdr" / "metrics.csv") as f:
        assert [r["split"] for r in csv.DictReader(f)] == ["train", "val"]


def test_profile_steps_write_a_trace(corpus, tmp_path):
    """profile_steps=1: local step 1 is traced (torch.profiler) into
    <ckpt_dir>/profile, with the tracer's spans of that step beside it."""
    cfg = tconfig.load_config(None, [
        f"data.path={corpus}", "data.batch_size=2", "data.max_len=32",
        *TINY, "trainer.max_epochs=1", "trainer.profile_steps=1",
        f"trainer.ckpt_dir={tmp_path}/prof"])
    assert train(cfg, device="cpu")["steps"] == 3
    trace = json.loads((tmp_path / "prof" / "profile" / "trace.json")
                       .read_text())
    assert trace["traceEvents"]
    spans = json.loads((tmp_path / "prof" / "profile" / "spans.json")
                       .read_text())
    names = [sp["name"] for sp in spans["spans"]]
    assert names.count("train.step") == 1
    assert "train.step" in {e.get("name") for e in trace["traceEvents"]}


def test_overfit_batches_lowers_the_loss(corpus, tmp_path):
    """One batch repeated for 30 epochs at lr 3e-3: the mean train loss of
    the last ten steps is under three quarters of the first ten's (each
    step draws its own diffusion times, so single steps are noisy)."""
    cfg = tconfig.load_config(None, [
        f"data.path={corpus}", "data.batch_size=2", "data.max_len=24",
        "data.bucket_multiple=8", *TINY, "model.remat=false",
        "optim.lr=3e-3", "trainer.max_epochs=30",
        "trainer.overfit_batches=1", "trainer.log_every_n_steps=1",
        "trainer.val_every_n_epochs=100",
        f"trainer.ckpt_dir={tmp_path}/overfit"])
    result = train(cfg, device="cpu")
    assert result["steps"] == 30
    with open(tmp_path / "overfit" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows if r["split"] == "train"]
    assert [r["split"] for r in rows].count("val") == 1  # epoch 0 only
    assert np.mean(losses[-10:]) < 0.75 * np.mean(losses[:10])


def _shared(cfg):
    """``asdict(cfg)`` without the port's own fields (``tconfig.
    PORT_ONLY``), which must hold their defaults: what both packages
    have."""
    tree = dataclasses.asdict(cfg)
    for (section, name), default in tconfig.PORT_ONLY.items():
        if section in tree:
            assert tree[section].pop(name, default) == default
    return tree


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_configs_load_as_in_jax(path):
    if jconfig.is_predict_config(str(path)):
        assert tconfig.is_predict_config(str(path))
        want = jconfig.load_predict_config(str(path))
        got = tconfig.load_predict_config(str(path))
    else:
        want = jconfig.load_config(str(path), ["optim.grad_clip=0.5"])
        got = tconfig.load_config(str(path), ["optim.grad_clip=0.5"])
    assert _shared(got) == _shared(want)


def test_config_yaml_crosses_packages(tmp_path):
    """A config.yaml written by either package loads in the other (the
    port's own fields at their defaults are left out of it)."""
    overrides = ["model.size=custom", "model.n_layers=3", "data.pack_len=256",
                 "trainer.resume=/x/step_4", "optim.warmup_steps=7"]
    for src, dst in ((tconfig, jconfig), (jconfig, tconfig)):
        cfg = src.load_config(str(ROOT / "configs/mdlm.yaml"), overrides)
        src.save_config(cfg, tmp_path / "config.yaml")
        back = dst.load_config(str(tmp_path / "config.yaml"))
        assert _shared(back) == _shared(cfg)


def test_load_runtime_round_trips(smoke_run):
    """The best entry (the checkpoint directory) and a step directory both
    load: the runtime's trunk and sigma embedder hold the saved float32
    parameters bit for bit."""
    _, run = smoke_run
    index = json.loads((run / "ckpt" / "index.json").read_text())
    for path, entry in ((run / "ckpt", index[0]),
                        (Path(index[-1]["path"]), index[-1])):
        rt = checkpoints.load_runtime(path, device="cpu")
        saved = load_params(entry["path"])
        own = {**{f"net.{k}": v for k, v in rt.trunk.state_dict().items()},
               **{f"sigma_embedder.{k}": v
                  for k, v in rt.sigma_embedder.state_dict().items()}}
        assert own.keys() == saved.keys()
        for k, v in saved.items():
            assert own[k].dtype == torch.float32
            assert torch.equal(own[k], v), k
        assert rt.trunk.cfg.head_type == "structure"


def test_sample_with_ckpt_writes_a_pdb(smoke_run, tmp_path):
    _, run = smoke_run
    report = sample_cli.main([
        "--ckpt", str(run / "ckpt"), "--mode", "ddpm", "--input",
        str(ROOT / "data/targets/bpti"), "--output", str(tmp_path),
        "--num_samples", "3", "--num_steps", "2", "--device", "cpu"])
    L = report[0]["L"]
    text = (tmp_path / "bpti.pdb").read_text().splitlines()
    atoms = [line for line in text if line.startswith("ATOM")]
    assert sum(line.startswith("MODEL") for line in text) == 3
    assert len(atoms) == 3 * (L * 4 - 1)
    assert all(np.isfinite(float(a[c:c + 8])) for a in atoms
               for c in (30, 38, 46))


@pytest.mark.parametrize("override,error,match", [
    ("trainer.strategy=pp2 data.pack_len=64", ValueError, "pack_len"),
    ("trainer.strategy=dp2xpp2 trainer.pp_microbatches=3", ValueError,
     "not divisible by pp_microbatches=3"),
    ("trainer.multihost=true", RuntimeError, "multihost needs torchrun"),
    ("trainer.strategy=dp2xtp2", ValueError, "needs 4 ranks"),
])
def test_unported_training_raises(corpus, tmp_path, override, error, match):
    """What the trainer refuses, as JAX's: a pp strategy with packed rows
    or a batch that does not divide by data x pp_microbatches;
    trainer.multihost without torchrun's environment and a
    tensor-parallel strategy without its ranks raise (the strategies that
    run: tests/test_torch_parallel.py, tests/test_torch_tp.py,
    tests/test_torch_pp.py)."""
    cfg = tconfig.load_config(None, [f"data.path={corpus}", *TINY,
                                     f"trainer.ckpt_dir={tmp_path}/run",
                                     *override.split()])
    with pytest.raises(error, match=match):
        train(cfg, device="cpu")
    if error is not ValueError:  # raised before anything is written
        assert not (tmp_path / "run").exists()


def _release_fixture(path):
    """A tiny ESMDiff release file (Lightning, ``net.*`` and
    ``sigma_embedder.*``): (its trunk's state dict, its sigma embedder's)."""
    trunk = tverify.make_reference_trunk_state_dict(
        esm3_tiny(head_type="structure"))
    sigma = tverify.make_reference_sigma_embedder_state_dict(64)
    torch.save(tverify.release_checkpoint(trunk, sigma), path)
    return trunk, sigma


def test_pretrained_ckpt_loads(corpus, tmp_path):
    """model.pretrained_ckpt: the trainer's init fills the trunk and the
    sigma embedder with the file's tensors."""
    trunk, sigma = _release_fixture(tmp_path / "release.ckpt")
    cfg = tconfig.load_config(None, [
        f"data.path={corpus}", *TINY, f"trainer.ckpt_dir={tmp_path}",
        f"model.pretrained_ckpt={tmp_path / 'release.ckpt'}"])
    mdlm, _ = build_task(cfg, "cpu")
    init_params(mdlm, cfg)
    rules = torch_ckpt.trunk_rules(4, 1, "structure")
    for name, value in mdlm.net.state_dict().items():
        assert torch.equal(value, trunk[rules[name]]), name
    assert torch.equal(mdlm.sigma_embedder.fc1.weight, sigma["mlp.0.weight"])


def test_unported_loading_raises(smoke_run, tmp_path):
    """A VQ-VAE directory whose ``params/`` is no orbax checkpoint (no
    ``_METADATA``) as --vqvae_ckpt, and a directory that is neither a run
    of the port nor an orbax checkpoint, raise FileNotFoundError (the JAX
    package's orbax directories load: tests/test_torch_orbax.py); an
    unknown remat_policy raises ("dots" is ported:
    tests/test_torch_train_switches.py).  A PyTorch trunk file loads: its
    trunk equals the file's."""
    _, run = smoke_run
    jax_vq = tmp_path / "jax_vqvae"
    (jax_vq / "params").mkdir(parents=True)
    (jax_vq / "vqvae.json").write_text(
        '{"encoder_cfg": {}, "decoder_cfg": {"scan_layers": true}}')
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        checkpoints.load_runtime(run / "ckpt", vqvae_ckpt=str(jax_vq),
                                 device="cpu")
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        checkpoints.load_runtime(tmp_path / "orbax", device="cpu")
    trunk, _ = _release_fixture(tmp_path / "trunk.pt")
    runtime = checkpoints.load_runtime(tmp_path / "trunk.pt", device="cpu")
    rules = torch_ckpt.trunk_rules(4, 1, "structure")
    for name, value in runtime.trunk.state_dict().items():
        assert torch.equal(value, trunk[rules[name]]), name
    with pytest.raises(ValueError, match="remat_policy"):
        ESM3(esm3_tiny(remat_policy="offload"))
