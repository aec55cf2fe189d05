"""The port's CLM and JLM training against the JAX package's, on the CPU at
tiny width in float32: the task losses and their metrics on one batch
(1e-5), three AdamW steps (losses and every parameter, 1e-5), the AR
checks of ``train()`` (the same errors as JAX's), and the pipeline dump ->
``esmdiff-torch-train`` -> ``esmdiff-torch-sample-ar --ckpt <run>`` ->
``esmdiff-torch-analyze ped``, as tests/test_train_ar.py runs JAX's."""

import csv
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu.train import data as jdata
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu.train import state as jstate
from esmdiff_tpu_torch.cli import analyze as analyze_cli
from esmdiff_tpu_torch.cli import dump as dump_cli
from esmdiff_tpu_torch.cli import sample_ar as sample_ar_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.convert import checkpoints, state_dict_to_flax
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import data as tdata
from esmdiff_tpu_torch.train import loop as tloop
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.utils.checkpoint import load_params
from test_torch_support import carry, perturb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
COND = 48
TOL = dict(rtol=1e-5, atol=1e-5)
GEOM = {
    "clm": ["model.clm.d_model=32", "model.clm.d_ff=64",
            "model.clm.n_layers=2", "model.clm.n_heads=4",
            "model.clm.dtype=float32"],
    "jlm": ["model.jlm.n_embd=32", "model.jlm.n_layers=2",
            "model.jlm.n_heads=4", "model.jlm.struct_embed_dim=16",
            "model.jlm.n_positions=256", "model.jlm.dtype=float32"],
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A dump with embeddings: 10 chains of 12-40 residues (BOS/EOS),
    embeddings of width COND."""
    root = tmp_path_factory.mktemp("encodings")
    rng = np.random.RandomState(0)
    for i in range(10):
        L = rng.randint(12, 41)
        np.savez(root / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32),
                 embeddings=rng.randn(L + 2, COND).astype(np.float32))
    return str(root)


def _overrides(task, corpus, run="/unused", extra=()):
    return [f"task_name={task}", f"data.path={corpus}", "data.batch_size=3",
            "data.bucket_multiple=16", "data.with_embeddings=true",
            "optim.lr=1e-3", f"trainer.ckpt_dir={run}",
            "trainer.print_config=false", *GEOM[task], *extra]


def _first_batch(cfg_module, data_module, overrides):
    cfg = cfg_module.load_config(None, overrides)
    split, _ = data_module.train_val_split(
        data_module.EncodingDataset(cfg.data), cfg.data)
    return cfg, next(data_module.batches(split, cfg.data, shuffle=True,
                                         seed=cfg.seed))


def _pair(task, corpus):
    """(JAX loss, perturbed JAX params, port model carrying them, port
    loss, the numpy batch, the port batch)."""
    jcfg, batch = _first_batch(jconfig, jdata, _overrides(task, corpus))
    tcfg, tbatch = _first_batch(tconfig, tdata, _overrides(task, corpus))
    for k in batch:
        np.testing.assert_array_equal(batch[k], tbatch[k])
    jloss, init_fn = jloop.build_task(jcfg, emb_dim=COND)
    params = perturb(init_fn(), 3, 0.05)
    model, tloss = tloop.build_task(tcfg, "cpu", emb_dim=COND)
    carry(model, params)
    return jloss, params, model, tloss, batch, tloop.to_device(tbatch, "cpu")


@pytest.mark.parametrize("task", ["clm", "jlm"])
def test_loss_and_metrics_equal_jax(corpus, task):
    jloss, params, _, tloss, batch, tbatch = _pair(task, corpus)
    want, wbd = jax.jit(lambda p, b: jloss(p, b, None))(params, batch)
    got, gbd = tloss(tbatch, None)
    assert sorted(gbd) == sorted(wbd)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for k in wbd:
        np.testing.assert_allclose(gbd[k].item(), float(wbd[k]), **TOL,
                                   err_msg=k)
    if task == "clm":
        assert gbd["nll"].item() == got.item()


@pytest.mark.parametrize("task", ["clm", "jlm"])
def test_three_steps_equal_jax(corpus, task):
    """Three AdamW steps (lr 1e-3, decay 0.01, clip 1.0) of the JAX train
    step and of the port's on the first three batches: losses, metrics
    and gradient norms at each step, every parameter after the last at
    1e-5, but the elements whose JAX gradient at some step is at rounding
    level (within 1e-5 of its leaf's largest: the key biases, whose exact
    gradient is 0, a gated unit near zero), each within 2 x lr x 3: Adam
    divides a gradient by its own magnitude plus eps, so there the two
    packages' roundings move the element by up to an lr a step."""
    jloss, params, model, tloss, _, _ = _pair(task, corpus)
    extra = ["optim.grad_clip=1.0"]
    jcfg = jconfig.load_config(None, _overrides(task, corpus, extra=extra))
    kw = dict(lr=jcfg.optim.lr, weight_decay=jcfg.optim.weight_decay,
              grad_clip=jcfg.optim.grad_clip)
    opt = jstate.make_optimizer(**kw)
    jstep = jstate.make_train_step(lambda p, b, k: jloss(p, b, k), opt,
                                   donate=False)
    jst = jstate.create_train_state(params, opt)
    tst = tstate.create_train_state(
        model, tstate.make_optimizer(model.parameters(), **kw))
    split, _ = jdata.train_val_split(jdata.EncodingDataset(jcfg.data),
                                     jcfg.data)
    batches = jdata.batches(split, jcfg.data, shuffle=True, seed=jcfg.seed)
    grad = jax.jit(jax.grad(lambda p, b: jloss(p, b, None)[0]))
    noise = jax.tree.map(lambda x: np.zeros(x.shape, bool), params)
    for i in range(3):
        batch = next(batches)
        noise = jax.tree.map(
            lambda n, g: n | (np.abs(g) <= 1e-5 * np.abs(g).max()),
            noise, jax.device_get(grad(jst.params, batch)))
        jst, jm = jstep(jst, batch, jax.random.PRNGKey(i))
        tm = tstate.train_step(tst, tloss, tloop.to_device(batch, "cpu"),
                               None)
        for k in jm:
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), **TOL,
                                       err_msg=f"step {i} {k}")
    want = jax.device_get(jst.params)
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(model.state_dict(), want)))
    noise = dict(jax.tree_util.tree_leaves_with_path(noise))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g, n = got[path], noise[path]
        np.testing.assert_allclose(g[~n], w[~n], **TOL, err_msg=str(path))
        assert (np.abs(g[n] - w[n]) <= 2 * kw["lr"] * 3).all(), path


@pytest.mark.parametrize("case", ["pack_len", "no_embeddings"])
def test_ar_checks_raise_as_jax(corpus, tmp_path, case):
    """data.pack_len > 0 and a dump without embeddings raise JAX's
    ValueErrors, in both packages; the trainer forces with_embeddings."""
    if case == "pack_len":
        path, extra = corpus, ["data.pack_len=64"]
    else:
        path, extra = tmp_path / "plain", []
        path.mkdir()
        for f in sorted(Path(corpus).glob("*.npz")):
            with np.load(f) as z:
                np.savez(path / f.name, sequence_tokens=z["sequence_tokens"],
                         structure_tokens=z["structure_tokens"])
    errors = []
    for cfg_mod, train in ((jconfig, jloop.train),
                           (tconfig, lambda c: tloop.train(c, "cpu"))):
        ov = _overrides("clm", path, tmp_path / "run", extra)
        ov.remove("data.with_embeddings=true")
        cfg = cfg_mod.load_config(None, ov)
        with pytest.raises(ValueError) as err:
            train(cfg)
        errors.append(str(err.value))
        assert cfg.data.with_embeddings
    assert errors[0] == errors[1]
    assert ("MDLM-only" if case == "pack_len" else "--with_embeddings") \
        in errors[1]


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """esmdiff-torch-dump --with_embeddings over three copies of BPTI
    (tiny runtime, D 64)."""
    pdbs = tmp_path_factory.mktemp("pdbs")
    text = (ROOT / "data/targets/bpti/bpti.pdb").read_text()
    for name in ("bpti_a", "bpti_b", "bpti_c"):
        (pdbs / f"{name}.pdb").write_text(text)
    enc = tmp_path_factory.mktemp("dumped")
    assert dump_cli.main([str(pdbs), str(enc), "--with_embeddings",
                          "--model_scale", "tiny", "--device", "cpu"]) == 3
    return enc


@pytest.mark.parametrize("task", ["clm", "jlm"])
def test_dump_train_sample_analyze(dumped, tmp_path, task):
    """The reference story per AR head: train 2 epochs through the CLI
    (metrics.csv with JAX's columns), sample BPTI through
    esmdiff-torch-sample-ar --config <the run's config.yaml> --ckpt <the
    run> (every tensor equal to the run's; no special token), then
    esmdiff-torch-analyze ped on the written ensemble (finite)."""
    run = tmp_path / f"{task}_run"
    result = train_cli.main([
        "--device", "cpu", f"task_name={task}", f"data.path={dumped}",
        "data.batch_size=2", "data.max_len=32", "data.bucket_multiple=16",
        "optim.lr=1e-3", "trainer.max_epochs=2",
        "trainer.log_every_n_steps=1", f"trainer.ckpt_dir={run}",
        "trainer.print_config=false", *GEOM[task]])
    assert np.isfinite(result["best_val_loss"]) and result["steps"] > 0
    with open(run / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    cols = {"clm": {"nll"},
            "jlm": {"seq_nll", "str_nll", "seq_acc", "str_acc"}}[task]
    train_rows = [r for r in rows if r["split"] == "train"]
    assert train_rows and all(cols <= set(r) and r["nll" if task == "clm"
                                                    else "seq_nll"]
                              for r in train_rows)
    step_dir = json.loads((run / "ckpt" / "index.json").read_text())[0]
    saved = load_params(step_dir["path"])

    loaded = []
    orig = checkpoints.load_ar_params

    def record(path, model):
        out = orig(path, model)
        loaded.append({k: v.clone() for k, v in out.state_dict().items()})
        return out

    checkpoints.load_ar_params = record
    try:
        sample_ar_cli.main([
            "--config", str(run / "config.yaml"), "--ckpt", str(run),
            "--input", str(ROOT / "data/targets/bpti"), "--output",
            str(tmp_path / "ens"), "--n_samples", "3", "--batch_size", "2",
            "--model_scale", "tiny", "--device", "cpu"])
    finally:
        checkpoints.load_ar_params = orig
    assert loaded[0].keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(loaded[0][k], v), k
    pdb = (tmp_path / "ens" / "bpti.pdb").read_text()
    assert pdb.count("MODEL") == 3
    analyze_cli.main([
        "ped", "--preds", str(tmp_path / "ens" / "bpti.pdb"), "--targets",
        str(ROOT / "data/targets/bpti"), "--output", str(tmp_path / "ped"),
        "--device", "cpu"])
    out = json.loads((tmp_path / "ped" / "ped_metrics.json").read_text())
    assert out.pop("name") == ["bpti"]
    values = [v for vs in out.values() for v in np.ravel(vs)]
    assert values and np.isfinite(np.asarray(values, float)).all()


def test_sample_ar_ckpt_shape_mismatch_names_the_keys(dumped, tmp_path):
    """A run trained at one geometry, sampled with a config of another:
    the load raises, naming the keys of another shape."""
    run = tmp_path / "clm_run"
    train_cli.main([
        "--device", "cpu", "task_name=clm", f"data.path={dumped}",
        "data.batch_size=2", "trainer.max_epochs=1",
        f"trainer.ckpt_dir={run}", "trainer.print_config=false",
        *GEOM["clm"]])
    wide = tconfig.load_config(None, ["task_name=clm", *GEOM["clm"],
                                      "model.clm.d_ff=96"])
    tconfig.save_config(wide, tmp_path / "wide.yaml")
    with pytest.raises(ValueError, match="of another shape.*ff"):
        sample_ar_cli.main([
            "--config", str(tmp_path / "wide.yaml"), "--ckpt",
            str(run / "ckpt"), "--input", str(ROOT / "data/targets/bpti"),
            "--output", str(tmp_path / "o"), "--n_samples", "1",
            "--model_scale", "tiny", "--device", "cpu"])
    step = json.loads((run / "ckpt" / "index.json").read_text())[0]["path"]
    model = tloop.build_clm(tconfig.load_config(str(run / "config.yaml")),
                            "cpu", cond_dim=64)
    checkpoints.load_ar_params(step, model)       # a step directory loads
    for k, v in load_params(step).items():
        assert torch.equal(model.state_dict()[k], v), k
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax.*not ported"):
        checkpoints.load_ar_params(tmp_path / "orbax", model)
