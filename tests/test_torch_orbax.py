"""The JAX package's orbax checkpoints on the port (``convert/orbax.py``
through ``convert/checkpoints.py``): the JAX package writes them here (its
``CheckpointManager`` over a tiny ``mdlm_smoke`` state, ``save_vqvae`` with
the decoder's layers scanned, a CLM and a JLM TrainState in a run and bare
params, a zarr3 tree); the port's ``load_runtime``, ``load_vqvae`` and
``load_ar_params`` give parameters equal, bit for bit, to
``load_flax_params`` of the trees JAX's own loaders restore; ddpm sampling
from the loaded run gives JAX's tokens (its draws carried over); the
reader runs with jax, flax, optax and orbax blocked, and without
tensorstore raises naming it."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.convert import checkpoints as jck
from esmdiff_tpu.diffusion import mdlm as jmdlm
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu.train import state as jstate
from esmdiff_tpu.utils.checkpoint import CheckpointManager as JCheckpoints
from esmdiff_tpu_torch.convert import (checkpoints, flax_to_state_dict,
                                       load_flax_params, orbax)
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.diffusion.mdlm import MDLM
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import loop as tloop
from test_torch_support import jax_ddpm_draws, perturb, to_np
from test_torch_train_ar import COND, _overrides

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs/mdlm_smoke.yaml")
VQ = dict(enc=dict(d_model=32, n_heads=2, v_heads=4, n_layers=2, d_out=8,
                   n_codes=64, knn=8),
          dec=dict(d_model=32, n_heads=2, n_layers=3, dtype="float32",
                   scan_layers=True))

_BLOCKED = """
import sys, torch
for m in ("jax", "flax", "optax", "orbax", "orbax.checkpoint"):
    sys.modules[m] = None
from esmdiff_tpu_torch.convert import checkpoints
from esmdiff_tpu_torch.train import config, loop
run, vq, ar, out = sys.argv[1:]
rt = checkpoints.load_runtime(run, device="cpu")
enc_cfg, enc, dec_cfg, dec = checkpoints.load_vqvae(vq)
cfg = config.load_config(ar + "/config.yaml")
model = loop.build_clm(cfg, "cpu", cond_dim=%d)
checkpoints.load_ar_params(ar, model)
torch.save({"trunk": rt.trunk.state_dict(),
            "sigma": rt.sigma_embedder.state_dict(), "encoder": enc,
            "decoder": dec, "clm": model.state_dict()}, out)
assert not [m for m, mod in sys.modules.items() if mod is not None and (
    m == "esmdiff_tpu" or m.startswith("esmdiff_tpu.")
    or m.split(".")[0] in ("jax", "flax", "optax", "orbax"))]
""" % COND


def _as_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            flax_to_state_dict(jax.device_get(tree)).items()}


def _assert_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX package's checkpoints: an mdlm_smoke run (2 steps kept),
    a VQ-VAE directory, a CLM run, a bare JLM params directory."""
    tmp = tmp_path_factory.mktemp("orbax")
    cfg = jconfig.load_config(SMOKE, [f"trainer.ckpt_dir={tmp / 'run'}"])
    (tmp / "run").mkdir()
    jconfig.save_config(cfg, tmp / "run" / "config.yaml")
    mdlm = jloop.build_mdlm(cfg)
    params = mdlm.init(jax.random.PRNGKey(0))
    params = {"net": perturb(params["net"], 1, 0.05),
              "sigma_embedder": perturb(params["sigma_embedder"], 2, 0.05)}
    opt = jstate.make_optimizer(
        lr=cfg.optim.lr, weight_decay=cfg.optim.weight_decay,
        warmup_steps=cfg.optim.warmup_steps, grad_clip=cfg.optim.grad_clip)
    manager = JCheckpoints(tmp / "run" / "ckpt", save_top_k=2)
    state = jstate.create_train_state(params, opt)
    manager.save(state, step=2, metric=2.0)
    manager.save(jstate.TrainState(
        step=state.step, params=jax.tree.map(lambda a: a * 0.5, params),
        opt_state=state.opt_state), step=4, metric=1.0)

    enc_cfg = JEncoderConfig(**VQ["enc"])
    dec_cfg = JDecoderConfig(**VQ["dec"])
    jrt = JRuntime.random_init(trunk_cfg=mdlm.net.cfg, encoder_cfg=enc_cfg,
                               decoder_cfg=dec_cfg)
    jck.save_vqvae(tmp / "vq", enc_cfg, jrt.encoder_params, dec_cfg,
                   jrt.decoder_params)

    out = {"tmp": tmp, "ar": {}}
    for task in ("clm", "jlm"):
        acfg = jconfig.load_config(None, _overrides(task, "/unused"))
        _, init_fn = jloop.build_task(acfg, emb_dim=COND)
        ar_params = perturb(init_fn(), 3, 0.05)
        out["ar"][task] = (acfg, ar_params)
        if task == "clm":
            (tmp / "clm_run").mkdir()
            jconfig.save_config(acfg, tmp / "clm_run" / "config.yaml")
            JCheckpoints(tmp / "clm_run" / "ckpt").save(
                jstate.create_train_state(ar_params, opt), step=1,
                metric=0.0)
        else:
            ocp.StandardCheckpointer().save(tmp / "jlm_params", ar_params)
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        tmp / "zarr3", {"a": {"kernel": np.arange(6, dtype=np.float32)
                              .reshape(2, 3)},
                        "b": jnp.asarray([1.5, -2.25], jnp.bfloat16),
                        "c": [np.int32(3), np.zeros((2,), np.float64)]})
    return out


@pytest.mark.parametrize("where", ["run", "ckpt", "step_2"])
def test_run_loads_as_jax_restores_it(saved, where):
    """The run directory, its ckpt/ (index.json's best entry: step 4) or a
    step directory: the trunk and the sigma embedder equal, bit for bit,
    the trees JAX's load_runtime restores from the same path."""
    run = saved["tmp"] / "run"
    path = {"run": run, "ckpt": run / "ckpt",
            "step_2": run / "ckpt" / "step_2"}[where]
    jrt = jck.load_runtime(str(run / "ckpt" if where == "run" else path))
    rt = checkpoints.load_runtime(path, device="cpu")
    _assert_equal(rt.trunk.state_dict(), _as_torch(jrt.trunk_params))
    _assert_equal(rt.sigma_embedder.state_dict(),
                  _as_torch(jrt.sigma_params))
    assert all(v.dtype == torch.float32 for v in
               rt.trunk.state_dict().values())


def test_sampling_from_the_loaded_run_equals_jax(saved):
    """ddpm from the loaded run (its sigma embedder too) with JAX's draws:
    JAX's tokens from its own restored run, equal."""
    run = saved["tmp"] / "run" / "ckpt"
    jrt = jck.load_runtime(str(run))
    rt = checkpoints.load_runtime(run, device="cpu")
    B, L, steps = 2, 20, 4
    rng = np.random.default_rng(3)
    seq = np.full((B, L), C.SEQUENCE_PAD_TOKEN, np.int32)
    lengths = np.array([20, 14], np.int32)
    for b, n in enumerate(lengths):
        seq[b, 0], seq[b, n - 1] = C.SEQUENCE_BOS_TOKEN, C.SEQUENCE_EOS_TOKEN
        seq[b, 1:n - 1] = rng.integers(4, 24, n - 2)
    prior = np.where(seq == C.SEQUENCE_PAD_TOKEN, C.STRUCTURE_PAD_TOKEN,
                     C.STRUCTURE_MASK_TOKEN).astype(np.int32)
    row_keys = jax.random.split(jax.random.PRNGKey(9), B)
    jm = jmdlm.MDLM(jrt.trunk, jrt.sigma_embedder)
    ref = jm.ddpm_sample({"net": jrt.trunk_params,
                          "sigma_embedder": jrt.sigma_params}, None,
                         jnp.asarray(seq), num_steps=steps,
                         input_prior=jnp.asarray(prior),
                         lengths=jnp.asarray(lengths), pack=1,
                         row_keys=row_keys)
    out = MDLM(rt.trunk, rt.sigma_embedder).ddpm_sample(
        torch.from_numpy(seq), num_steps=steps,
        input_prior=torch.from_numpy(prior),
        lengths=torch.from_numpy(lengths),
        noise_source=jax_ddpm_draws(row_keys, L, C.STRUCTURE_VOCAB_SIZE))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))


def test_vqvae_directory_loads_as_jax_restores_it(saved):
    """save_vqvae's directory (orbax params/, the decoder's 3 layers
    scanned): the encoder and decoder equal JAX's restored trees,
    unstacked; load_runtime pairs it with the run."""
    vq = saved["tmp"] / "vq"
    j_enc_cfg, j_enc, j_dec_cfg, j_dec = jck.load_vqvae(vq)
    enc_cfg, enc, dec_cfg, dec = checkpoints.load_vqvae(vq)
    assert dec_cfg.n_layers == 3 and not hasattr(dec_cfg, "scan_layers")
    _assert_equal(enc, _as_torch(j_enc))
    _assert_equal(dec, _as_torch(j_dec))
    assert "decoder_stack.blocks.2.attn.qkv.weight" in dec
    rt = checkpoints.load_runtime(saved["tmp"] / "run" / "ckpt",
                                  vqvae_ckpt=str(vq), device="cpu")
    _assert_equal(rt.encoder.state_dict(), enc)


@pytest.mark.parametrize("task", ["clm", "jlm"])
def test_ar_params_load_as_jax_restores_them(saved, task):
    """A CLM TrainState in a run (the run, its ckpt/, its step) and bare
    JLM params: the port's load_ar_params equals load_flax_params of JAX's
    load_ar_params, strictly."""
    acfg, _ = saved["ar"][task]
    tcfg = tconfig.load_config(None, _overrides(task, "/unused"))
    build = tloop.build_clm if task == "clm" else tloop.build_jlm
    tmp = saved["tmp"]
    paths = ([tmp / "clm_run", tmp / "clm_run" / "ckpt",
              tmp / "clm_run" / "ckpt" / "step_1"] if task == "clm"
             else [tmp / "jlm_params"])
    want = load_flax_params(build(tcfg, "cpu", cond_dim=COND), jax.device_get(
        jck.load_ar_params(str(paths[-1]), None))).state_dict()
    for path in paths:
        model = checkpoints.load_ar_params(path, build(tcfg, "cpu",
                                                       cond_dim=COND))
        _assert_equal(model.state_dict(), want)


def test_zarr3_tree_and_its_types(saved):
    """A zarr3 checkpoint: dicts, a list, bfloat16 (carried into torch
    through a uint16 view, bit for bit), int32 and float64 leaves."""
    tree = orbax.read_tree(saved["tmp"] / "zarr3")
    assert set(tree) == {"a", "b", "c"} and isinstance(tree["c"], list)
    np.testing.assert_array_equal(tree["a"]["kernel"],
                                  np.arange(6).reshape(2, 3))
    assert tree["c"][0] == 3 and tree["c"][1].dtype == np.float64
    from esmdiff_tpu_torch.convert import numpy_to_torch

    b = numpy_to_torch(tree["b"])
    assert b.dtype == torch.bfloat16 and b.tolist() == [1.5, -2.25]


def test_reader_runs_with_jax_blocked(saved):
    """load_runtime, load_vqvae and load_ar_params in a process where jax,
    flax, optax and orbax cannot import: the same tensors as here."""
    tmp = saved["tmp"]
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp / "run"), str(tmp / "vq"),
         str(tmp / "clm_run"), str(tmp / "blocked.pt")], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got = torch.load(tmp / "blocked.pt", weights_only=True)
    rt = checkpoints.load_runtime(tmp / "run", device="cpu")
    _assert_equal(got["trunk"], rt.trunk.state_dict())
    _assert_equal(got["sigma"], rt.sigma_embedder.state_dict())
    _, enc, _, dec = checkpoints.load_vqvae(tmp / "vq")
    _assert_equal(got["encoder"], enc)
    _assert_equal(got["decoder"], dec)
    model = tloop.build_clm(tconfig.load_config(
        str(tmp / "clm_run" / "config.yaml")), "cpu", cond_dim=COND)
    _assert_equal(got["clm"], checkpoints.load_ar_params(
        tmp / "clm_run", model).state_dict())


def test_without_tensorstore_raises_naming_it(saved, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoints.load_runtime(saved["tmp"] / "run", device="cpu")
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoints.load_vqvae(saved["tmp"] / "vq")
