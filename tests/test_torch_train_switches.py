"""The two training switches of the port against the JAX package, on the
CPU at tiny width: ``model.remat_policy="dots"`` (the products' outputs
kept, the rest recomputed) and ``model.param_dtype=bfloat16`` (bf16 trunk,
sigma embedder and heads, LayerNorms float32 as flax keeps them, bf16
gradients and AdamW moments with optax's arithmetic)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from esmdiff_tpu.diffusion import mdlm as jmdlm
from esmdiff_tpu.diffusion.noise import LogLinearNoise as JNoise
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep
from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu.train import data as jdata
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu.train import state as jstate
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.convert import (checkpoints, load_flax_params,
                                       state_dict_to_flax)
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.diffusion import mdlm as tmdlm
from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn.layers import LayerNorm, TimestepEmbedder
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import data as tdata
from esmdiff_tpu_torch.train import loop as tloop
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.utils.checkpoint import load_params
from test_torch_support import JaxLossDraws

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_TRUNK = dict(dtype="float32", head_type="structure",
              n_structure_heads=C.STRUCTURE_VOCAB_SIZE)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 chains of 20-69 residues with BOS/EOS."""
    root = tmp_path_factory.mktemp("encodings")
    rng = np.random.RandomState(0)
    for i in range(12):
        L = rng.randint(20, 70)
        np.savez(root / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32))
    return str(root)


def _batch():
    rng = np.random.default_rng(0)
    items = [{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
              "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
             for n in (32, 25, 12)]
    return tdata.pad_collate(items, 16)


# -- remat_policy="dots" -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mdlm(policy: str):
    cfg = jesm3.esm3_tiny(**_TRUNK, remat=True, remat_policy=policy)
    jm = jmdlm.MDLM(jesm3.ESM3(cfg),
                    JTimestep(hidden_size=cfg.d_model, dtype=jnp.float32),
                    noise=JNoise(), cfg=jmdlm.MDLMConfig())
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _port_mdlm(policy, params):
    tm = tmdlm.MDLM(tesm3.ESM3(tesm3.esm3_tiny(**_TRUNK, remat_policy=policy)),
                    TimestepEmbedder(64, dtype=torch.float32),
                    noise=LogLinearNoise(), cfg=tmdlm.MDLMConfig())
    load_flax_params(tloop.mdlm_modules(tm), params)
    return tm


class _Products(TorchDispatchMode):
    """Counts the products (mm, bmm, addmm) dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in tesm3.SAVED_PRODUCTS
        return func(*args, **(kwargs or {}))


def _port_grads(tm, batch, key):
    modules = tloop.mdlm_modules(tm)
    modules.zero_grad(set_to_none=True)
    loss, _ = tm.loss(tloop.to_device(batch, "cpu"), JaxLossDraws(key))
    with _Products() as products:
        loss.backward()
    return loss.item(), {n: (torch.zeros_like(p) if p.grad is None
                             else p.grad.clone())
                         for n, p in modules.named_parameters()}, products.n


def test_dots_gradients_equal_nothing_and_jax():
    """float32, the same params and draws: the port's gradients under
    "dots" equal its gradients under "nothing" bit for bit (the same ops
    on the same values), with fewer products recomputed in the backward
    (the saved ones are reused: in each of the 3 recomputed blocks 5 of
    its 6 products, the last of which, the FFN's down projection,
    "nothing" does not recompute either, as the recompute stops once
    backward has what it needs).  JAX's "dots" gradient equals its
    "nothing" one within 1e-6 relative L2 (measured 3.2e-7); the port's
    "dots" gradient lies from JAX's "dots" one within its "nothing" gap
    plus that (measured 1.4e-6, the float32 gap of the two packages'
    backward), and within 1e-4 leaf by leaf, the trainer's gradient
    test's bound (test_torch_train.py)."""
    batch = _batch()
    key = jax.random.PRNGKey(11)
    out = {}
    for policy in ("nothing", "dots"):
        jm, params = _jax_mdlm(policy)
        want = jax.device_get(jax.jit(jax.grad(
            lambda p: jm.loss(p, batch, key)[0]))(params))
        out[policy] = (want, *_port_grads(_port_mdlm(policy, params), batch,
                                          key))
    (jn, ln, gn, pn), (jd, ld, gd, pd) = out["nothing"], out["dots"]
    assert ld == ln and gd.keys() == gn.keys()
    for name in gn:
        assert torch.equal(gd[name], gn[name]), name
    assert pn - pd == 3 * 5

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    def flat(tree):
        return np.concatenate([np.ravel(x) for x in jax.tree.leaves(tree)])

    got = state_dict_to_flax(gd, jd)
    jax_policies = rel(flat(jd), flat(jn))
    assert jax_policies <= 1e-6
    # the port's policies agree exactly, so its gap to JAX under "dots" is
    # bounded by its gap under "nothing" plus JAX's own policy gap
    assert rel(flat(got), flat(jd)) <= rel(
        flat(state_dict_to_flax(gn, jn)), flat(jn)) + jax_policies
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(jd):
        if np.any(w):
            assert rel(got[path], w) <= 1e-4, path


def test_remat_policy_checks():
    assert tesm3.remat_kwargs("nothing") == {"use_reentrant": False}
    assert "context_fn" in tesm3.remat_kwargs("dots")
    with pytest.raises(ValueError, match="remat_policy"):
        tesm3.ESM3(tesm3.esm3_tiny(remat_policy="everything"))


def test_remat_policy_is_a_config_key_jax_still_loads(tmp_path):
    """model.remat_policy reaches the trunk; a run's config.yaml leaves it
    out at its default, so the JAX package loads it, and keeps it at
    "dots" (a port-only run)."""
    cfg = tconfig.load_config(str(ROOT / "configs/mdlm.yaml"),
                              ["model.size=tiny", "model.remat_policy=dots"])
    assert tloop.trunk_config(cfg).remat_policy == "dots"
    tconfig.save_config(cfg, tmp_path / "dots.yaml")
    assert tconfig.load_config(str(tmp_path / "dots.yaml")) \
        .model.remat_policy == "dots"
    cfg.model.remat_policy = "nothing"
    tconfig.save_config(cfg, tmp_path / "plain.yaml")
    assert "remat_policy" not in (tmp_path / "plain.yaml").read_text()
    jconfig.load_config(str(tmp_path / "plain.yaml"))


# -- param_dtype=bfloat16 ------------------------------------------------------

BF16 = ["model.size=tiny", "model.param_dtype=bfloat16", "data.batch_size=3",
        "data.bucket_multiple=16", "optim.lr=1e-3", "optim.grad_clip=1.0"]


def _bf16_runs(corpus):
    """Three steps of JAX's bf16 trainer and the port's (carrying JAX's
    init; JAX's draws), and the port's with torch's AdamW order (decay
    p *= 1 - lr wd, then the Adam step): (JAX's state, its metrics, the
    port's runs {name: (modules, state, metrics)}, the start params)."""
    ov = [f"data.path={corpus}", *BF16]
    jcfg, tcfg = jconfig.load_config(None, ov), tconfig.load_config(None, ov)
    jloss, init_fn = jloop.build_task(jcfg)
    params = jax.device_get(init_fn())
    opt = jstate.make_optimizer(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    jstep = jstate.make_train_step(lambda p, b, k: jloss(p, b, k), opt,
                                   donate=False)
    jst = jstate.create_train_state(params, opt)
    runs = {}
    for order in ("optax", "torch"):
        mdlm, loss = tloop.build_task(tcfg, "cpu")
        modules = tloop.mdlm_modules(mdlm)
        load_flax_params(modules, jax.tree.map(
            lambda x: np.asarray(x, np.float32), params))
        tloop.cast_params(modules, torch.bfloat16)
        if order == "optax":
            optimizer = tstate.make_optimizer(modules.parameters(), lr=1e-3,
                                              weight_decay=0.01,
                                              grad_clip=1.0)
        else:
            optimizer = tstate.Optimizer(torch.optim.AdamW(
                list(modules.parameters()), lr=1e-3, betas=(0.9, 0.999),
                eps=1e-8, weight_decay=0.01), 1e-3, grad_clip=1.0)
        runs[order] = (modules, tstate.create_train_state(modules, optimizer),
                       loss, [])
    split, _ = jdata.train_val_split(jdata.EncodingDataset(jcfg.data),
                                     jcfg.data)
    jmetrics = []
    for i, batch in zip(range(3), jdata.batches(split, jcfg.data,
                                                shuffle=True, seed=1)):
        key = jax.random.PRNGKey(30 + i)
        jst, m = jstep(jst, batch, key)
        jmetrics.append({k: float(v) for k, v in m.items()})
        for modules, st, loss, metrics in runs.values():
            metrics.append({k: v.item() for k, v in tstate.train_step(
                st, loss, tloop.to_device(batch, "cpu"),
                JaxLossDraws(key)).items()})
    return jst, jmetrics, runs, params


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def test_bf16_params_dtypes_and_three_steps_against_jax(corpus):
    """The dtypes: parameters, gradients and both moments bf16 where
    JAX's params are, LayerNorms float32 in both.  Three steps at lr 1e-3
    (at 1e-5 most updates fall below a bf16 ulp): the port's parameters
    lie from JAX's within 3x the spread between two bf16 orderings of the
    same AdamW (the port with optax's order against torch's decoupled
    decay order; measured 9.2% and 4.8% of the update's norm), and each
    step's loss within 1e-3 relative (measured 3e-4)."""
    jst, jmetrics, runs, start = _bf16_runs(corpus)
    modules, st, _, metrics = runs["optax"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(start):
        name = jax.tree_util.keystr(path)
        is_ln = "ln'" in name or "['norm']" in name
        assert leaf.dtype == (np.float32 if is_ln else jnp.bfloat16), name
    for m in modules.modules():
        for p in m.parameters(recurse=False):
            want = torch.float32 if isinstance(m, LayerNorm) \
                else torch.bfloat16
            s = st.optimizer.adamw.state[p]
            assert p.dtype == p.grad.dtype == s["exp_avg"].dtype == \
                s["exp_avg_sq"].dtype == want
    for got, want in zip(metrics, jmetrics):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-3)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-2)
    want = jax.device_get(jst.params)
    w, s0 = _flat(want), _flat(start)

    def flat_port(order):
        return _flat(state_dict_to_flax(
            {k: v.float() for k, v in runs[order][0].state_dict().items()},
            want))

    update = np.linalg.norm(w - s0)
    gap = np.linalg.norm(flat_port("optax") - w) / update
    spread = np.linalg.norm(flat_port("optax") - flat_port("torch")) / update
    assert update > 0 and 0 < spread and gap <= 3 * spread, (gap, spread)


def test_bf16_clip_follows_optax():
    """clip_by_global_norm in bf16: each leaf's sum of squares in its
    dtype, a float32 total over bf16 and float32 gradients (as JAX
    promotes the mixed sum), then (g / norm) * max in each gradient's
    dtype: against optax on the same values, the norm within 1e-6 and the
    clipped gradients bit for bit; all-bf16 gradients give a bf16 norm."""
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((64, 32)).astype(jnp.bfloat16),
             "b": rng.standard_normal((32,)).astype(np.float32)}
    want, _ = jax.jit(jax.tree_util.Partial(
        lambda g: __import__("optax").clip_by_global_norm(1.0).update(
            g, None)))(grads)
    tg = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if k == "a" else torch.float32)
        for k, v in grads.items()}
    norm = tstate.global_norm(list(tg.values()))
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(norm.item(), float(
        __import__("optax").global_norm(grads)), rtol=1e-6)
    for k, g in tg.items():
        g.div_(norm.to(g.dtype)).mul_(1.0)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(want[k], np.float32))
    assert tstate.global_norm([tg["a"]]).dtype == torch.bfloat16


def test_bf16_run_loads_through_ckpt(corpus, tmp_path):
    """A bf16 run (esmdiff-torch-train) saves bf16 tensors; load_runtime
    holds them as float32 values equal to the saved ones, and quantizes
    from them (--quant int8); the sampling CLI samples it."""
    from esmdiff_tpu_torch.cli import sample as sample_cli

    run = tmp_path / "run"
    train_cli.main(["--device", "cpu", f"data.path={corpus}", *BF16,
                    "trainer.max_epochs=1", f"trainer.ckpt_dir={run}",
                    "model.remat_policy=dots", "trainer.print_config=false"])
    step = sorted((run / "ckpt").glob("step_*"))[0]
    saved = load_params(step)
    assert {v.dtype for v in saved.values()} == {torch.bfloat16,
                                                 torch.float32}
    rt = checkpoints.load_runtime(run / "ckpt", device="cpu")
    for k, v in rt.trunk.state_dict().items():
        assert torch.equal(v, saved[f"net.{k}"].float()), k
    assert checkpoints.load_runtime(run, device="cpu",
                                    quant="int8").trunk.cfg.quant == "int8"
    sample_cli.main(["--ckpt", str(run / "ckpt"), "--mode", "ddpm",
                     "--input", str(ROOT / "data/targets/bpti"), "--output",
                     str(tmp_path / "s"), "--num_steps", "2",
                     "--num_samples", "2", "--device", "cpu"])
    assert (tmp_path / "s" / "bpti.pdb").read_text().count("MODEL") == 2
