"""The port's MDLM training path against the JAX package's, on the CPU at
tiny width in float32: batches bit for bit, the loss's primitives with
JAX's draws injected, ``MDLM.loss`` and ``loss_packed`` (rtol 1e-5), the
golden loss (1e-4) and ddpm sample (token for token), every parameter's gradient (1e-4 relative L2, leaf by
leaf), remat against no remat, and three AdamW steps with warmup and
clipping against optax (1e-5)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as JC
from esmdiff_tpu.diffusion import mdlm as jmdlm
from esmdiff_tpu.diffusion.noise import LogLinearNoise as JNoise
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep
from esmdiff_tpu.train import data as jdata
from esmdiff_tpu.train import state as jstate
from esmdiff_tpu_torch.convert import load_flax_params, state_dict_to_flax
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.diffusion import mdlm as tmdlm
from esmdiff_tpu_torch.diffusion.noise import LogLinearNoise
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from esmdiff_tpu_torch.train import data as tdata
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.train.loop import mdlm_modules, to_device
from test_torch_support import JaxLossDraws, jax_ddpm_draws, to_np

torch.set_num_threads(2)

GOLDEN = "tests/golden/tiny_mdlm.npz"


# -- data ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """``tests/test_train.py``'s kind of corpus: 12 chains of 20-69
    residues with BOS/EOS."""
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


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, bucket_multiple=32),
    dict(batch_size=3, bucket_multiple=16, max_len=40),
    dict(batch_size=2, pack_len=96),
    dict(batch_size=2, pack_len=64, max_len=48, pack_max_segments=3),
], ids=["padded", "padded_truncated", "packed", "packed_truncated"])
def test_batches_equal_jax_bit_for_bit(corpus, kw):
    """Both packages' ``batches`` over the same corpus and seeds: the same
    arrays, dtypes and order (train shuffled over two epochs' seeds, val
    in order with the last batch repeated)."""
    jcfg = jdata.DataConfig(path=corpus, **kw)
    tcfg = tdata.DataConfig(path=corpus, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtr, jva = jdata.train_val_split(jdata.EncodingDataset(jcfg), jcfg)
    ttr, tva = tdata.train_val_split(tdata.EncodingDataset(tcfg), tcfg)
    np.testing.assert_array_equal(jtr.indices, ttr.indices)
    np.testing.assert_array_equal(jva.indices, tva.indices)
    runs = [((jtr, ttr), dict(shuffle=True, seed=s)) for s in (42, 43)]
    runs.append(((jva, tva), dict(shuffle=False, seed=0, drop_last=False)))
    n = 0
    for (js, ts), args in runs:
        jb = list(jdata.batches(js, jcfg, **args))
        tb = list(tdata.batches(ts, tcfg, **args))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n >= 3
    assert tdata.resolve_pack_segments(tcfg) == \
        jdata.resolve_pack_segments(jcfg)


# -- the loss's primitives ----------------------------------------------------

def _mdlm_cfgs(**kw):
    return jmdlm.MDLMConfig(**kw), tmdlm.MDLMConfig(**kw)


@pytest.mark.parametrize("kw", [
    {}, dict(antithetic_sampling=False),
    dict(importance_sampling=True, sampling_eps=1e-2)])
def test_sample_t_and_segment_times(kw):
    jcfg, tcfg = _mdlm_cfgs(**kw)
    key = jax.random.PRNGKey(3)
    k_t = jax.random.split(key, 4)[2]
    want = jmdlm.sample_t(k_t, 16, jcfg, JNoise())
    got = tmdlm.sample_t(JaxLossDraws(key), 16, tcfg, LogLinearNoise())
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)
    want = jmdlm.packed_segment_times(k_t, 3, 5, jcfg, JNoise())
    got = tmdlm.packed_segment_times(JaxLossDraws(key, packed=True), 3, 5,
                                     tcfg, LogLinearNoise())
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("coupled", [False, True])
def test_q_xt(coupled):
    jcfg, tcfg = _mdlm_cfgs(coupled_condition_mask=coupled)
    rng = np.random.default_rng(0)
    x0 = rng.integers(0, 4096, (3, 20)).astype(np.int32)
    seq = rng.integers(4, 24, (3, 20)).astype(np.int32)
    move = np.array([[0.1], [0.5], [0.9]], np.float32)
    nmm = rng.random((3, 20)) < 0.2
    key = jax.random.PRNGKey(5)
    want = jmdlm.q_xt(jax.random.split(key, 4)[3], x0, move, jcfg,
                      condition_seq=seq, non_moving_mask=nmm)
    got = tmdlm.q_xt(JaxLossDraws(key), torch.from_numpy(x0).long(),
                     torch.from_numpy(move), tcfg,
                     condition_seq=torch.from_numpy(seq).long(),
                     non_moving_mask=torch.from_numpy(nmm))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    assert (np.asarray(want[0]) == JC.STRUCTURE_MASK_TOKEN).any()


# -- the loss and its gradients -----------------------------------------------

_TRUNK = dict(dtype="float32", head_type="structure",
              n_structure_heads=C.STRUCTURE_VOCAB_SIZE)


@functools.lru_cache(maxsize=None)
def _jax_model(mdlm_kw: tuple):
    """The JAX MDLM (tiny trunk, float32, structure head, remat) and its
    params from ``init(PRNGKey(0))``; the params are host numpy arrays,
    never written, so tests share them."""
    jcfg_t = jesm3.esm3_tiny(**_TRUNK)
    jm = jmdlm.MDLM(jesm3.ESM3(jcfg_t),
                    JTimestep(hidden_size=jcfg_t.d_model, dtype=jnp.float32),
                    noise=JNoise(), cfg=jmdlm.MDLMConfig(**dict(mdlm_kw)))
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0)))


def _models(remat=True, **mdlm_kw):
    """The JAX MDLM and params, and a fresh port MDLM carrying them."""
    jm, params = _jax_model(tuple(sorted(mdlm_kw.items())))
    tm = tmdlm.MDLM(tesm3.ESM3(tesm3.esm3_tiny(**_TRUNK, remat=remat)),
                    TimestepEmbedder(64, dtype=torch.float32),
                    noise=LogLinearNoise(), cfg=tmdlm.MDLMConfig(**mdlm_kw))
    load_flax_params(mdlm_modules(tm), params)
    return jm, params, tm


def _padded_batch(seed=0, B=3, L=32):
    rng = np.random.default_rng(seed)
    lengths = [L, 25, 12][:B]
    items = []
    for n in lengths:
        items.append({
            "sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
            "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)})
    return tdata.pad_collate(items, 16)


def _packed_batch(seed=0):
    rng = np.random.default_rng(seed)
    rows = [[{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
              "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
             for n in lens] for lens in ([20, 30, 10], [40])]
    return tdata.pack_collate(rows, 64)


def _jax_loss(jm, packed, training=True):
    """JAX's loss(params, batch, key) -> (loss, breakdown), jitted."""
    if packed:
        return jax.jit(lambda p, b, k: jm.loss_packed(
            p, b, k, max_segments=4, training=training))
    return jax.jit(lambda p, b, k: jm.loss(p, b, k, training=training))


def _losses(jloss, params, tm, batch, key, packed, training=True):
    want = jloss(params, batch, key)
    if packed:
        got = tm.loss_packed(to_device(batch, "cpu"),
                             JaxLossDraws(key, packed=True), max_segments=4,
                             training=training)
    else:
        got = tm.loss(to_device(batch, "cpu"), JaxLossDraws(key),
                      training=training)
    return want, got


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("kw", [
    {}, dict(condition_dropout=0.6, condition_mask_rate=0.3,
             coupled_condition_mask=True, T=10),
], ids=["default", "conditioning"])
def test_loss_equals_jax(packed, kw):
    """Two keys each; with condition dropout and masking also at
    training=False, which turns them off (without them the flag changes
    nothing)."""
    jm, params, tm = _models(**kw)
    batch = _packed_batch() if packed else _padded_batch()
    for training in ((True, False) if kw else (True,)):
        jloss = _jax_loss(jm, packed, training)
        for seed in (1, 2):
            (wl, wbd), (gl, gbd) = _losses(jloss, params, tm, batch,
                                           jax.random.PRNGKey(seed), packed,
                                           training)
            np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-5)
            assert wbd.keys() == gbd.keys()
            assert np.isfinite(float(wl))


@pytest.fixture(scope="module")
def golden_mdlm():
    """``tests/test_golden.py``'s model (params from
    ``init(PRNGKey(1234))``), carried over, and its sequence rows."""
    jcfg_t = jesm3.esm3_tiny(dtype="float32", head_type="structure",
                             n_structure_heads=C.STRUCTURE_VOCAB_SIZE)
    jm = jmdlm.MDLM(jesm3.ESM3(jcfg_t),
                    JTimestep(hidden_size=jcfg_t.d_model, dtype=jnp.float32),
                    noise=JNoise(), cfg=jmdlm.MDLMConfig())
    params = jax.device_get(jm.init(jax.random.PRNGKey(1234)))
    tm = tmdlm.MDLM(tesm3.ESM3(tesm3.esm3_tiny(
        dtype="float32", head_type="structure",
        n_structure_heads=C.STRUCTURE_VOCAB_SIZE)),
        TimestepEmbedder(64, dtype=torch.float32))
    load_flax_params(mdlm_modules(tm), params)
    B, L = 2, 12
    return tm, torch.arange(B * L).reshape(B, L) % 20 + 4, np.load(GOLDEN)


def test_golden_loss(golden_mdlm):
    """``tests/golden/tiny_mdlm.npz``'s loss (the loss's key PRNGKey(7))
    with JAX's draws injected, at 1e-4."""
    tm, seq, ref = golden_mdlm
    B, L = seq.shape
    xt = (torch.arange(B * L).reshape(B, L) * 37) % 4096
    xt[:, ::3] = C.STRUCTURE_MASK_TOKEN
    batch = {"structure_tokens": (xt * 7) % 4096, "sequence_tokens": seq,
             "mask": torch.ones(B, L)}
    loss, _ = tm.loss(batch, JaxLossDraws(jax.random.PRNGKey(7)))
    np.testing.assert_allclose(loss.item(), ref["loss"], atol=1e-4,
                               rtol=1e-4)


def test_golden_sample(golden_mdlm):
    """The golden file's ddpm trajectory (6 steps, PRNGKey(9): rows
    ``split(key, 2)``) token for token, with JAX's per-position draws."""
    tm, seq, ref = golden_mdlm
    rows = np.asarray(jax.random.split(jax.random.PRNGKey(9), seq.shape[0]))
    got = tm.ddpm_sample(seq, jax_ddpm_draws(rows, seq.shape[1],
                                             C.STRUCTURE_VOCAB_SIZE),
                         num_steps=6)
    np.testing.assert_array_equal(to_np(got), ref["sample"])


def _port_grads(tm, loss_fn):
    modules = mdlm_modules(tm)
    modules.zero_grad(set_to_none=True)
    loss, _ = loss_fn()
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for n, p in modules.named_parameters()}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb > 0 else np.linalg.norm(a)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_gradients_equal_jax_leaf_by_leaf(packed):
    """jax.grad of the loss against the port's backward (remat on in both),
    mapped back to JAX's tree by ``state_dict_to_flax``: every leaf within
    1e-4 relative L2 (exactly 0 where JAX's is, e.g. geometric attention,
    which the MDLM forward skips)."""
    jm, params, tm = _models()
    batch = _packed_batch() if packed else _padded_batch()
    key = jax.random.PRNGKey(11)
    jloss = _jax_loss(jm, packed)
    if packed:
        def tloss():
            return tm.loss_packed(to_device(batch, "cpu"),
                                  JaxLossDraws(key, packed=True),
                                  max_segments=4)
    else:
        def tloss():
            return tm.loss(to_device(batch, "cpu"), JaxLossDraws(key))
    want = jax.device_get(jax.jit(jax.grad(
        lambda p: jloss(p, batch, key)[0]))(params))
    _, grads = _port_grads(tm, tloss)
    got = state_dict_to_flax(grads, want)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    leaves_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(leaves_w) == len(leaves_g)
    n_zero = 0
    for path, w in leaves_w:
        g = leaves_g[path]
        assert g.shape == w.shape, path
        if not np.any(w):
            n_zero += 1
            assert not np.any(g), path
        else:
            assert _rel_l2(g, w) <= 1e-4, (path, _rel_l2(g, w))
    assert 0 < n_zero < len(leaves_w) // 2


def test_remat_equals_no_remat():
    """Blocks 1.. rematerialised (checkpoint) or not: the same loss and
    gradients."""
    batch = to_device(_padded_batch(), "cpu")
    out = []
    for remat in (True, False):
        _, _, tm = _models(remat=remat)
        out.append(_port_grads(
            tm, lambda: tm.loss(batch, JaxLossDraws(jax.random.PRNGKey(4)))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for n, g in out[0][1].items():
        np.testing.assert_allclose(to_np(g), to_np(out[1][1][n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_three_adamw_steps_equal_optax():
    """Warmup 2 (the first update at lr 0), a global-norm clip of 1.0 and
    a weight decay of 0.5 (large enough that decay alone moves the leaves
    the MDLM forward never reaches past the tolerance): after three steps
    of the JAX train step and of the port's, every parameter agrees at
    1e-5; the reported (raw) gradient norms too."""
    jm, params, tm = _models()
    batch = _padded_batch()
    kw = dict(lr=1e-3, weight_decay=0.5, warmup_steps=2, grad_clip=1.0)
    opt = jstate.make_optimizer(**kw)
    jstep = jstate.make_train_step(lambda p, b, k: jm.loss(p, b, k), opt,
                                   donate=False)
    jst = jstate.create_train_state(params, opt)
    modules = mdlm_modules(tm)
    tst = tstate.create_train_state(
        modules, tstate.make_optimizer(modules.parameters(), **kw))
    tbatch = to_device(batch, "cpu")
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jst, jmetrics = jstep(jst, batch, key)
        tmetrics = tstate.train_step(
            tst, lambda b, d: tm.loss(b, d), tbatch, JaxLossDraws(key))
        np.testing.assert_allclose(tmetrics["loss"].item(),
                                   float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tmetrics["grad_norm"].item(),
                                   float(jmetrics["grad_norm"]), rtol=1e-5)
        assert float(jmetrics["grad_norm"]) > kw["grad_clip"]  # clipped
    assert tst.step == int(jst.step) == 3
    want = jax.device_get(jst.params)
    got = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_flax(modules.state_dict(), want)))
    start = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(got[path], w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
        if np.any(start[path]):  # decay moves it, with a gradient or not
            assert not np.allclose(w, start[path], rtol=0, atol=1e-5), path
