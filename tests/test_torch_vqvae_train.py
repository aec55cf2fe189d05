"""The port's VQ-VAE trainer against the JAX package's, on the CPU at the
tiny geometry of ``tests/test_vqvae_train.py`` (encoder d 32, 64 codes of
8; decoder d 32, 2 layers, float32), JAX's init carried over: the forward
(tokens, full_tokens, valid, usage and z_q equal; z within 1e-5 relative
L2, bb_pred within 1e-5 of its largest |value|), the loss terms (1e-5 relative) and every
gradient (1e-4 relative L2, leaf by leaf) for both reconstruction losses,
the host-side numpy bit for bit (augment_batch, restart_dead_codes), the
warmup-cosine schedule, 5 training steps with each loss (losses 1e-4
relative, final parameters 1e-4 relative L2), and the export (the
materialized table 1e-6 on the same parameters; the standalone decoder
loaded from it reproduces the training-time bb_pred within 1e-6 of its
largest |value|).

The JAX side compiles each function once, in module-scoped fixtures."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu.train import vqvae as jvq
from esmdiff_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from esmdiff_tpu_torch.convert.checkpoints import load_vqvae, vqvae_from_flax
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder)
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.train import vqvae as tvq
from test_torch_support import to_np

torch.set_num_threads(2)

ENC_KW = dict(d_model=32, n_heads=2, v_heads=4, n_layers=2, d_out=8,
              n_codes=64, knn=8)
DEC_KW = dict(d_model=32, n_heads=2, n_layers=2, dtype="float32",
              predict_ptm=False)
JENC, JDEC = JEncoderConfig(**ENC_KW), JDecoderConfig(scan_layers=False,
                                                      **DEC_KW)
ENC, DEC = EncoderConfig(**ENC_KW), DecoderConfig(**DEC_KW)


def toy_corpus(n=16, lp=24, seed=0):
    """Noisy helices (``tests/test_vqvae_train.py``'s corpus); chain 3
    ragged (18 residues, NaN tail)."""
    rs = np.random.RandomState(seed)
    t = np.arange(lp)

    def chain(phase):
        ca = np.stack([2.3 * np.cos(0.6 * t + phase),
                       2.3 * np.sin(0.6 * t + phase), 1.5 * t], -1)
        return np.stack([ca + np.array([1.2, 0.3, -0.4]), ca,
                         ca + np.array([-0.8, 1.0, 0.5])], 1)

    coords = np.stack([chain(rs.rand() * 6) + rs.randn(lp, 3, 3) * 0.1
                       for _ in range(n)]).astype(np.float32)
    lengths = np.full((n,), lp, np.int32)
    lengths[3] = 18
    coords[3, 18:] = np.nan
    return coords, lengths


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb > 0 else np.linalg.norm(a)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def setup():
    """JAX's init (as ``train_vqvae`` makes it, seed 0) and a batch of 4:
    chain 0 with one residue's C missing (a MASK interior token), chain 1
    cropped by ``augment_batch``, chain 3 ragged."""
    coords, lengths = toy_corpus()
    vq = jvq.VQVAE(JENC, JDEC)
    params = jax.device_get(jax.jit(vq.init)(
        jax.random.PRNGKey(0), jnp.asarray(coords[:1]),
        jnp.asarray(lengths[:1]))["params"])
    c, lens = coords[:4].copy(), lengths[:4].copy()
    c[0, 5, 2] = np.nan
    crop = jvq.VQAugmentConfig(crop=1.0, crop_min=8, jitter=0.0,
                               rotate=False)
    cropped, cl = jvq.augment_batch(c[1:2], lens[1:2], crop,
                                    np.random.RandomState(5))
    c[1], lens[1] = cropped[0], cl[0]
    assert lens[1] < 24 and np.isnan(c[1, lens[1]:]).all()
    batch = {"coords": c, "coords_clean": np.nan_to_num(c, nan=0.0),
             "coord_mask": np.isfinite(c).all(-1).all(-1).astype(np.float32),
             "lengths": lens}
    return coords, lengths, vq, params, batch


def _port(params):
    return vqvae_from_flax(ENC, DEC, params)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_forward_equals_jax(setup):
    _, _, vq, params, batch = setup
    jout, jaux = jax.jit(vq.apply)({"params": params},
                                   jnp.asarray(batch["coords"]),
                                   jnp.asarray(batch["lengths"]))
    with torch.no_grad():
        tout, taux = _port(params)(torch.from_numpy(batch["coords"]),
                                   torch.from_numpy(batch["lengths"]))
    valid = np.asarray(jaux["valid"])
    assert not valid[0, 5] and valid[0, 4] and not valid[1].all()
    for k in ("tokens", "full_tokens", "valid", "usage"):
        np.testing.assert_array_equal(to_np(taux[k]), np.asarray(jaux[k]),
                                      err_msg=k)
    # z as the encoder's own test holds it (relative L2); z_q is a gather
    # of equal tokens; bb_pred against its largest |value|
    assert _rel_l2(to_np(taux["z"]), jaux["z"]) <= 1e-5
    np.testing.assert_array_equal(to_np(taux["z_q"]), np.asarray(jaux["z_q"]))
    want = np.asarray(jout["bb_pred"])
    assert np.abs(to_np(tout["bb_pred"]) - want).max() \
        <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("recon", ["drmsd", "kabsch"])
def test_loss_and_gradients_equal_jax(setup, recon):
    """Each loss term within 1e-5 relative; the gradients, mapped back to
    JAX's tree (``state_dict_to_flax``), within 1e-4 relative L2 leaf by
    leaf (zero where JAX's is zero: the pLDDT head)."""
    _, _, vq, params, batch = setup
    cfg = jvq.VQLossConfig(recon=recon)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        out, aux = vq.apply({"params": p}, jb["coords"], jb["lengths"])
        return jvq.vqvae_loss(out, aux, jb["coords_clean"], jb["coord_mask"],
                              jb["lengths"], cfg)

    (jtotal, jm), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    model = _port(params)
    total, tm = tvq.batch_loss(model, _torch_batch(batch),
                               tvq.VQLossConfig(recon=recon))
    total.backward()
    for k, got, want in (("total", total, jtotal),
                         *((k, tm[k], jm[k])
                           for k in ("recon", "codebook", "commit"))):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(to_np(tm["usage"]), np.asarray(jm["usage"]))
    want = jax.device_get(jgrad)
    got = state_dict_to_flax(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()}, want)
    w_leaves, g_leaves = _leaves(want), _leaves(got)
    assert w_leaves.keys() == g_leaves.keys()
    n_zero = 0
    for path, w in w_leaves.items():
        if not np.any(w):
            n_zero += 1
            assert not np.any(g_leaves[path]), path
        else:
            assert _rel_l2(g_leaves[path], w) <= 1e-4, (
                path, _rel_l2(g_leaves[path], w))
    assert 0 < n_zero < len(w_leaves) // 4


def test_augment_batch_bit_for_bit(setup):
    coords, lengths, *_ = setup
    for aug in (jvq.VQAugmentConfig(), jvq.VQAugmentConfig(crop=1.0,
                                                           crop_min=8)):
        want = jvq.augment_batch(coords[:8], lengths[:8], aug,
                                 np.random.RandomState(3))
        got = tvq.augment_batch(coords[:8], lengths[:8],
                                tvq.VQAugmentConfig(**dataclasses.asdict(aug)),
                                np.random.RandomState(3))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_restart_dead_codes_bit_for_bit(setup):
    """The same rows and count from the same RandomState; the port writes
    them in place; nothing dead, nothing restarted."""
    *_, params, _ = setup
    rs = np.random.RandomState(0)
    usage = rs.randint(0, 3, size=64)
    pool = rs.randn(40, 8).astype(np.float32)
    want, n_want = jvq.restart_dead_codes(params, usage, pool,
                                          np.random.RandomState(7))
    model = _port(params)
    n = tvq.restart_dead_codes(model, usage, pool, np.random.RandomState(7))
    assert n == n_want == int((usage == 0).sum()) > 0
    np.testing.assert_array_equal(to_np(model.encoder.codebook),
                                  np.asarray(want["encoder"]["codebook"]))
    before = to_np(model.encoder.codebook).copy()
    assert tvq.restart_dead_codes(model, np.ones(64), pool,
                                  np.random.RandomState(7)) == 0
    np.testing.assert_array_equal(to_np(model.encoder.codebook), before)


@pytest.mark.parametrize("steps", [3, 5, 100, 20000])
def test_warmup_cosine_schedule_equals_optax(steps):
    """optax's schedule as ``train_vqvae`` builds it, at every count from 0
    to ``steps`` (and past it): within 2.5e-7 of lr (optax computes in
    float32, the port in float64)."""
    lr = 3e-4
    kw = dict(warmup_steps=min(200, max(1, steps // 20)), decay_steps=steps,
              end_value=lr / 30)
    want = optax.warmup_cosine_decay_schedule(0.0, lr, **kw)
    got = tstate.warmup_cosine_decay_schedule(0.0, lr, **kw)
    counts = np.arange(steps + 3)
    w = np.asarray(jax.vmap(want)(jnp.asarray(counts)), np.float64)
    g = np.asarray([got(int(c)) for c in counts])
    np.testing.assert_allclose(g, w, rtol=0, atol=2.5e-7 * lr)
    assert got(0) == 0.0


@pytest.fixture(scope="module", params=["drmsd", "kabsch"])
def trained(setup, request):
    """Both trainers, 5 steps, batch 4, restart every 2, augmented, with a
    validation split, from JAX's init, with each reconstruction loss."""
    coords, lengths, _, params, _ = setup
    kw = dict(steps=5, batch=4, lr=1e-3, seed=0, restart_every=2,
              val_idx=np.asarray([0, 1]), log_every=2)
    jlog, tlog = [], []
    jres = jvq.train_vqvae(JENC, JDEC, coords, lengths,
                           loss_cfg=jvq.VQLossConfig(recon=request.param),
                           augment=jvq.VQAugmentConfig(), log=jlog.append,
                           **kw)
    tres = tvq.train_vqvae(ENC, DEC, coords, lengths,
                           loss_cfg=tvq.VQLossConfig(recon=request.param),
                           augment=tvq.VQAugmentConfig(), log=tlog.append,
                           device="cpu", params=flax_to_state_dict(params),
                           **kw)
    return request.param, jres, tres, jlog, tlog


def test_train_vqvae_equals_jax(trained):
    """Losses within 1e-4 relative, the same restarts (count and step),
    every final parameter within 1e-4 relative L2 of JAX's.  One
    exception, with drmsd: the translation entries of the frame head's
    bias (``proj.bias[6:9]``).  drmsd is exactly invariant to a global
    translation, so their gradient is rounding noise in both packages,
    which Adam scales to steps of up to ~lr in either direction: they are
    held to that bound instead."""
    recon, jres, tres, jlog, tlog = trained
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-4)
    assert tres.n_live_codes == jres.n_live_codes
    restarts = [m.split(" (")[0] for m in jlog if "restarted" in m]
    assert restarts and restarts == [m.split(" (")[0] for m in tlog
                                     if "restarted" in m]
    assert len([m for m in tlog if "val_recon" in m]) == 3
    want = _leaves(jax.device_get(jres.params))
    got = _leaves(state_dict_to_flax(tres.params, jax.device_get(jres.params)))
    head = next(p for p in want if [k.key for k in p][-3:] == [
        "affine_output_projection", "proj", "bias"])
    if recon == "drmsd":
        sched = tstate.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 5, 1e-3 / 30)
        step_sum = sum(sched(i) for i in range(5))
        for arr in (want[head], got[head]):
            assert np.abs(arr[6:]).max() <= 2 * step_sum
        want[head], got[head] = want[head][:6], got[head][:6]
    bad = {path: _rel_l2(got[path], w) for path, w in want.items()
           if _rel_l2(got[path], w) > 1e-4}
    assert not bad, bad


def test_export_matches_training_forward(trained, setup, tmp_path):
    """The materialized embed table equals JAX's within 1e-6; the export
    loads through ``load_vqvae`` (geometry and tensors as saved), and the
    standalone decoder on it reproduces the training-time bb_pred."""
    _, jres, tres, _, _ = trained
    *_, batch = setup
    jparams = jax.device_get(jres.params)
    want = np.asarray(jvq.materialize_decoder_params(jparams)
                      ["embed"]["embedding"])
    table = to_np(tvq.materialize_decoder_params(
        {k: torch.from_numpy(np.array(v))
         for k, v in flax_to_state_dict(jparams).items()})["embed.weight"])
    np.testing.assert_allclose(table, want, rtol=0, atol=1e-6)

    tvq.export_vqvae(tmp_path, ENC, DEC, tres.params)
    enc_cfg, enc_p, dec_cfg, dec_p = load_vqvae(tmp_path)
    assert (enc_cfg, dec_cfg) == (ENC, DEC)
    for k, v in enc_p.items():
        assert torch.equal(v, tres.params[f"encoder.{k}"]), k
    model = tvq.VQVAE(ENC, DEC)
    model.load_state_dict(tres.params)
    decoders = []
    for params in (dec_p, tvq.materialize_decoder_params(tres.params)):
        decoders.append(StructureTokenDecoder(dec_cfg))
        decoders[-1].load_state_dict(params, strict=True)
    with torch.no_grad():
        out, aux = model(torch.from_numpy(batch["coords"]),
                         torch.from_numpy(batch["lengths"]))
        loaded, alone = (d(aux["full_tokens"], compute_ptm=False)["bb_pred"]
                         for d in decoders)
    # the export as saved = the table in memory, bit for bit; against the
    # training-time forward, z + (z_q - z) differs from z_q by an ulp
    assert torch.equal(loaded, alone)
    bb = to_np(out["bb_pred"])
    assert np.abs(to_np(alone) - bb).max() <= 1e-6 * np.abs(bb).max()


def test_data_parallel_not_ported(setup):
    """data_parallel=True with no process group open and no torchrun
    environment is the one-process trainer, bit for bit (2 ranks:
    tests/test_torch_parallel.py)."""
    coords, lengths, *_ = setup
    runs = [tvq.train_vqvae(ENC, DEC, coords, lengths, steps=2, batch=2,
                            data_parallel=dp, device="cpu", log=None)
            for dp in (False, True)]
    assert runs[0].losses == runs[1].losses
    for k, v in runs[0].params.items():
        assert torch.equal(v, runs[1].params[k]), k
