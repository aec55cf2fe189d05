"""Port noise schedules and ddpm sampler against the JAX package.

With JAX's own draws injected as the noise source, the port's
``ddpm_sample`` must give the SAME tokens as ``MDLM.ddpm_sample(pack=1,
row_keys=...)`` on the tiny model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.diffusion import mdlm as jmdlm
from esmdiff_tpu.diffusion import noise as jnoise
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep
from esmdiff_tpu_torch.diffusion import mdlm as tmdlm
from esmdiff_tpu_torch.diffusion import noise as tnoise
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder as TTimestep
from test_torch_support import carry, jax_ddpm_draws, perturb, to_np

torch.set_num_threads(2)


@pytest.mark.parametrize("name", sorted(tnoise.NOISE_REGISTRY))
def test_noise_schedules(name):
    t = np.linspace(0.0, 0.999, 9).astype(np.float32)
    js, jr = jnoise.get_noise(name)(jnp.asarray(t))
    ts, tr = tnoise.get_noise(name)(torch.from_numpy(t))
    np.testing.assert_allclose(to_np(ts), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(tr), np.asarray(jr), rtol=1e-5,
                               atol=1e-6)


def test_shield_special_tokens():
    z = np.random.default_rng(0).standard_normal(
        (2, 3, C.STRUCTURE_VOCAB_SIZE)).astype(np.float32)
    ref = jmdlm.shield_special_tokens(jnp.asarray(z))
    out = tmdlm.shield_special_tokens(torch.from_numpy(z.copy()))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))


def test_ddpm_sample_tokens_equal_with_jax_noise():
    B, L, steps = 3, 24, 6
    lengths = np.array([24, 17, 24], np.int32)
    rng = np.random.default_rng(0)
    seq = np.full((B, L), C.SEQUENCE_PAD_TOKEN, np.int32)
    for b, n in enumerate(lengths):
        seq[b, 0], seq[b, n - 1] = C.SEQUENCE_BOS_TOKEN, C.SEQUENCE_EOS_TOKEN
        seq[b, 1:n - 1] = rng.integers(4, 24, n - 2)
    prior = np.where(seq == C.SEQUENCE_PAD_TOKEN, C.STRUCTURE_PAD_TOKEN,
                     C.STRUCTURE_MASK_TOKEN).astype(np.int32)
    cfg = jesm3.esm3_tiny(dtype="float32", head_type="structure")
    jm = jmdlm.MDLM(jesm3.ESM3(cfg), JTimestep(hidden_size=cfg.d_model,
                                               dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0), batch_size=1, length=8)
    params = {"net": perturb(params["net"], 1, 0.05),
              "sigma_embedder": perturb(params["sigma_embedder"], 2, 0.05)}
    row_keys = jax.random.split(jax.random.PRNGKey(7), B)
    ref = jm.ddpm_sample(params, None, jnp.asarray(seq), num_steps=steps,
                         input_prior=jnp.asarray(prior),
                         lengths=jnp.asarray(lengths), pack=1,
                         row_keys=row_keys)

    net = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                           head_type="structure")),
                params["net"])
    sig = carry(TTimestep(cfg.d_model, dtype=torch.float32),
                params["sigma_embedder"])
    out = tmdlm.MDLM(net, sig).ddpm_sample(
        torch.from_numpy(seq), num_steps=steps,
        input_prior=torch.from_numpy(prior),
        lengths=torch.from_numpy(lengths),
        noise_source=jax_ddpm_draws(row_keys, L, C.STRUCTURE_VOCAB_SIZE))
    ref = np.asarray(ref)
    assert (ref[seq != C.SEQUENCE_PAD_TOKEN] < C.VQVAE_CODEBOOK_SIZE).all()
    np.testing.assert_array_equal(to_np(out), ref)


def test_row_generator_noise_is_per_row_deterministic():
    a = tmdlm.RowGeneratorNoise([11, 12], 5, 7, "cpu")
    b = tmdlm.RowGeneratorNoise([12], 5, 7, "cpu")
    ga, ua = a(0)
    gb, ub = b(0)
    assert ga.shape == (2, 5, 7) and ua.shape == (2, 5)
    assert torch.isfinite(ga).all()
    # a row's draws depend on its own seed only, not on its batch mates
    np.testing.assert_array_equal(to_np(ga[1]), to_np(gb[0]))
    np.testing.assert_array_equal(to_np(ua[1]), to_np(ub[0]))
    assert not np.array_equal(to_np(ga[0]), to_np(ga[1]))
