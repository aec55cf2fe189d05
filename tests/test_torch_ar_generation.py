"""The port's AR generation (``esmdiff_tpu_torch/api/ar_generation.py``)
against the JAX package's on the CPU in float32: the sampling primitives,
then ``clm_generate`` and ``jlm_generate`` token for token with JAX's
uniforms injected (JAX splits one key a step; the port reads step s's
(B, V) uniform from its draw source), at top_p 0.9 and 0.95, and the
default draws' independence of batching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.api import ar_generation as jar
from esmdiff_tpu.core import constants as C
from esmdiff_tpu_torch.api import ar_generation as tar
from esmdiff_tpu_torch.api.generation import request_row_seeds
from test_torch_clm import COND, Pair as CLMPair
from test_torch_jlm import Pair as JLMPair
from test_torch_support import to_np

torch.set_num_threads(2)

B, LENC, V = 3, 10, C.STRUCTURE_VOCAB_SIZE


def jax_step_uniforms(key, steps: int, B: int):
    """The (B, V) uniforms JAX's generate draws, step by step: each step
    splits the running key and draws from the second half."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.array(jax.random.uniform(k, (B, V))))
    return out


def _source(uniforms):
    return lambda step: torch.from_numpy(uniforms[step])


def _embeddings(seed):
    return np.random.default_rng(seed).standard_normal(
        (B, LENC, COND)).astype(np.float32)


@pytest.mark.parametrize("top_p", [0.9, 0.95, 1.0])
def test_sample_token_matches_jax(top_p):
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((4, V))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jar._sample_token(key, jar._shield_specials(jnp.asarray(logits)),
                            1.3, top_p)
    u = np.array(jax.random.uniform(key, (4, V)))
    got = tar.sample_token(torch.from_numpy(u),
                           tar.shield_specials(torch.from_numpy(logits)),
                           1.3, top_p)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    np.testing.assert_array_equal(
        to_np(tar.shield_specials(torch.from_numpy(logits))),
        np.asarray(jar._shield_specials(jnp.asarray(logits))))


@pytest.fixture(scope="module")
def clm_pairs():
    return {v: CLMPair(v) for v in ("plain", "dec_add_input_emb")}


@pytest.fixture(scope="module")
def jlm_pairs():
    return {s: JLMPair(s) for s in ("sentence", "position")}


@pytest.mark.parametrize("top_p", [0.9, 0.95])
@pytest.mark.parametrize("variant", ["plain", "dec_add_input_emb"])
def test_clm_generate_matches_jax(clm_pairs, variant, top_p):
    pair = clm_pairs[variant]
    emb = _embeddings(1)
    att = np.ones((B, LENC), np.float32)
    att[1, -3:] = 0.0
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jar.clm_generate(
        pair.jmodel, pair.params, jnp.asarray(emb), LENC, 1.0, top_p,
        key=key, attention_mask=jnp.asarray(att)))
    got = tar.clm_generate(
        pair.torch, torch.from_numpy(emb), LENC, 1.0, top_p,
        draws=_source(jax_step_uniforms(key, LENC, B)),
        attention_mask=torch.from_numpy(att))
    np.testing.assert_array_equal(to_np(got), ref)
    assert (ref < C.VQVAE_CODEBOOK_SIZE).all()


@pytest.mark.parametrize("top_p", [0.9, 0.95])
@pytest.mark.parametrize("sep", ["sentence", "position"])
def test_jlm_generate_matches_jax(jlm_pairs, sep, top_p):
    pair = jlm_pairs[sep]
    emb = np.random.default_rng(2).standard_normal(
        (B, 9, COND)).astype(np.float32)
    length = 8
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jar.jlm_generate(pair.jmodel, pair.params,
                                      jnp.asarray(emb), length, 1.0, top_p,
                                      key=key))
    got = tar.jlm_generate(pair.torch, torch.from_numpy(emb), length, 1.0,
                           top_p, draws=_source(jax_step_uniforms(
                               key, length, B)))
    np.testing.assert_array_equal(to_np(got), ref)
    assert (ref < C.VQVAE_CODEBOOK_SIZE).all()


def test_row_draws_do_not_depend_on_batching():
    """Sample j of a request draws from (seed, j) alone: its uniforms are
    the same alone and inside a batch, and differ from sample j+1's."""
    rows = np.array([[7, 0], [7, 1], [7, 2]])
    batch = tar.RowGeneratorDraws(request_row_seeds(rows), 4, V, "cpu")
    for j in range(3):
        solo = tar.RowGeneratorDraws(request_row_seeds(rows[j:j + 1]), 4, V,
                                     "cpu")
        for step in range(4):
            torch.testing.assert_close(solo(step)[0], batch(step)[j],
                                       rtol=0, atol=0)
    assert not torch.equal(batch(0)[0], batch(0)[1])
    assert ((batch.table >= 0) & (batch.table < 1)).all()
