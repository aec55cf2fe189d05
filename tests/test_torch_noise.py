"""The port's BERT-style MLM corruption (``sample_mask_rate``,
``get_inputs_for_mlm``) against the JAX package's, on the CPU, with JAX's
draws injected (each draw takes the next key of JAX's split, in JAX's
order): mask rates within 1e-6, the corrupted tokens, labels and masks
equal; and the default generator source's invariants."""

import jax
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.diffusion import noise as jnoise
from esmdiff_tpu_torch.diffusion import noise as tnoise

torch.set_num_threads(2)


class JaxMlmDraws:
    """JAX's draws as an ``MlmDraws``: ``split(key, n)`` and each call the
    next key (``sample_mask_rate``: beta then uniform, or one uniform;
    ``get_inputs_for_mlm``: three uniforms, then the random codes)."""

    def __init__(self, key, n):
        self.keys = list(jax.random.split(key, n))

    def _t(self, x):
        return torch.from_numpy(np.array(x))

    def uniform(self, shape=()):
        return self._t(jax.random.uniform(self.keys.pop(0), tuple(shape)))

    def beta(self, a, b):
        return self._t(jax.random.beta(self.keys.pop(0), float(a), float(b)))

    def codes(self, shape):
        return self._t(jax.random.randint(
            self.keys.pop(0), tuple(shape), 0, C.VQVAE_CODEBOOK_SIZE))


@pytest.mark.parametrize("schedule", ["beta", "linear", "cosine", "constant"])
def test_sample_mask_rate_equals_jax(schedule):
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = float(jnoise.sample_mask_rate(key, schedule))
        got = tnoise.sample_mask_rate(JaxMlmDraws(key, 2), schedule)
        assert float(got) == pytest.approx(want, rel=0, abs=1e-6)


def _tokens(rng, B=4, L=40):
    """Structure tokens with BOS/EOS, a pad tail and a chainbreak."""
    x = rng.randint(0, C.VQVAE_CODEBOOK_SIZE, (B, L)).astype(np.int32)
    x[:, 0], x[:, -1] = C.STRUCTURE_BOS_TOKEN, C.STRUCTURE_EOS_TOKEN
    x[1, 30:] = C.STRUCTURE_PAD_TOKEN
    x[2, 17] = C.STRUCTURE_CHAINBREAK_TOKEN
    return x


@pytest.mark.parametrize("rate", [0.15, 0.6, 1.0])
def test_get_inputs_for_mlm_equals_jax(rate):
    rng = np.random.RandomState(7)
    for seed in range(3):
        inputs = _tokens(rng)
        key = jax.random.PRNGKey(100 + seed)
        want = jnoise.get_inputs_for_mlm(key, inputs, rate)
        got = tnoise.get_inputs_for_mlm(JaxMlmDraws(key, 4),
                                        torch.from_numpy(inputs).long(), rate)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_generator_draws_keep_the_invariants():
    """The default source: seeded (the same seed, the same result),
    specials never masked, labels only where masked, every masked token
    MASK, a code or itself, rates inside the schedules' ranges, and the
    80/10/10 split near its expectation at rate 1."""
    rng = np.random.RandomState(3)
    inputs = torch.from_numpy(_tokens(rng, B=64, L=200)).long()
    outs = [tnoise.get_inputs_for_mlm(tnoise.MlmDraws("cpu", seed=5),
                                      inputs, 1.0) for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    out, labels, masked = outs[0]
    special = inputs >= C.VQVAE_CODEBOOK_SIZE
    assert not masked[special].any() and masked[~special].all()
    assert torch.equal(labels != -100, masked)
    assert torch.equal(labels[masked], inputs[masked])
    frac_mask = (out[masked] == C.STRUCTURE_MASK_TOKEN).float().mean()
    frac_same = (out[masked] == inputs[masked]).float().mean()
    assert abs(frac_mask - 0.8) < 0.02 and abs(frac_same - 0.1) < 0.02
    assert (out[masked] <= C.STRUCTURE_MASK_TOKEN).all()
    draws = tnoise.MlmDraws("cpu", seed=0)
    rates = torch.stack([tnoise.sample_mask_rate(draws, "beta")
                         for _ in range(2000)])
    assert 0.0 <= rates.min() and rates.max() <= 1.0
    # E[0.8 Beta(3, 9) + 0.2 U] = 0.8 / 4 + 0.1
    assert abs(rates.mean().item() - 0.3) < 0.01
    with pytest.raises(ValueError, match="Unknown"):
        tnoise.sample_mask_rate(draws, "nope")
    with pytest.raises(ValueError, match="integer"):
        draws.beta(2.5, 1)
