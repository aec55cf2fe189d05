"""Shared helpers for the PyTorch port's parity tests (no tests here).

The JAX package is the reference: the same numpy inputs go through a JAX
function and its counterpart in ``esmdiff_tpu_torch``; weights travel from
``jax.device_get`` of the flax params through ``esmdiff_tpu_torch.convert``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from esmdiff_tpu_torch.convert import load_flax_params

torch.set_num_threads(2)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def perturb(tree, seed: int = 0, scale: float = 0.1):
    """Host copy of a flax param tree with every leaf moved off its init
    value (LayerNorm scales off 1, biases off 0), so that no parameter can
    be silently dropped by the carry-over."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        a = np.asarray(t, np.float32)
        return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(jax.device_get(tree))


def carry(torch_module, flax_params):
    """Load flax params into a float32 CPU torch module, strictly."""
    return load_flax_params(torch_module.float(), jax.device_get(flax_params))


def carry_encoder(jrt):
    """The port's structure encoder, carried over from a JAX
    ``ESM3Runtime``'s (same config fields)."""
    from esmdiff_tpu_torch.models.vqvae import (EncoderConfig,
                                                StructureTokenEncoder)

    cfg = EncoderConfig(**dataclasses.asdict(jrt.encoder.cfg))
    return carry(StructureTokenEncoder(cfg), jrt.encoder_params)


def jax_ddpm_draws(row_keys, L: int, V: int):
    """The draws ``esmdiff_tpu`` ``MDLM.ddpm_sample`` makes, as a noise
    source for the port: per-position keys ``fold_in(row_key, pos)``
    (``position_keys``), then per step ``fold_in(key, step)`` split into a
    token key (-> ``jax.random.gumbel((V,))``) and a stay key (->
    ``jax.random.uniform(())``)."""
    from esmdiff_tpu.diffusion.mdlm import position_keys

    row_keys = jnp.asarray(row_keys, jnp.uint32)
    B = row_keys.shape[0]
    pos_keys = position_keys(row_keys, L)
    fold2 = jax.vmap(jax.vmap(jax.random.fold_in))

    @jax.jit
    def draws(step):
        ks = fold2(pos_keys, jnp.full((B, L), step, jnp.int32))
        k_tok = fold2(ks, jnp.zeros((B, L), jnp.int32))
        k_stay = fold2(ks, jnp.ones((B, L), jnp.int32))
        g = jax.vmap(jax.vmap(
            lambda k: jax.random.gumbel(k, (V,), jnp.float32)))(k_tok)
        u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, ())))(k_stay)
        return g, u

    def source(step):
        g, u = draws(step)
        return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(u))

    return source


def jax_request_noise_factory(rows, L, V, device):
    """Noise factory for the port's EnsembleSampler that reproduces the JAX
    sampler's draws: row (seed, j) gets ``request_row_keys(seed, ...)[j]``
    = ``fold_in(PRNGKey(seed), j)``."""
    keys = np.stack([
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(int(s)), int(j)))
        for s, j in rows])
    return jax_ddpm_draws(keys, L, V)


def jax_unmask_uniforms(row_keys, L: int, V: int):
    """The draws ``esmdiff_tpu`` ``iterative_unmask_sample`` and
    ``entropy_bounded_unmask_sample`` make, as a uniform source for the
    port: per step ``uniform(fold_in(row_key, step), (L, V))`` a row."""
    row_keys = jnp.asarray(row_keys, jnp.uint32)

    @jax.jit
    def draws(step):
        ks = jax.vmap(lambda rk: jax.random.fold_in(rk, step))(row_keys)
        return jax.vmap(lambda k: jax.random.uniform(k, (L, V)))(ks)

    def source(step):
        return torch.from_numpy(np.array(draws(jnp.int32(step))))

    return source


def jax_request_uniform_factory(rows, L, V, device):
    """Uniform factory for the port's EnsembleSampler that reproduces the
    JAX gibbs and eb engines' draws: row (seed, j) gets
    ``request_row_keys(seed, ...)[j]`` = ``fold_in(PRNGKey(seed), j)``."""
    keys = np.stack([
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(int(s)), int(j)))
        for s, j in rows])
    return jax_unmask_uniforms(keys, L, V)


class JaxLossDraws:
    """The draws ``esmdiff_tpu`` ``MDLM.loss`` (``packed=False``) or
    ``MDLM.loss_packed`` (``packed=True``) makes from ``key``, as a draw
    source for the port's loss: ``split(key, 4)`` into the dropout,
    condition-mask, time and move keys; the packed loss splits the time key
    again into the time and permutation keys."""

    def __init__(self, key, packed: bool = False):
        self.k_drop, self.k_cmask, self.k_t, self.k_q = jax.random.split(
            key, 4)
        self.k_perm = None
        if packed:
            self.k_t, self.k_perm = jax.random.split(self.k_t)

    @staticmethod
    def _t(x):
        return torch.from_numpy(np.array(x))

    def dropout(self):
        return self._t(jax.random.uniform(self.k_drop))

    def condition_mask(self, shape):
        return self._t(jax.random.uniform(self.k_cmask, tuple(shape)))

    def times(self, n):
        return self._t(jax.random.uniform(self.k_t, (n,)))

    def permutation(self, n):
        return self._t(jax.random.permutation(self.k_perm, n)).long()

    def move(self, shape):
        return self._t(jax.random.uniform(self.k_q, tuple(shape)))
