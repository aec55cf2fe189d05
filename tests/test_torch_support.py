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


# -- multi-rank parity (tests/test_torch_parallel.py, test_torch_tp.py,
# test_torch_multihost.py) ----------------------------------------------------

TINY_TRUNK = dict(dtype="float32", head_type="structure",
                  n_structure_heads=4101)
STEP_OPTIM = dict(lr=1e-3, weight_decay=0.5, warmup_steps=1, grad_clip=1.0)
STEP_KEYS = (20, 21, 22)


def jax_tiny_mdlm():
    """The JAX tiny MDLM (float32, structure head) and its
    ``init(PRNGKey(0))`` params on the host."""
    from esmdiff_tpu.diffusion import mdlm as jmdlm
    from esmdiff_tpu.diffusion.noise import LogLinearNoise as JNoise
    from esmdiff_tpu.models import esm3 as jesm3
    from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep

    cfg = jesm3.esm3_tiny(**TINY_TRUNK)
    jm = jmdlm.MDLM(jesm3.ESM3(cfg),
                    JTimestep(hidden_size=cfg.d_model, dtype=jnp.float32),
                    noise=JNoise(), cfg=jmdlm.MDLMConfig())
    return jm, jax.device_get(jm.init(jax.random.PRNGKey(0)))


def jax_strategy_run(jm, params, batch, strategy: str, packed_segments=0,
                     keys=STEP_KEYS, optim=STEP_OPTIM):
    """JAX's sharded train step under ``strategy`` (ddp | zero2 | fsdp on a
    2-device data mesh, dpNxtpM on the 2-D mesh, dpNxppS / ppS on the
    (data, stage) mesh with the automatic M, as its trainer builds them),
    one step a key: (losses, grad norms, final params as the port's state
    dict)."""
    from esmdiff_tpu.parallel import mesh as jmesh
    from esmdiff_tpu.parallel import pp as jpp
    from esmdiff_tpu.parallel import tp as jtp
    from esmdiff_tpu.train import state as jstate
    from esmdiff_tpu_torch.convert import flax_to_state_dict

    shape = jtp.parse_tp_strategy(strategy)
    pp_shape = jpp.parse_pp_strategy(strategy)
    n_valid = None
    if pp_shape:
        B = len(next(iter(batch.values())))
        mesh = jpp.make_pp_mesh(*pp_shape)
        jm.trunk_apply = jpp.mdlm_pp_trunk_apply(
            jm.net, mesh, jpp.auto_microbatches(B // pp_shape[0],
                                                pp_shape[1]))
        params, n_valid = jpp.pad_tree_blocks(params, pp_shape[1])
    else:
        mesh = (jtp.make_2d_mesh(*shape) if shape else jmesh.make_mesh(2))
    opt = jstate.make_optimizer(**optim)
    if packed_segments:
        def loss(p, b, k):
            return jm.loss_packed(p, b, k, max_segments=packed_segments)
    else:
        def loss(p, b, k):
            return jm.loss(p, b, k)
    losses, norms = [], []
    try:
        with mesh:
            state = jstate.create_sharded_train_state(params, opt, mesh,
                                                      strategy=strategy)
            sb = (jtp.shard_batch_2d(batch, mesh) if shape
                  else jmesh.shard_batch(batch, mesh))
            step = jstate.make_train_step(loss, opt, mesh=mesh,
                                          donate=False)
            for k in keys:
                state, m = step(state, sb, jax.random.PRNGKey(k))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
    finally:
        jm.trunk_apply = None
    final = jax.device_get(state.params)
    if n_valid is not None:
        final = jpp.unpad_tree_blocks(final, n_valid)
    return losses, norms, flax_to_state_dict(final)


def record_step_draws(batch, keys=STEP_KEYS, packed_segments=0):
    """The draws JAX's loss makes from each key on ``batch`` (the global
    batch), as ``RecordedDraws`` records, one list a key."""
    from esmdiff_tpu_torch.diffusion.mdlm import RecordedDraws
    from esmdiff_tpu_torch.train.loop import to_device
    from torch_ranks import tiny_mdlm

    tm = tiny_mdlm()
    tb = to_device(batch, "cpu")
    records = []
    with torch.no_grad():
        for k in keys:
            d = RecordedDraws(source=JaxLossDraws(
                jax.random.PRNGKey(k), packed=bool(packed_segments)))
            if packed_segments:
                tm.loss_packed(tb, d, max_segments=packed_segments)
            else:
                tm.loss(tb, d)
            records.append(d.records)
    return records


def one_rank_steps(params_path, batch, records, packed_segments=0,
                   optim=STEP_OPTIM, param_dtype=None):
    """The port's steps on one process, no group: (losses, grad norms,
    final state dict)."""
    from esmdiff_tpu_torch.diffusion.mdlm import RecordedDraws
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.loop import (cast_params, mdlm_modules,
                                              to_device)
    from torch_ranks import tiny_mdlm

    tm = tiny_mdlm(params_path)
    modules = mdlm_modules(tm)
    if param_dtype is not None:
        cast_params(modules, param_dtype)
    state = tstate.create_train_state(modules, tstate.make_optimizer(
        modules.parameters(), **optim))
    tb = to_device(batch, "cpu")
    losses, norms = [], []
    for rec in records:
        if packed_segments:
            def loss(b, d):
                return tm.loss_packed(b, d, max_segments=packed_segments)
        else:
            def loss(b, d):
                return tm.loss(b, d)
        m = tstate.train_step(state, loss, tb, RecordedDraws(records=rec))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, {k: v.clone() for k, v in
                           modules.state_dict().items()}


def assert_state_close(got: dict, want: dict, rtol=1e-5, atol=1e-5):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(to_np(got[k]), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=k)
