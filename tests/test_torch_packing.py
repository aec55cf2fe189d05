"""Sequence packing in the port (``esmdiff_tpu_torch/ops/packing.py``,
rotary ``positions``, the trunk's ``sequence_id``, ``pack`` in the
sampler) against the JAX package.

Counterpart of ``tests/test_packing.py``: the same seeded numpy inputs go
through both; the packed forward must match JAX's packed forward, and the
port's own unpacked forward on valid positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.diffusion import mdlm as jmdlm
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.nn import attention as jattn
from esmdiff_tpu.nn import rotary as jrot
from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep
from esmdiff_tpu.ops import packing as jpack
from esmdiff_tpu_torch.diffusion import mdlm as tmdlm
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn import attention as tattn
from esmdiff_tpu_torch.nn import rotary as trot
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder as TTimestep
from esmdiff_tpu_torch.ops import flash_attention as fa
from esmdiff_tpu_torch.ops import packing as tpack
from test_torch_support import carry, jax_ddpm_draws, perturb, to_np

torch.set_num_threads(2)


def test_pack_factor_matches_jax():
    for B in (1, 2, 4, 6, 8, 32, 64, 100):
        for L in (32, 64, 96, 128, 256):
            for target in (128, 256):
                assert tpack.pack_factor(B, L, target) == jpack.pack_factor(
                    B, L, target), (B, L, target)
    assert tpack.PACK_TARGET_LEN == jpack.PACK_TARGET_LEN


@pytest.mark.parametrize("lengths", [None, [64, 60, 1, 33, 64, 0, 2, 17]])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_packed_ids_and_positions_match_jax(lengths, k):
    L = 64
    ref = jpack.packed_segment_ids(
        None if lengths is None else np.asarray(lengths, np.int32), L, k)
    out = tpack.packed_segment_ids(
        None if lengths is None else torch.tensor(lengths), L, k)
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    np.testing.assert_array_equal(to_np(tpack.packed_positions(L, k)),
                                  np.asarray(jpack.packed_positions(L, k)))


def test_plan_segment_rows_matches_jax():
    rng = np.random.default_rng(0)
    for T in (128, 256):
        lens = list(rng.integers(3, T + 1, 40))
        assert tpack.plan_segment_rows(lens, T) == jpack.plan_segment_rows(
            lens, T)
    assert len(tpack.plan_segment_rows([60, 122, 252, 60, 122, 60],
                                       256)) == 3
    with pytest.raises(ValueError, match="exceeds row width"):
        tpack.plan_segment_rows([300], 256)


@pytest.mark.parametrize("batched", [False, True])
def test_rotary_positions_match_jax(batched):
    rng = np.random.default_rng(1)
    pos = (rng.integers(0, 50, (3, 40)) if batched
           else np.tile(np.arange(20), 2)).astype(np.int32)
    jc, js = jrot.rotary_tables(40, 16, positions=jnp.asarray(pos))
    tc, ts = trot.rotary_tables(40, 16, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), atol=1e-6)
    x = rng.standard_normal((3, 40, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(trot.apply_rotary(torch.from_numpy(x), tc, ts)),
        np.asarray(jrot.apply_rotary(jnp.asarray(x), jc, js)), atol=1e-6)


def test_sequence_id_mask_takes_the_plain_path(monkeypatch):
    """Under "auto" a sequence_id mask goes to plain_attention, as JAX's
    goes to _xla_attention; the kernel is never called."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("the flash kernel took a mask")

    monkeypatch.setattr(fa, "flash_attention", no_kernel)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    sid = np.repeat(np.array([[0, 1], [0, -1]]), 8, axis=1).astype(np.int32)
    ref = jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)),
        mask=jattn.sequence_id_mask(jnp.asarray(sid)))
    out = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        mask=tattn.sequence_id_mask(torch.from_numpy(sid)))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=1e-6)


@pytest.fixture(scope="module")
def tiny_trunk():
    """A tiny float32 JAX trunk (perturbed params) and the port's copy."""
    cfg = jesm3.esm3_tiny(dtype="float32", head_type="structure")
    net = jesm3.ESM3(cfg)
    params = jax.jit(lambda key: net.init(
        key, sequence_tokens=jnp.full((1, 8), 5, jnp.int32),
        structure_coords=jnp.zeros((1, 8, 3, 3))))(
            jax.random.PRNGKey(0))["params"]
    params = perturb(params, 3, 0.05)
    trunk = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                             head_type="structure")), params)
    return net, params, trunk


@pytest.mark.parametrize("k", [2, 4])
def test_packed_forward_matches_jax_and_unpacked(tiny_trunk, k):
    net, params, trunk = tiny_trunk
    B, L = 4, 32
    rng = np.random.default_rng(4)
    seq = rng.integers(4, 24, (B, L)).astype(np.int32)
    lengths = np.array([32, 20, 7, 32], np.int32)
    sid = jpack.packed_segment_ids(lengths, L, k)
    pos = jpack.packed_positions(L, k)
    ref = jax.jit(net.apply)({"params": params},
                             sequence_tokens=jnp.asarray(seq).reshape(
                                 B // k, k * L),
                             sequence_id=sid, positions=pos)
    with torch.no_grad():
        out = trunk(sequence_tokens=torch.from_numpy(seq).long().reshape(
                        B // k, k * L),
                    sequence_id=tpack.packed_segment_ids(
                        torch.from_numpy(lengths), L, k),
                    positions=tpack.packed_positions(L, k))
        unpacked = trunk(sequence_tokens=torch.from_numpy(seq).long(),
                         lengths=torch.from_numpy(lengths))
    packed = to_np(out.structure_logits)
    np.testing.assert_allclose(packed, np.asarray(ref.structure_logits),
                               atol=1e-4)
    packed = packed.reshape(B, L, -1)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(packed[b, :n],
                                   to_np(unpacked.structure_logits)[b, :n],
                                   atol=1e-5)


def test_trunk_rejects_sequence_id_with_lengths(tiny_trunk):
    _, _, trunk = tiny_trunk
    toks = torch.full((2, 8), 5)
    with pytest.raises(ValueError, match="not both"):
        trunk(sequence_tokens=toks, sequence_id=torch.zeros(2, 8),
              lengths=torch.tensor([8, 4]))


@pytest.fixture(scope="module")
def tiny_mdlm(tiny_trunk):
    net, params, trunk = tiny_trunk
    jsig = JTimestep(hidden_size=64, dtype=jnp.float32)
    sig_params = perturb(jax.jit(jsig.init)(
        jax.random.PRNGKey(1), jnp.zeros((1,), jnp.float32))["params"],
        5, 0.05)
    jm = jmdlm.MDLM(net, jsig)
    tm = tmdlm.MDLM(trunk, carry(TTimestep(64, dtype=torch.float32),
                                 sig_params))
    return jm, {"net": params, "sigma_embedder": sig_params}, tm


def test_ddpm_sample_pack_tokens(tiny_mdlm):
    """pack 2 gives pack 1's tokens, and with JAX's draws injected, JAX's
    own pack-2 tokens."""
    jm, params, tm = tiny_mdlm
    B, L, steps = 4, 32, 4
    rng = np.random.default_rng(6)
    lengths = np.array([32, 20, 32, 9], np.int32)
    seq = np.full((B, L), C.SEQUENCE_PAD_TOKEN, np.int32)
    for b, n in enumerate(lengths):
        seq[b, 0], seq[b, n - 1] = C.SEQUENCE_BOS_TOKEN, C.SEQUENCE_EOS_TOKEN
        seq[b, 1:n - 1] = rng.integers(4, 24, n - 2)
    prior = np.where(seq == C.SEQUENCE_PAD_TOKEN, C.STRUCTURE_PAD_TOKEN,
                     C.STRUCTURE_MASK_TOKEN).astype(np.int32)
    row_keys = jax.random.split(jax.random.PRNGKey(9), B)
    ref = jax.jit(lambda p: jm.ddpm_sample(
        p, None, jnp.asarray(seq), num_steps=steps,
        input_prior=jnp.asarray(prior), lengths=jnp.asarray(lengths),
        pack=2, row_keys=row_keys))(params)

    def sample(pack):
        return to_np(tm.ddpm_sample(
            torch.from_numpy(seq), num_steps=steps,
            input_prior=torch.from_numpy(prior),
            lengths=torch.from_numpy(lengths), pack=pack,
            noise_source=jax_ddpm_draws(row_keys, L,
                                        C.STRUCTURE_VOCAB_SIZE)))

    packed = sample(2)
    np.testing.assert_array_equal(packed, sample(1))
    np.testing.assert_array_equal(packed, np.asarray(ref))


def test_forward_logits_pack_rejects_explicit_sequence_id(tiny_mdlm):
    _, _, tm = tiny_mdlm
    x = torch.full((2, 8), C.STRUCTURE_MASK_TOKEN)
    with pytest.raises(ValueError, match="incompatible"):
        tm.forward_logits(x, torch.full((2, 8), 5), torch.ones(2, 1),
                          sequence_id=torch.zeros(2, 8), pack=2)
