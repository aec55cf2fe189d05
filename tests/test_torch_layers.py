"""Port layers (``esmdiff_tpu_torch.nn``) against their flax modules, fp32,
same numpy inputs and carried-over weights, at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.nn import embed as jembed
from esmdiff_tpu.nn import layers as jl
from esmdiff_tpu.nn import rotary as jrot
from esmdiff_tpu_torch.nn import embed as tembed
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.nn import rotary as trot
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ATOL = 1e-5
F32 = torch.float32
B, L, D, H = 2, 24, 64, 4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(flax_mod, torch_mod, *inputs):
    """Init the flax module, perturb its params, carry them to torch, and
    return both outputs."""
    params = perturb(flax_mod.init(jax.random.PRNGKey(0), *inputs)["params"])
    ref = flax_mod.apply({"params": params}, *inputs)
    carry(torch_mod, params)
    return ref, params


@pytest.mark.parametrize("use_bias", [False, True])
def test_layer_norm(use_bias):
    x = _x((B, L, D))
    ref, _ = _pair(jl.LayerNorm(use_bias=use_bias),
                   mod := tl.LayerNorm(D, use_bias=use_bias), jnp.asarray(x))
    out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


def test_rotary():
    cos_j, sin_j = jrot.rotary_tables(L, 16)
    cos_t, sin_t = trot.rotary_tables(L, 16)
    np.testing.assert_allclose(to_np(cos_t), np.asarray(cos_j), atol=ATOL)
    np.testing.assert_allclose(to_np(sin_t), np.asarray(sin_j), atol=ATOL)
    x = _x((B, L, H, 16))
    ref = jrot.apply_rotary(jnp.asarray(x), cos_j, sin_j)
    out = trot.apply_rotary(torch.from_numpy(x), cos_t, sin_t)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_multi_head_attention(with_lengths):
    x = _x((B, L, D))
    cos_j, sin_j = jrot.rotary_tables(L, D // H)
    lengths = np.array([L, 13], np.int32) if with_lengths else None
    fmod = jl.MultiHeadAttention(d_model=D, n_heads=H, dtype=jnp.float32)
    params = perturb(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x), cos_j,
                               sin_j)["params"])
    ref = fmod.apply({"params": params}, jnp.asarray(x), cos_j, sin_j,
                     lengths=None if lengths is None else jnp.asarray(lengths))
    mod = carry(tl.MultiHeadAttention(D, H, dtype=F32), params)
    cos_t, sin_t = trot.rotary_tables(L, D // H)
    out = mod(torch.from_numpy(x), cos_t, sin_t,
              lengths=None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


def test_swiglu_ffn():
    x = _x((B, L, D))
    hidden = tl.swiglu_hidden_dim(D)
    assert hidden == jl.swiglu_hidden_dim(D)
    assert tl.swiglu_hidden_dim(1536) == 4096
    ref, _ = _pair(jl.SwiGLUFFN(d_model=D, hidden=hidden, dtype=jnp.float32),
                   mod := tl.SwiGLUFFN(D, hidden, dtype=F32), jnp.asarray(x))
    np.testing.assert_allclose(to_np(mod(torch.from_numpy(x))),
                               np.asarray(ref), atol=ATOL)


def test_regression_head():
    x = _x((B, L, D))
    ref, _ = _pair(jl.RegressionHead(output_dim=50, dtype=jnp.float32),
                   mod := tl.RegressionHead(D, 50, dtype=F32), jnp.asarray(x))
    np.testing.assert_allclose(to_np(mod(torch.from_numpy(x))),
                               np.asarray(ref), atol=ATOL)


def test_timestep_embedder():
    t = np.array([0.0, 0.37, 6.9], np.float32)
    ref, _ = _pair(jl.TimestepEmbedder(hidden_size=D, dtype=jnp.float32),
                   mod := tl.TimestepEmbedder(D, dtype=F32), jnp.asarray(t))
    np.testing.assert_allclose(to_np(mod(torch.from_numpy(t))),
                               np.asarray(ref), atol=ATOL)


def test_encode_inputs():
    rng = np.random.default_rng(3)
    seq = rng.integers(0, C.SEQUENCE_VOCAB_SIZE, (B, L))
    st = rng.integers(0, C.STRUCTURE_VOCAB_SIZE, (B, L))
    avg = rng.random((B, L)).astype(np.float32)
    per = rng.random((B, L)).astype(np.float32)
    ss8 = rng.integers(0, C.SS8_VOCAB_SIZE, (B, L))
    sasa = rng.integers(0, C.SASA_VOCAB_SIZE, (B, L))
    fn = rng.integers(0, C.FUNCTION_VOCAB_SIZE, (B, L, C.FUNCTION_TOKEN_DEPTH))
    res = rng.integers(0, 4, (B, L, C.RESIDUE_ANNOTATION_DEPTH))  # has pads
    ins = (seq, st, avg, per, ss8, sasa, fn, res)
    ref, _ = _pair(jembed.EncodeInputs(D, dtype=jnp.float32),
                   mod := tembed.EncodeInputs(D, dtype=F32),
                   *(jnp.asarray(a) for a in ins))
    out = mod(*(torch.from_numpy(a) for a in ins))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)
