"""Port ``small_attention`` (rotary fused into attention) and the
``attn_backend`` branches of ``MultiHeadAttention`` against the JAX
package: its Pallas kernel in interpret mode and its flax module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.nn import layers as jl
from esmdiff_tpu.nn import rotary as jrot
from esmdiff_tpu.ops.small_attention import small_attention as jax_small
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.nn import rotary as trot
from esmdiff_tpu_torch.ops import small_attention as sa
from test_torch_attention import assert_bf16_grads_match
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ATOL = 2e-5       # fp32, same inputs: only reduction order differs
ATOL_BF16 = 3e-2  # bf16: both round q, k and p at the same points


def _qkv(B, L, H=2, Dh=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, Dh)).astype(np.float32)
            for _ in range(3)]


def _both(L, Dh=64):
    cos_j, sin_j = jrot.rotary_tables(L, Dh)
    cos_t, sin_t = trot.rotary_tables(L, Dh)
    return (cos_j, sin_j), (cos_t, sin_t)


@pytest.mark.parametrize("L,lengths", [
    (64, (64, 50, 0)),        # ragged, one empty row (the mean of V)
    (128, (128, 100, 3)),
    (64, None),               # no lengths: every key
])
def test_plain_matches_jax_kernel(L, lengths):
    q, k, v = _qkv(3, L)
    (cos_j, sin_j), (cos_t, sin_t) = _both(L)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = jax_small(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cos_j,
                    sin_j, lens_j)
    launches = sa.launches
    out = sa.small_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cos_t,
        sin_t, None if lengths is None else torch.tensor(lengths))
    assert sa.launches == launches  # a CPU tensor never launches the kernel
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


def test_plain_matches_jax_kernel_bf16():
    L, lengths = 64, (64, 31)
    q, k, v = _qkv(2, L, H=3, seed=1)
    (cos_j, sin_j), (cos_t, sin_t) = _both(L)
    ref = jax_small(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    cos_j, sin_j, jnp.asarray(lengths, jnp.int32))
    out = sa.small_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        cos_t, sin_t, torch.tensor(lengths))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out.float()),
                               np.asarray(ref, np.float32), atol=ATOL_BF16)


def test_gradient_parity_with_jax():
    L = 64
    q, k, v = _qkv(2, L, seed=2)
    (cos_j, sin_j), (cos_t, sin_t) = _both(L)
    lengths = (64, 30)

    def loss(q, k, v):
        return jnp.sum(jax_small(q, k, v, cos_j, sin_j,
                                 jnp.asarray(lengths, jnp.int32)) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = sa.SmallAttentionFunction.apply(*ins, cos_t, sin_t,
                                          torch.tensor(lengths))
    grads = torch.autograd.grad((out ** 2).sum(), ins)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=5e-5)


def test_bf16_gradients_match_jax():
    """The backward recomputes rotary and then plain_attention (p
    normalised, then cast), as JAX's custom_vjp recomputes through
    _xla_reference; the recompute's rotary promotes each term on its own,
    as JAX does, so the bf16 rounding of dq and dk matches too."""
    L, lengths = 64, np.array([64, 29], np.int32)
    q, k, v = _qkv(2, L, H=3, seed=4)
    g = _qkv(2, L, H=3, seed=5)[0]
    (cos_j, sin_j), (cos_t, sin_t) = _both(L)
    _, vjp = jax.vjp(lambda *a: jax_small(*a, cos_j, sin_j,
                                          jnp.asarray(lengths),
                                          interpret=True),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
           for a in (q, k, v)]
    out = sa.SmallAttentionFunction.apply(*ins, cos_t, sin_t,
                                          torch.from_numpy(lengths))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g).to(
        torch.bfloat16))
    assert_bf16_grads_match(grads, ref)


@pytest.mark.parametrize("port_backend,jax_backend", [
    ("small", "small"), ("auto", "auto"), ("flash", "auto"), ("xla", "xla"),
])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_module_branch_matches_flax(port_backend, jax_backend, with_lengths):
    B, L, D, H = 2, 24, 64, 4
    x = np.random.default_rng(3).standard_normal((B, L, D)).astype(np.float32)
    (cos_j, sin_j), (cos_t, sin_t) = _both(L, D // H)
    lengths = np.array([L, 13], np.int32) if with_lengths else None
    fmod = jl.MultiHeadAttention(d_model=D, n_heads=H, dtype=jnp.float32,
                                 attn_backend=jax_backend)
    params = perturb(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x), cos_j,
                               sin_j)["params"])
    ref = fmod.apply({"params": params}, jnp.asarray(x), cos_j, sin_j,
                     lengths=None if lengths is None else jnp.asarray(lengths))
    mod = carry(tl.MultiHeadAttention(D, H, dtype=torch.float32,
                                      attn_backend=port_backend), params)
    with torch.no_grad():
        out = mod(torch.from_numpy(x), cos_t, sin_t,
                  lengths=None if lengths is None
                  else torch.from_numpy(lengths))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("field,value", [
    ("attn_backend", "fast"), ("attn_backend", "Small"),
    ("qkv_backend", "pallas"), ("qkv_backend", ""),
])
def test_unknown_backend_raises(field, value):
    with pytest.raises(ValueError, match=field):
        tl.MultiHeadAttention(64, 4, **{field: value})
    with pytest.raises(ValueError, match=field):
        tesm3.ESM3(tesm3.esm3_tiny(**{field: value}))


def test_config_reaches_every_block():
    cfg = tesm3.esm3_tiny(attn_backend="small", qkv_backend="fused")
    trunk = tesm3.ESM3(cfg)
    assert all(b.attn.attn_backend == "small" and b.attn.qkv_backend == "fused"
               for b in trunk.transformer.blocks)
    default = tesm3.ESM3(tesm3.esm3_tiny())
    assert all(b.attn.attn_backend == "auto" and b.attn.qkv_backend == "xla"
               for b in default.transformer.blocks)

