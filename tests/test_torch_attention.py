"""Port attention (plain version + dispatcher + kernel wrapper) against the
JAX package's flash kernel (interpret mode) and its ``_xla_attention``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.nn.attention import _xla_attention
from esmdiff_tpu.ops.flash_attention import flash_attention as jax_flash
from esmdiff_tpu_torch.nn import attention as port_attn
from esmdiff_tpu_torch.ops import flash_attention as fa
from test_torch_support import to_np

torch.set_num_threads(2)

ATOL = 2e-5  # fp32, same inputs: only reduction order differs


def _qkv(B, L, H=2, Dh=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, Dh)).astype(np.float32)
            for _ in range(3)]


def _key_mask(lengths, L):
    return (np.arange(L)[None, :] < np.asarray(lengths)[:, None])[:, None,
                                                                  None, :]


@pytest.mark.parametrize("B,L,lengths,block_q", [
    (2, 64, None, 64),                 # full length
    (3, 64, [64, 17, 0], 64),          # mixed lengths, one empty row
    (2, 80, [80, 33], 32),             # L not a multiple of the block
])
def test_plain_matches_jax_flash_and_xla(B, L, lengths, block_q):
    q, k, v = _qkv(B, L)
    lens_j = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref_flash = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          lengths=lens_j, block_q=block_q, interpret=True)
    mask = None if lengths is None else jnp.asarray(_key_mask(lengths, L))
    ref_xla = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             mask=mask)
    lens_t = None if lengths is None else torch.tensor(lengths,
                                                       dtype=torch.int32)
    launches = fa.launches
    out = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths=lens_t)
    assert fa.launches == launches  # a CPU tensor never launches the kernel
    # every position compares: pad queries attend the valid keys in all
    # three, and a lengths=0 row is the mean of V in all three
    np.testing.assert_allclose(to_np(out), np.asarray(ref_flash), atol=ATOL)
    np.testing.assert_allclose(to_np(out), np.asarray(ref_xla), atol=ATOL)


def test_empty_row_is_mean_of_v():
    q, k, v = _qkv(1, 40)
    out = fa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor([0], dtype=torch.int32))
    np.testing.assert_allclose(
        to_np(out)[0], np.broadcast_to(v[0].mean(axis=0), v[0].shape),
        atol=ATOL)


def test_mask_takes_plain_path(monkeypatch):
    B, L = 2, 48
    q, k, v = _qkv(B, L, seed=1)
    seq_id = np.array([[0] * 20 + [1] * 28, [0] * 48])
    mask = port_attn.sequence_id_mask(torch.from_numpy(seq_id))

    def _no_kernel_path(*a, **kw):
        raise AssertionError("a mask must not reach the kernel path")

    monkeypatch.setattr(port_attn, "flash_attention", _no_kernel_path)
    out = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=mask)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         mask=jnp.asarray(to_np(mask)))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)
    # an additive bias also takes the plain path, with lengths as a mask
    from esmdiff_tpu.nn.attention import dot_product_attention as jdpa

    bias = np.random.default_rng(2).standard_normal(
        (B, 1, L, L)).astype(np.float32)
    lengths = np.array([48, 30], np.int32)
    out = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=torch.from_numpy(bias), lengths=torch.from_numpy(lengths))
    ref = jdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               bias=jnp.asarray(bias), lengths=jnp.asarray(lengths),
               backend="xla")
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)
    with pytest.raises(ValueError, match="not both"):
        port_attn.dot_product_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask=mask, lengths=torch.tensor([48, 48]))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "stride", "lengths"])
def test_kernel_argument_checks(bad):
    B, L, H = 2, 16, 2
    good = torch.zeros(B, L, H, 64, dtype=torch.bfloat16)
    fa.check_kernel_args(good, good.clone(), good.clone(),
                         torch.tensor([16, 3]))  # the good case passes
    q, k, v, lengths = good, good.clone(), good.clone(), torch.tensor([16, 3])
    if bad == "head_dim":
        q = k = v = torch.zeros(B, L, H, 32, dtype=torch.bfloat16)
    elif bad == "dtype":
        v = v.float()
    elif bad == "stride":
        v = torch.zeros(B, L, H, 128, dtype=torch.bfloat16)[..., 1:65]
    else:
        lengths = torch.tensor([1.0, 2.0])
    with pytest.raises(ValueError):
        fa.check_kernel_args(q, k, v, lengths)


def test_autograd_function_recomputes_through_plain_version():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(2, 24))
    lengths = torch.tensor([24, 9], dtype=torch.int32)
    out = fa.FlashAttentionFunction.apply(q, k, v, lengths)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(out, (q, k, v), g)
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref = fa.flash_attention_reference(q2, k2, v2, lengths)
    ref_grads = torch.autograd.grad(ref, (q2, k2, v2), g)
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=ATOL)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-5)

