"""Port attention (plain version + dispatcher + kernel wrapper) against the
JAX package's flash kernel (interpret mode) and its ``_xla_attention``."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.nn.attention import _xla_attention
from esmdiff_tpu.ops.flash_attention import flash_attention as jax_flash
from esmdiff_tpu_torch.nn import attention as port_attn
from esmdiff_tpu_torch.ops import flash_attention as fa
from esmdiff_tpu_torch.utils import tracing
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
    launches = tracing.counter("flash.launches")
    out = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths=lens_t)
    # a CPU tensor never launches the kernel
    assert tracing.counter("flash.launches") == launches
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

    # the kernel path reaches the op through FlashAttentionFunction
    monkeypatch.setattr(fa, "flash_attention", _no_kernel_path)
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


@pytest.mark.parametrize("L", [64, 1024, 1025, 2048, 4096])
def test_kernel_takes_every_length(L):
    """No length limit: K stays in shared memory up to L 1024 and streams
    through it above."""
    x = torch.zeros(1, L, 2, 64, dtype=torch.bfloat16)
    fa.check_kernel_args(x, x.clone(), x.clone(), torch.tensor([L]))


def test_blocks_per_sm_match_the_kernels():
    """BLOCKS_PER_SM is what csrc/attention_tiles.cuh fixes for the
    one-pass kernel: its __launch_bounds__, and shared memory for that many
    blocks within the 227 KB an H100 SM gives them."""
    src = (Path(fa.__file__).parents[1] / "csrc"
           / "attention_tiles.cuh").read_text()
    small, flash = re.search(
        r"__launch_bounds__\(THREADS, kRotary \? (\d+) : (\d+)\)\s*"
        r"attention_short", src).groups()
    assert fa.BLOCKS_PER_SM == {"flash_attention": int(flash),
                                "small_attention": int(small)}
    tile = 64 * (64 + 8) * 2                 # one bf16 tile, padded rows
    table = 2 * 64 * (64 + 4) * 4            # cos and sin rows, fp32
    for name, smem in (("flash_attention", 6 * tile),
                       ("small_attention", 6 * tile + table)):
        n = fa.BLOCKS_PER_SM[name]
        assert n * smem <= 227 * 1024 < (n + 1) * smem


def test_kernel_op_takes_the_function_only_when_autograd_records(
        monkeypatch):
    """Under no_grad the dispatcher calls the kernel's wrapper itself;
    with autograd on, its autograd.Function, whose output has a grad_fn."""
    calls, function = [], fa.FlashAttentionFunction

    class Recording(function):
        @staticmethod
        def forward(ctx, *args):
            calls.append(len(args))
            return function.forward(ctx, *args)

    monkeypatch.setattr(fa, "FlashAttentionFunction", Recording)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(2, 16))
    lengths = torch.tensor([16, 5], dtype=torch.int32)
    with torch.no_grad():
        ref = port_attn.dot_product_attention(q, k, v, lengths=lengths)
    assert calls == [] and ref.grad_fn is None
    out = port_attn.dot_product_attention(q, k, v, lengths=lengths)
    assert calls == [4] and out.grad_fn is not None
    np.testing.assert_array_equal(to_np(out.detach()), to_np(ref))


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



def assert_bf16_grads_match(grads, ref):
    """bf16 gradients against JAX's: each entry within one bf16 ulp of
    max(1, |ref|) and mean |d| <= 1e-5.  The cast-before-normalise
    recompute misses the mean by 30x (about 3e-4 at these shapes)."""
    for a, b in zip(grads, ref):
        a, b = to_np(a.float()), np.asarray(b, np.float32)
        d = np.abs(a - b)
        assert (d <= 2.0 ** -7 * np.maximum(1.0, np.abs(b))).all(), d.max()
        assert d.mean() <= 1e-5, d.mean()


def test_bf16_gradients_match_jax():
    """The backward recomputes through plain_attention (p normalised, then
    cast), as JAX's custom_vjp recomputes through _xla_attention."""
    B, L = 2, 64
    q, k, v, g = _qkv(B, L, H=3, seed=4) + _qkv(B, L, H=3, seed=5)[:1]
    lengths = np.array([64, 29], np.int32)
    _, vjp = jax.vjp(lambda *a: jax_flash(*a, lengths=jnp.asarray(lengths),
                                          interpret=True),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    ins = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
           for a in (q, k, v)]
    out = fa.FlashAttentionFunction.apply(*ins, torch.from_numpy(lengths))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g).to(
        torch.bfloat16))
    assert_bf16_grads_match(grads, ref)


@pytest.mark.parametrize("B,L,H,slots,G", [
    (64, 64, 24, 264, 6),     # the trunk, 2 blocks an SM: 256 blocks
    (64, 64, 24, 528, 3),     # 4 blocks an SM: 512 blocks
    (32, 64, 20, 528, 2),     # the decoder: 320 blocks
    (32, 64, 20, 264, 4),
    (2, 48, 3, 264, 1),       # every (b, h) its own block
    (64, 64, 7, 100, 7),      # no divisor fits: all heads in one block
    (16, 512, 24, 264, 1),    # L > 64: one head's whole K a block
])
def test_pick_group(B, L, H, slots, G):
    assert fa.pick_group(B, L, H, slots) == G
