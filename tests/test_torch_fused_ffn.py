"""Port ``fused_swiglu_ffn`` against the JAX package's Pallas kernel in
interpret mode (its only caller there is its public function, as here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.ops.fused_ffn import fused_swiglu_ffn as jax_ffn
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.ops import fused_ffn as ff
from test_torch_support import to_np

torch.set_num_threads(2)

RTOL = ATOL = 2e-4  # fp32: the JAX package's own tolerance for this kernel
ATOL_BF16 = 3e-2    # bf16: xn and hid rounded at the same points


def _inputs(M, D, H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    w_up = (0.05 * rng.standard_normal((D, 2 * H))).astype(np.float32)
    w_down = (0.05 * rng.standard_normal((H, D))).astype(np.float32)
    return x, scale, w_up, w_down


@pytest.mark.parametrize("M,D,H,bm,bh", [
    (256, 128, 256, 128, 128),
    (300, 128, 256, 128, 128),   # M not a multiple of the block: pad path
])
def test_plain_matches_jax_kernel(M, D, H, bm, bh):
    args = _inputs(M, D, H)
    ref = jax_ffn(*map(jnp.asarray, args), block_m=bm, block_h=bh)
    launches = ff.launches
    out = ff.fused_swiglu_ffn(*map(torch.from_numpy, args))
    assert ff.launches == launches  # a CPU tensor never launches the kernel
    assert out.shape == (M, D)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_plain_matches_jax_kernel_bf16():
    x, scale, w_up, w_down = _inputs(200, 128, 256, seed=1)
    ref = jax_ffn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                  jnp.asarray(w_up, jnp.bfloat16),
                  jnp.asarray(w_down, jnp.bfloat16), block_m=128,
                  block_h=128)
    bf = torch.bfloat16
    out = ff.fused_swiglu_ffn(torch.from_numpy(x).to(bf),
                              torch.from_numpy(scale),
                              torch.from_numpy(w_up).to(bf),
                              torch.from_numpy(w_down).to(bf))
    assert out.dtype == bf
    np.testing.assert_allclose(to_np(out.float()),
                               np.asarray(ref, np.float32), atol=ATOL_BF16)


def test_equals_the_unfused_module():
    """On the port's SwiGLUFFN weights (weight.t() views, the layout the
    card's kernel reads in place) the function is the module's forward."""
    D = 64
    hidden = tl.swiglu_hidden_dim(D)
    ffn = tl.SwiGLUFFN(D, hidden, dtype=torch.float32)
    tl.init_params(ffn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ffn.ln.scale.add_(0.1 * torch.randn(D))
        x = torch.randn(3, 10, D)
        ref = ffn(x)
        out = ff.fused_swiglu_ffn(x.reshape(30, D), ffn.ln.scale,
                                  ffn.up.weight.t(), ffn.down.weight.t())
    np.testing.assert_allclose(to_np(out), to_np(ref.reshape(30, D)),
                               atol=1e-5)

