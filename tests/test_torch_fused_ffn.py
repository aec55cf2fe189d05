"""Port ``fused_swiglu_ffn`` against the JAX package's Pallas kernel in
interpret mode (its only caller there is its public function, as here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.ops.fused_ffn import fused_swiglu_ffn as jax_ffn
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.ops import fused_ffn as ff
from esmdiff_tpu_torch.utils import tracing
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
    launches = tracing.counter("fused_ffn.launches")
    out = ff.fused_swiglu_ffn(*map(torch.from_numpy, args))
    # a CPU tensor never launches the kernel
    assert tracing.counter("fused_ffn.launches") == launches
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


def _weight(case, K, N):
    """A (K, N) bf16 weight in a layout a TMA descriptor may or may not
    describe."""
    bf = torch.bfloat16
    flat = torch.zeros(K * N + 8, dtype=bf)
    return {
        "transpose_view": torch.zeros(N, K, dtype=bf).t(),   # weight.t()
        "contiguous": torch.zeros(K, N, dtype=bf),
        "stride_8": torch.zeros(N, K + 8, dtype=bf)[:, :K].t(),
        "offset_16": flat[8:].view(N, K).t(),
        "stride_4": torch.zeros(N, K + 4, dtype=bf)[:, :K].t(),
        "offset_8": flat[4:4 + K * N].view(N, K).t(),
        "no_unit_stride": torch.zeros(2 * N, 2 * K, dtype=bf)[::2, ::2].t(),
        "float32": torch.zeros(N, K).t(),
        "shape": torch.zeros(K, N + 64, dtype=bf),
    }[case]


D_CARD, H_CARD = 512, 1024   # a shape the card's kernel takes


def _on_the_card(monkeypatch):
    """Make every tensor claim to lie on the card, so that the wrapper takes
    its kernel path; it must raise before any launch."""
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))


@pytest.mark.parametrize("name", ["w_up", "w_down"])
@pytest.mark.parametrize("case", [
    "transpose_view", "contiguous",
    # TMA needs 16-byte strides and alignment, not 32
    "stride_8", "offset_16",
])
def test_weight_check_accepts(case, name):
    shape = {"w_up": (D_CARD, 2 * H_CARD), "w_down": (H_CARD, D_CARD)}[name]
    ff.check_tma_weight(name, _weight(case, *shape), shape)


@pytest.mark.parametrize("name", ["w_up", "w_down"])
@pytest.mark.parametrize("case", ["stride_4", "offset_8", "no_unit_stride",
                                  "float32", "shape"])
def test_wrapper_rejects_weights_tma_cannot_read(case, name, monkeypatch):
    """On a tensor that claims to be on the card, a weight that TMA cannot
    describe raises, naming it, before any launch; no plain-version
    fallback."""
    weights = {"w_up": _weight("transpose_view", D_CARD, 2 * H_CARD),
               "w_down": _weight("transpose_view", H_CARD, D_CARD)}
    weights[name] = _weight(case, *weights[name].shape)
    x = torch.zeros(2, D_CARD, dtype=torch.bfloat16)
    _on_the_card(monkeypatch)
    launches = tracing.counter("fused_ffn.launches")
    with pytest.raises(ValueError, match=name):
        ff.fused_swiglu_ffn(x, torch.ones(D_CARD), weights["w_up"],
                            weights["w_down"])
    assert tracing.counter("fused_ffn.launches") == launches


@pytest.mark.parametrize("D,H,match", [
    (256, 1024, "D in"), (640, 1024, "D in"), (2048, 1024, "D in"),
    (512, 128, "multiple of 512"), (512, 640, "multiple of 512"),
    (1536, 4000, "multiple of 512"),
])
def test_shapes_without_a_kernel_raise_on_the_card(D, H, match, monkeypatch):
    """A width or hidden width the kernel does not take raises before any
    launch, on a tensor that claims to be on the card."""
    x = torch.zeros(2, D, dtype=torch.bfloat16)
    w_up, w_down = _weight("transpose_view", D, 2 * H), \
        _weight("transpose_view", H, D)
    _on_the_card(monkeypatch)
    launches = tracing.counter("fused_ffn.launches")
    with pytest.raises(ValueError, match=match):
        ff.fused_swiglu_ffn(x, torch.ones(D), w_up, w_down)
    assert tracing.counter("fused_ffn.launches") == launches
