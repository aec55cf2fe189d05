"""Port ``fused_ln_qkv`` and the ``qkv_backend="fused"`` branch of
``MultiHeadAttention`` against the JAX package: its Pallas kernel in
interpret mode and its flax module, on the same parameter tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.nn import layers as jl
from esmdiff_tpu.nn import rotary as jrot
from esmdiff_tpu.ops.fused_qkv import fused_ln_qkv as jax_fused
from esmdiff_tpu_torch.convert import load_flax_params
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.nn import rotary as trot
from esmdiff_tpu_torch.ops import fused_qkv as fq
from esmdiff_tpu_torch.utils import tracing
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ATOL = 2e-5       # fp32, same inputs: only reduction order differs
ATOL_BF16 = 3e-2  # bf16: 1 ulp of a LayerNorm output below 4


def _inputs(B=2, L=48, D=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    ln, qs, ks = (1.0 + 0.1 * rng.standard_normal(D).astype(np.float32)
                  for _ in range(3))
    w = 0.05 * rng.standard_normal((D, 3 * D)).astype(np.float32)
    return x, ln, w, qs, ks


def test_plain_matches_jax_kernel_fp32():
    args = _inputs()
    ref = jax_fused(*map(jnp.asarray, args), block_m=32)
    launches = tracing.counter("fused_qkv.launches")
    out = fq.fused_ln_qkv(*map(torch.from_numpy, args))
    # a CPU tensor never launches the kernel
    assert tracing.counter("fused_qkv.launches") == launches
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)


def test_plain_matches_jax_kernel_bf16_ragged_rows():
    # T = 2 x 50 = 100 tokens, not a multiple of block_m: JAX's pad path
    x, ln, w, qs, ks = _inputs(L=50, seed=1)
    ref = jax_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(ln),
                    jnp.asarray(w, jnp.bfloat16), jnp.asarray(qs),
                    jnp.asarray(ks), block_m=32)
    out = fq.fused_ln_qkv(torch.from_numpy(x).to(torch.bfloat16),
                          torch.from_numpy(ln),
                          torch.from_numpy(w).to(torch.bfloat16),
                          torch.from_numpy(qs), torch.from_numpy(ks))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 50, 384)
    np.testing.assert_allclose(to_np(out.float()),
                               np.asarray(ref, np.float32), atol=ATOL_BF16)


def test_gradient_parity_with_jax():
    args = _inputs(B=1, L=16, D=64, seed=2)

    def loss(*a):
        return jnp.sum(jax_fused(*a, block_m=16) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fq.FusedLnQkvFunction.apply(*ins)
    grads = torch.autograd.grad((out ** 2).sum(), ins)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-3,
                                   rtol=1e-4)


def test_bf16_gradient_parity_with_jax():
    """The backward recomputes through ln_qkv_unfused (the product rounded
    to bf16 before the q/k LayerNorm), the JAX _reference_ln_qkv: every
    gradient entry within one bf16 ulp of JAX's (of max(1, |ref|)) and the
    mean |d| within 1e-5 of the gradient's largest magnitude; recomputing
    through the fused rounding misses that mean by 20-50x."""
    x, ln, w, qs, ks = _inputs(B=2, L=16, D=64, seed=3)
    g = np.random.default_rng(4).standard_normal((2, 16, 192)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fused(*a, block_m=16),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(ln),
                     jnp.asarray(w, jnp.bfloat16), jnp.asarray(qs),
                     jnp.asarray(ks))
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    ins = [torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(ln),
           torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(qs),
           torch.from_numpy(ks)]
    ins = [t.requires_grad_() for t in ins]
    out = fq.FusedLnQkvFunction.apply(*ins)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g).to(
        torch.bfloat16))
    for a, b in zip(grads, ref):
        b = np.asarray(b, np.float32)
        d = np.abs(to_np(a.float()) - b)
        assert (d <= 2.0 ** -7 * np.maximum(1.0, np.abs(b))).all(), d.max()
        assert d.mean() <= 1e-5 * np.abs(b).max(), d.mean()


def _flax_mha(qkv_backend, x, cos, sin):
    fmod = jl.MultiHeadAttention(d_model=x.shape[-1], n_heads=4,
                                 dtype=jnp.float32, qkv_backend=qkv_backend)
    params = fmod.init(jax.random.PRNGKey(1), jnp.asarray(x), cos,
                       sin)["params"]
    return fmod, params


@pytest.mark.parametrize("with_lengths", [False, True])
def test_module_branch_matches_flax(with_lengths):
    B, L, D, H = 2, 24, 64, 4
    x = np.random.default_rng(3).standard_normal((B, L, D)).astype(np.float32)
    cos_j, sin_j = jrot.rotary_tables(L, D // H)
    cos_t, sin_t = trot.rotary_tables(L, D // H)
    lengths = np.array([L, 13], np.int32) if with_lengths else None
    fmod, params = _flax_mha("fused", x, cos_j, sin_j)
    params = perturb(params)
    ref = fmod.apply({"params": params}, jnp.asarray(x), cos_j, sin_j,
                     lengths=None if lengths is None else jnp.asarray(lengths))
    lens_t = None if lengths is None else torch.from_numpy(lengths)
    fused = carry(tl.MultiHeadAttention(D, H, dtype=torch.float32,
                                        qkv_backend="fused"), params)
    unfused = carry(tl.MultiHeadAttention(D, H, dtype=torch.float32), params)
    with torch.no_grad():
        out = fused(torch.from_numpy(x), cos_t, sin_t, lengths=lens_t)
        out_xla = unfused(torch.from_numpy(x), cos_t, sin_t, lengths=lens_t)
    np.testing.assert_allclose(to_np(out), np.asarray(ref), atol=ATOL)
    # the same parameters give the unfused branch's output (fp32)
    np.testing.assert_allclose(to_np(out), to_np(out_xla), atol=ATOL)


def test_fused_tree_loads_strictly():
    """A flax tree made with qkv_backend="fused" has the unfused tree's
    names and shapes, so it loads strictly into either port branch."""
    B, L, D = 1, 8, 64
    x = np.zeros((B, L, D), np.float32)
    cos, sin = jrot.rotary_tables(L, D // 4)
    _, fused_tree = _flax_mha("fused", x, cos, sin)
    _, xla_tree = _flax_mha("xla", x, cos, sin)
    assert (jax.tree.structure(fused_tree) == jax.tree.structure(xla_tree))
    tree = jax.device_get(fused_tree)
    for backend in ("fused", "xla"):
        mod = load_flax_params(
            tl.MultiHeadAttention(D, 4, dtype=torch.float32,
                                  qkv_backend=backend), tree)
        np.testing.assert_array_equal(to_np(mod.qkv.weight),
                                      np.asarray(tree["qkv"]["kernel"]).T)
    tree["q_ln"]["bias"] = np.zeros(D, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_params(tl.MultiHeadAttention(D, 4, qkv_backend="fused"),
                         tree)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strides", "align"])
def test_weight_checks(bad):
    D = 128
    good = torch.zeros(3 * D, D, dtype=torch.bfloat16)
    fq.check_tma_weight("w", good.t(), (D, 3 * D))  # column-major view
    fq.check_tma_weight("w", good.t().contiguous(), (D, 3 * D))  # row-major
    w = {"shape": good,
         "dtype": good.t().float(),
         "strides": torch.zeros(3 * D, 2 * D, dtype=torch.bfloat16)[:, ::2].t(),
         "align": torch.zeros(3 * D * D + 4, dtype=torch.bfloat16)[4:].view(
             3 * D, D).t()}[bad]
    with pytest.raises(ValueError, match="^w"):
        fq.check_tma_weight("w", w, (D, 3 * D))


@pytest.mark.parametrize("case,ok", [
    ("bf16", True), ("view", True), ("float32", False),
    ("odd_stride", False), ("unaligned", False),
])
def test_row_checks(case, ok):
    D = 128
    base = torch.zeros(2, 3, D + 8, dtype=torch.bfloat16)
    x = {"bf16": torch.zeros(2, 3, D, dtype=torch.bfloat16),
         "view": base[..., :D],                      # row stride D + 8
         "float32": torch.zeros(2, 3, D),
         "odd_stride": torch.zeros(6, D + 4, dtype=torch.bfloat16)[:, :D],
         "unaligned": base.reshape(-1)[4:4 + 6 * D].view(2, 3, D)}[case]
    if ok:
        assert fq.check_rows(x, D).shape == (6, D)
    else:
        with pytest.raises(ValueError):
            fq.check_rows(x, D)


@pytest.mark.parametrize("D", [64, 1280, 2048])
def test_widths_without_a_kernel_raise_on_the_card(D, monkeypatch):
    """A width the kernel does not take raises before any launch, on a
    tensor that claims to be on the card; no plain-version fallback."""
    x = torch.zeros(1, 2, D, dtype=torch.bfloat16)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="D in"):
        fq.fused_ln_qkv(x, torch.ones(D), torch.zeros(D, 3 * D), torch.ones(D),
                        torch.ones(D))


def _tma_weight(case, D=128):
    """(D, 3D) bf16 weights in the layouts a TMA descriptor may or may not
    describe."""
    flat = torch.zeros(3 * D * D + 8, dtype=torch.bfloat16)
    return {
        "transpose_view": torch.zeros(3 * D, D, dtype=torch.bfloat16).t(),
        "row_major": torch.zeros(D, 3 * D, dtype=torch.bfloat16),
        "stride_8": torch.zeros(3 * D, D + 8, dtype=torch.bfloat16)[:, :D].t(),
        "offset_16": flat[8:].view(3 * D, D).t(),
        "stride_4": torch.zeros(3 * D, D + 4, dtype=torch.bfloat16)[:, :D].t(),
        "offset_8": flat[4:4 + 3 * D * D].view(3 * D, D).t(),
        "no_unit_stride": torch.zeros(6 * D, 2 * D,
                                      dtype=torch.bfloat16)[::2, ::2].t(),
        "float32": torch.zeros(3 * D, D).t(),
        "shape": torch.zeros(3 * D, D, dtype=torch.bfloat16),
    }[case]


@pytest.mark.parametrize("case", [
    "transpose_view", "row_major",
    # TMA needs 16-byte strides and alignment, not 32
    "stride_8", "offset_16",
])
def test_tma_weight_check_accepts(case):
    fq.check_tma_weight("w_qkv", _tma_weight(case), (128, 384))


@pytest.mark.parametrize("case", ["stride_4", "offset_8", "no_unit_stride",
                                  "float32", "shape"])
def test_tma_weight_check_rejects(case):
    with pytest.raises(ValueError, match="w_qkv"):
        fq.check_tma_weight("w_qkv", _tma_weight(case), (128, 384))


def test_wrapper_checks_w_with_tma_rules(monkeypatch):
    """On a tensor that claims to be on the card, a W that TMA cannot
    describe raises before any launch; no plain-version fallback."""
    D = 512
    x = torch.zeros(1, 2, D, dtype=torch.bfloat16)
    w = torch.zeros(3 * D, D + 4, dtype=torch.bfloat16)[:, :D].t()
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    launches = tracing.counter("fused_qkv.launches")
    with pytest.raises(ValueError, match="TMA"):
        fq.fused_ln_qkv(x, torch.ones(D), w, torch.ones(D), torch.ones(D))
    assert tracing.counter("fused_qkv.launches") == launches
