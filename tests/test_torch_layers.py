"""Port layers (``esmdiff_tpu_torch.nn``) against their flax modules, fp32,
same numpy inputs and carried-over weights, at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.nn import attention as jattn
from esmdiff_tpu.nn import embed as jembed
from esmdiff_tpu.nn import layers as jl
from esmdiff_tpu.nn import rotary as jrot
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn import attention as tattn
from esmdiff_tpu_torch.nn import embed as tembed
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.nn import rotary as trot
from esmdiff_tpu_torch.ops import flash_attention as fa
from esmdiff_tpu_torch.ops import fused_qkv as fq
from esmdiff_tpu_torch.ops import small_attention as sa
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


def _outcome(fn):
    """fn()'s output as numpy, or ValueError if it raised one."""
    try:
        return to_np(fn())
    except ValueError:
        return ValueError


@pytest.mark.parametrize("case", ["mask", "bias", "lengths", "none"])
@pytest.mark.parametrize("backend", ["auto", "flash", "small", "xla"])
def test_dispatch_matches_jax(backend, case):
    """Each (backend, masking) pair gives JAX's output or JAX's ValueError,
    through ``dot_product_attention`` and through ``MultiHeadAttention``
    (fp32, atol 2e-5).  One difference by design: "flash" with a bias
    raises in the port, where JAX drops the bias.  "small" is a module
    backend only; the module takes no bias."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((B, L, H, 16)).astype(np.float32)
               for _ in range(3))
    seq_id = np.array([[0] * 10 + [1] * (L - 10), [0] * L])
    inputs = {
        "mask": {"mask": seq_id[:, None, :, None] == seq_id[:, None, None, :]},
        "bias": {"bias": rng.standard_normal((B, 1, L, L)).astype(np.float32)},
        "lengths": {"lengths": np.array([L, 13], np.int32)},
        "none": {},
    }[case]
    kw_j = {n: jnp.asarray(a) for n, a in inputs.items()}
    kw_t = {n: torch.from_numpy(a) for n, a in inputs.items()}
    pairs = []
    if backend != "small":
        pairs.append((
            _outcome(lambda: jattn.dot_product_attention(
                *map(jnp.asarray, (q, k, v)), backend=backend, **kw_j)),
            _outcome(lambda: tattn.dot_product_attention(
                *map(torch.from_numpy, (q, k, v)), backend=backend, **kw_t))))
    if case != "bias":
        x = _x((B, L, D), seed=6)
        cos_j, sin_j = jrot.rotary_tables(L, D // H)
        cos_t, sin_t = trot.rotary_tables(L, D // H)
        fmod = jl.MultiHeadAttention(d_model=D, n_heads=H, dtype=jnp.float32,
                                     attn_backend=backend)
        params = perturb(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   cos_j, sin_j)["params"])
        mod = carry(tl.MultiHeadAttention(D, H, dtype=F32,
                                          attn_backend=backend), params)
        with torch.no_grad():
            pairs.append((
                _outcome(lambda: fmod.apply({"params": params},
                                            jnp.asarray(x), cos_j, sin_j,
                                            **kw_j)),
                _outcome(lambda: mod(torch.from_numpy(x), cos_t, sin_t,
                                     **kw_t))))
    for ref, out in pairs:
        if (backend, case) == ("flash", "bias"):
            assert out is ValueError and ref is not ValueError
        elif ref is ValueError:
            assert out is ValueError
        else:
            assert out is not ValueError
            np.testing.assert_allclose(out, ref, atol=2e-5)


# kernel ops the trunk reaches in each configuration, with their plain
# versions
_KERNEL_OPS = {"flash": (fa, "flash_attention", fa.flash_attention_reference),
               "small": (sa, "small_attention", sa.small_attention_reference),
               "fused": (fq, "fused_ln_qkv", fq.fused_ln_qkv_reference)}


@pytest.mark.parametrize("qkv_backend,attn_backend", [
    ("xla", "auto"), ("xla", "flash"), ("xla", "small"), ("xla", "xla"),
    ("fused", "auto"), ("fused", "small"),
])
def test_trunk_gradients_survive_detached_kernel_outputs(
        monkeypatch, qkv_backend, attn_backend):
    """On the card a kernel's output is a fresh tensor with no grad_fn.
    With every kernel op patched to return its plain result detached, a
    2-layer tiny trunk's parameter gradients equal the unpatched ones
    (fp32, atol 1e-6): the modules reach the ops through their
    autograd.Functions."""
    cfg = tesm3.esm3_tiny(dtype="float32", head_type="structure", n_layers=2,
                          qkv_backend=qkv_backend, attn_backend=attn_backend)
    trunk = tesm3.ESM3(cfg)
    tl.init_params(trunk, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    seq = torch.from_numpy(rng.integers(4, 24, (B, L)))
    lengths = torch.tensor([L, 13], dtype=torch.int32)
    weight = torch.from_numpy(rng.standard_normal(
        (B, L, cfg.n_structure_heads)).astype(np.float32))

    def grads():
        trunk.zero_grad(set_to_none=True)
        out = trunk(sequence_tokens=seq, lengths=lengths)
        (out.structure_logits * weight).sum().backward()
        return {n: p.grad.clone() for n, p in trunk.named_parameters()
                if p.grad is not None}

    ref = grads()
    reached = set()
    for key, (module, name, plain) in _KERNEL_OPS.items():
        def detached(*args, _key=key, _plain=plain):
            reached.add(_key)
            return _plain(*args).detach()
        monkeypatch.setattr(module, name, detached)
    out = grads()
    expected = {"fused"} if qkv_backend == "fused" else set()
    expected |= {"auto": {"flash"}, "flash": {"flash"}, "small": {"small"},
                 "xla": set()}[attn_backend]
    assert reached == expected
    assert out.keys() == ref.keys()
    assert any("attn.qkv" in n for n in ref)
    for n in ref:
        np.testing.assert_allclose(to_np(out[n]), to_np(ref[n]), atol=1e-6,
                                   err_msg=n)
