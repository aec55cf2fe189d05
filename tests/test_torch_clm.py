"""The port's CLM (``esmdiff_tpu_torch/models/clm.py``) against the JAX
package's on the CPU in float32: T5 buckets exactly over every relative
position in [-2048, 2048], the training forward (logits and loss) of the
plain net and both variants, ``decode_step``'s logits at every position,
the cached decode against the teacher-forced decoder, and the int8 layout
(``quantize_clm_params`` bit-equal, logits 1e-4).  Weights are carried over
strictly from the flax init, moved off their init values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.models import clm as jclm
from esmdiff_tpu_torch.convert import flax_names, state_dict_to_flax
from esmdiff_tpu_torch.models import clm as tclm
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

B, L, COND = 3, 11, 48
TOL = dict(atol=1e-5, rtol=1e-5)
GEOM = dict(d_model=32, d_ff=64, n_layers=2, n_heads=4, dtype="float32")
VARIANTS = {"plain": {}, "decoder_only": {"decoder_only": True},
            "dec_add_input_emb": {"dec_add_input_emb": True}}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, L, COND)).astype(np.float32)
    labels = rng.integers(0, 4096, (B, L)).astype(np.int32)
    labels[1, -3:] = -100
    att = np.ones((B, L), np.float32)
    att[2, -4:] = 0.0
    return emb, labels, att


class Pair:
    """A JAX CLM with perturbed params, its jitted forward and decode step,
    and the port's CLM holding the same weights."""

    def __init__(self, variant: str, quant: bool = False):
        kw = {**GEOM, **VARIANTS[variant]}
        jmodel = jclm.CLM(jclm.CLMConfig(**kw))
        emb, labels, _ = _inputs()
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(emb[:1]),
                             jnp.asarray(labels[:1]))["params"]
        self.params = perturb(params, 1, 0.05)
        self.torch = carry(tclm.CLM(tclm.CLMConfig(cond_dim=COND, **kw)),
                           self.params)
        if quant:
            qcfg = jclm.CLMConfig(**kw, quant="int8")
            jmodel = jclm.CLM(qcfg)
            self.params = jax.device_get(
                jclm.quantize_clm_params(self.params))
            self.torch = _quantized(self.torch)
        self.jmodel = jmodel
        self.forward = jax.jit(lambda p, e, lab, a: jmodel.apply(
            {"params": p}, e, lab, attention_mask=a))
        self.encode = jax.jit(lambda p, e, a: jmodel.apply(
            {"params": p}, e, a, method=jmodel.encode))
        self.step = jax.jit(lambda p, tok, pos, enc, caches, a, c:
                            jmodel.apply({"params": p}, tok, pos, enc,
                                         caches, a, c,
                                         method=jmodel.decode_step))


def _quantized(model):
    cfg = dataclasses.replace(model.cfg, quant="int8")
    twin = tclm.CLM(cfg)
    twin.load_state_dict(tclm.quantize_clm_params(model.state_dict()),
                         strict=True)
    return twin


@pytest.fixture(scope="module")
def pairs():
    return {v: Pair(v) for v in VARIANTS}


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 64)])
def test_relative_position_bucket_matches_jax(bidirectional, buckets,
                                              max_distance):
    rel = np.arange(-2048, 2049, dtype=np.int32)
    ref = jclm.relative_position_bucket(jnp.asarray(rel), bidirectional,
                                        buckets, max_distance)
    got = tclm.relative_position_bucket(torch.from_numpy(rel),
                                        bidirectional, buckets, max_distance)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_relpos_bias_matches_jax(pairs):
    """The (1, H, Lq, Lk) bias of the decoder's causal table, both
    directions of query and key positions."""
    pair = pairs["plain"]
    pos = np.arange(40, dtype=np.int32)
    for name, bidir in (("dec_relpos", False), ("enc_relpos", True)):
        module = jclm.RelPosBias(pair.jmodel.cfg, bidirectional=bidir)
        ref = module.apply({"params": pair.params[name]}, jnp.asarray(pos),
                           jnp.asarray(pos[::-1].copy()))
        got = getattr(pair.torch, name)(torch.from_numpy(pos),
                                        torch.from_numpy(pos[::-1].copy()))
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_carry_over_is_strict_and_invertible(pairs):
    """Every port parameter has its flax leaf (enc<i>/dec<i> -> enc_blocks,
    dec_blocks; the relative-position tables) and back."""
    for variant, pair in pairs.items():
        names = flax_names(pair.params)
        assert set(names) == set(pair.torch.state_dict()), variant
        back = state_dict_to_flax(pair.torch.state_dict(), pair.params)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                               pair.params)
    assert "enc_relpos.weight" in flax_names(pairs["plain"].params)
    assert not any(k.startswith("enc") for k in
                   pairs["decoder_only"].torch.state_dict())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(pairs, variant):
    pair = pairs[variant]
    emb, labels, att = _inputs(2)
    ref = pair.forward(pair.params, jnp.asarray(emb), jnp.asarray(labels),
                       jnp.asarray(att))
    with torch.no_grad():
        got = pair.torch(torch.from_numpy(emb), torch.from_numpy(labels),
                         attention_mask=torch.from_numpy(att))
    np.testing.assert_allclose(to_np(got["logits"]),
                               np.asarray(ref["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **TOL)


def _jax_decode(pair, emb, att, tokens):
    """JAX's decode_step logits at every position, teacher-forced on
    ``tokens`` (B, L): step pos reads tokens[:, pos]."""
    enc = pair.encode(pair.params, jnp.asarray(emb), jnp.asarray(att))
    caches = pair.jmodel.init_cache(B, L)
    out = []
    for pos in range(L):
        cond = enc[:, pos] if pair.jmodel.cfg.dec_add_input_emb else None
        logits, caches = pair.step(pair.params, jnp.asarray(tokens[:, pos]),
                                   pos, enc, caches, jnp.asarray(att), cond)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def _port_decode(model, emb, att, tokens, context=True):
    emb, att = torch.from_numpy(emb), torch.from_numpy(att)
    toks = torch.from_numpy(tokens).long()
    with torch.no_grad():
        enc = model.encode(emb, att)
        caches = model.init_cache(B, L)
        ctx = model.decode_context(enc, L, att) if context else None
        out = []
        for pos in range(L):
            cond = enc[:, pos] if model.cfg.dec_add_input_emb else None
            out.append(model.decode_step(toks[:, pos], pos, enc, caches,
                                         att, cond, context=ctx))
    return to_np(torch.stack(out, 1)), enc


def _teacher_tokens(seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 4096, (B, L)).astype(np.int32)
    toks[:, 0] = jclm.CLMConfig().decoder_start_token_id
    return toks


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_matches_jax(pairs, variant):
    """Logits at every position; the port's context (cross K/V and bias
    computed once) and its per-step form agree with each other exactly."""
    pair = pairs[variant]
    emb, _, att = _inputs(4)
    tokens = _teacher_tokens()
    ref = _jax_decode(pair, emb, att, tokens)
    got, _ = _port_decode(pair.torch, emb, att, tokens)
    np.testing.assert_allclose(got, ref, **TOL)
    again, _ = _port_decode(pair.torch, emb, att, tokens, context=False)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cached_decode_matches_teacher_forced(pairs, variant):
    """decode_step over the caches = decode_train on the same tokens."""
    model = pairs[variant].torch
    emb, _, att = _inputs(5)
    tokens = _teacher_tokens(6)
    got, enc = _port_decode(model, emb, att, tokens)
    with torch.no_grad():
        cond = enc if model.cfg.dec_add_input_emb else None
        full = model.decode_train(torch.from_numpy(tokens).long(), enc,
                                  torch.from_numpy(att), cond_embeds=cond)
    np.testing.assert_allclose(got, to_np(full), **TOL)


def test_quantize_clm_params_bit_equal_to_jax(pairs):
    pair = pairs["plain"]
    ref = jax.device_get(jclm.quantize_clm_params(pair.params))
    got = tclm.quantize_clm_params(pair.torch.state_dict())
    names = flax_names(ref)
    assert set(names) == set(got)
    n_quant = 0
    for name, leaf in names.items():
        arr = np.asarray(_get(ref, leaf.path))
        if leaf.transposed:
            arr = arr.T
        np.testing.assert_array_equal(to_np(got[name]), arr, err_msg=name)
        n_quant += name.endswith("kernel_q")
    # q/k/v/o of each attention (enc self, dec self and cross) + the FFN's 3
    assert n_quant == 2 * (4 + 3) + 2 * (8 + 3)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_int8_logits_match_jax():
    pair = Pair("dec_add_input_emb", quant=True)
    emb, labels, att = _inputs(7)
    ref = pair.forward(pair.params, jnp.asarray(emb), jnp.asarray(labels),
                       jnp.asarray(att))
    with torch.no_grad():
        got = pair.torch(torch.from_numpy(emb), torch.from_numpy(labels),
                         attention_mask=torch.from_numpy(att))
    np.testing.assert_allclose(to_np(got["logits"]),
                               np.asarray(ref["logits"]), atol=1e-4,
                               rtol=1e-4)
    tokens = _teacher_tokens(8)
    np.testing.assert_allclose(_port_decode(pair.torch, emb, att, tokens)[0],
                               _jax_decode(pair, emb, att, tokens),
                               atol=1e-4, rtol=1e-4)
