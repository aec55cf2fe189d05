"""The port's JLM (``esmdiff_tpu_torch/models/jlm.py``) against the JAX
package's on the CPU in float32, under both separator strategies: the
training forward (both heads' logits, the per-segment nll and accuracy,
the loss), ``prefill`` and ``decode_step`` logits at every position, the
cached decode against the training forward, and the int8 layout
(``quantize_jlm_params`` bit-equal, logits 1e-4).  Weights are carried
over strictly from the flax init, moved off their init values."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.models import jlm as jjlm
from esmdiff_tpu_torch.convert import flax_names, state_dict_to_flax
from esmdiff_tpu_torch.models import jlm as tjlm
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

B, L, LS, COND = 3, 9, 9, 48
TOL = dict(atol=1e-5, rtol=1e-5)
GEOM = dict(n_embd=32, n_layers=2, n_heads=4, n_positions=64,
            struct_embed_dim=24, dtype="float32")
STRATEGIES = ["sentence", "position"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, L, COND)).astype(np.float32)
    st = rng.integers(0, 4096, (B, LS)).astype(np.int32)
    st[:, 0] = C.STRUCTURE_BOS_TOKEN
    labels = np.concatenate([rng.integers(0, 33, (B, L)), st], 1)
    labels = labels.astype(np.int32)
    labels[1, 2] = labels[2, L + 4] = -100
    mask = np.ones((B, L), np.float32)
    mask[2, -3:] = 0.0
    return emb, st, labels, mask


class Pair:
    """A JAX JLM with perturbed params, its jitted forward, prefill and
    decode step, and the port's JLM holding the same weights."""

    def __init__(self, sep: str, quant: bool = False):
        kw = dict(GEOM, sep_strategy=sep)
        jmodel = jjlm.JLM(jjlm.JLMConfig(**kw))
        emb, st, _, _ = _inputs()
        params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(emb[:1]),
                             jnp.asarray(st[:1]))["params"]
        self.params = perturb(params, 1, 0.05)
        self.torch = carry(tjlm.JLM(tjlm.JLMConfig(cond_dim=COND, **kw)),
                           self.params)
        if quant:
            jmodel = jjlm.JLM(jjlm.JLMConfig(**kw, quant="int8"))
            self.params = jax.device_get(
                jjlm.quantize_jlm_params(self.params))
            twin = tjlm.JLM(dataclasses.replace(self.torch.cfg,
                                                quant="int8"))
            twin.load_state_dict(
                tjlm.quantize_jlm_params(self.torch.state_dict()),
                strict=True)
            self.torch = twin
        self.jmodel = jmodel
        self.forward = jax.jit(lambda p, e, s, lab, m: jmodel.apply(
            {"params": p}, e, s, lab, m))
        self.prefill = jax.jit(lambda p, e, bos, caches: jmodel.apply(
            {"params": p}, e, bos, caches, method=jmodel.prefill))
        self.step = jax.jit(lambda p, tok, pos, caches, pos_id: jmodel.apply(
            {"params": p}, tok, pos, caches, pos_id,
            method=jmodel.decode_step))


@pytest.fixture(scope="module")
def pairs():
    return {s: Pair(s) for s in STRATEGIES}


def test_carry_over_is_strict_and_invertible(pairs):
    """block<i> -> blocks.<i>; sep_token and token_type keep their names."""
    for sep, pair in pairs.items():
        names = flax_names(pair.params)
        assert set(names) == set(pair.torch.state_dict()), sep
        back = state_dict_to_flax(pair.torch.state_dict(), pair.params)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                               pair.params)
    assert "token_type.weight" in flax_names(pairs["sentence"].params)
    assert "sep_token" in flax_names(pairs["position"].params)


@pytest.mark.parametrize("sep", STRATEGIES)
def test_forward_matches_jax(pairs, sep):
    pair = pairs[sep]
    emb, st, labels, mask = _inputs(2)
    ref = pair.forward(pair.params, *map(jnp.asarray, (emb, st, labels,
                                                       mask)))
    with torch.no_grad():
        got = pair.torch(*map(torch.from_numpy, (emb, st, labels, mask)))
    assert set(got) == set(ref)
    for key in ("sequence_logits", "structure_logits"):
        np.testing.assert_allclose(to_np(got[key]), np.asarray(ref[key]),
                                   **TOL)
    for key in ("sequence_nll", "structure_nll", "loss", "sequence_acc",
                "structure_acc"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]), **TOL,
                                   err_msg=key)


def _positions(cfg, prompt_len, n):
    """(cache row, wpe index) of decode steps 0..n-1, as jlm_generate."""
    return [(prompt_len + i,
             i + 1 if cfg.sep_strategy == "position" else prompt_len + i)
            for i in range(n)]


def _jax_decode(pair, emb, st):
    """JAX's prefill logits, then decode_step's at every later position,
    teacher-forced on st[:, 1:]."""
    cfg = pair.jmodel.cfg
    T_max = L + (cfg.sep_strategy == "position") + LS + 1
    caches = pair.jmodel.init_cache(B, T_max)
    logits, caches, T = pair.prefill(pair.params, jnp.asarray(emb),
                                     jnp.asarray(st[:, :1]), caches)
    out = [np.asarray(logits)]
    for i, (pos, pos_id) in enumerate(_positions(cfg, int(T), LS - 1)):
        logits, caches = pair.step(pair.params, jnp.asarray(st[:, i + 1]),
                                   pos, caches, pos_id)
        out.append(np.asarray(logits))
    return np.stack(out, 1)


def _port_decode(model, emb, st):
    cfg = model.cfg
    T_max = L + cfg.offset + LS + 1
    toks = torch.from_numpy(st).long()
    with torch.no_grad():
        caches = model.init_cache(B, T_max)
        logits, T = model.prefill(torch.from_numpy(emb), toks[:, :1], caches)
        out = [logits]
        for i, (pos, pos_id) in enumerate(_positions(cfg, T, LS - 1)):
            out.append(model.decode_step(toks[:, i + 1], pos, caches,
                                         pos_id))
    return to_np(torch.stack(out, 1))


@pytest.mark.parametrize("sep", STRATEGIES)
def test_prefill_and_decode_step_match_jax(pairs, sep):
    pair = pairs[sep]
    emb, st, _, _ = _inputs(3)
    np.testing.assert_allclose(_port_decode(pair.torch, emb, st),
                               _jax_decode(pair, emb, st), **TOL)


@pytest.mark.parametrize("sep", STRATEGIES)
def test_cached_decode_matches_forward(pairs, sep):
    """The prefill's and each step's logits = the training forward's
    structure logits on the same tokens."""
    model = pairs[sep].torch
    emb, st, _, _ = _inputs(4)
    with torch.no_grad():
        full = model(torch.from_numpy(emb), torch.from_numpy(st).long())
    np.testing.assert_allclose(_port_decode(model, emb, st),
                               to_np(full["structure_logits"]), **TOL)


def test_quantize_jlm_params_bit_equal_to_jax(pairs):
    pair = pairs["position"]
    ref = jax.device_get(jjlm.quantize_jlm_params(pair.params))
    got = tjlm.quantize_jlm_params(pair.torch.state_dict())
    names = flax_names(ref)
    assert set(names) == set(got)
    for name, leaf in names.items():
        arr = ref
        for k in leaf.path:
            arr = arr[k]
        arr = np.asarray(arr).T if leaf.transposed else np.asarray(arr)
        np.testing.assert_array_equal(to_np(got[name]), arr, err_msg=name)
        if name.endswith(".bias"):
            assert got[name].dtype == torch.float32
    assert sum(n.endswith("kernel_q") for n in got) == 2 * 4


@pytest.mark.parametrize("sep", STRATEGIES)
def test_int8_logits_match_jax(sep):
    pair = Pair(sep, quant=True)
    emb, st, labels, mask = _inputs(5)
    ref = pair.forward(pair.params, *map(jnp.asarray, (emb, st, labels,
                                                       mask)))
    with torch.no_grad():
        got = pair.torch(*map(torch.from_numpy, (emb, st, labels, mask)))
    for key in ("sequence_logits", "structure_logits"):
        np.testing.assert_allclose(to_np(got[key]), np.asarray(ref[key]),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_port_decode(pair.torch, emb, st),
                               _jax_decode(pair, emb, st), atol=1e-4,
                               rtol=1e-4)
