"""The port's CLM and JLM against the upstream HF ``transformers`` models
(random weights, built from config, no download), loaded through
``convert.checkpoints.load_ar_params`` from a saved checkpoint in each of
the three layouts it unwraps (a bare state dict, DeepSpeed's ``module``,
Lightning's ``state_dict`` with ``net.`` keys); and the strictness by
design: a JLM checkpoint fills every port tensor where the JAX CLI's
default CLM conversion fills none, and a missing or unmapped parameter
raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.convert.ar_rules import convert_clm
from esmdiff_tpu.models import jlm as jjlm
from esmdiff_tpu_torch.convert.ar_rules import jlm_rules
from esmdiff_tpu_torch.convert.checkpoints import load_ar_params
from esmdiff_tpu_torch.models import clm as tclm
from esmdiff_tpu_torch.models import jlm as tjlm
from test_torch_support import to_np

torch.set_num_threads(2)

B, L, LS, COND = 2, 7, 9, 48
LAYOUTS = ["bare", "deepspeed", "lightning"]


def _save(sd, layout, path):
    obj = {"bare": sd, "deepspeed": {"module": sd},
           "lightning": {"state_dict": {f"net.{k}": v for k, v in sd.items()},
                         "epoch": 3}}[layout]
    torch.save(obj, path)
    return path


def _clm_hf():
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(0)
    hf = T5ForConditionalGeneration(T5Config(
        vocab_size=4101, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_heads=4, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        pad_token_id=4099, decoder_start_token_id=4099)).eval()
    adapter = torch.nn.Linear(COND, 32, bias=False)
    sd = dict(hf.state_dict())
    sd["adapation_layer.weight"] = adapter.weight.detach()
    return hf, adapter, sd


def _port_clm(n_layers=2):
    return tclm.CLM(tclm.CLMConfig(d_model=32, d_ff=64, n_layers=n_layers,
                                   n_heads=4, cond_dim=COND,
                                   dtype="float32"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_clm_matches_hf_t5(layout, tmp_path):
    hf, adapter, sd = _clm_hf()
    model = load_ar_params(_save(sd, layout, tmp_path / "clm.ckpt"),
                           _port_clm())
    rng = np.random.RandomState(1)
    emb = rng.randn(B, L, COND).astype(np.float32)
    labels = rng.randint(0, 4096, (B, LS)).astype(np.int64)
    labels[0, -2:] = -100
    att = np.ones((B, L), np.float32)
    att[1, -3:] = 0.0
    with torch.no_grad():
        ref = hf(inputs_embeds=adapter(torch.from_numpy(emb)),
                 attention_mask=torch.from_numpy(att),
                 labels=torch.from_numpy(labels))
        got = model(torch.from_numpy(emb), torch.from_numpy(labels),
                    attention_mask=torch.from_numpy(att))
    np.testing.assert_allclose(to_np(got["logits"]), to_np(ref.logits),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(got["loss"]), float(ref.loss),
                               atol=1e-5, rtol=1e-5)


def _jlm_hf(sep):
    from transformers import GPT2Config, GPT2Model

    torch.manual_seed(0)
    gpt = GPT2Model(GPT2Config(
        vocab_size=8, n_positions=64, n_embd=32, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        activation_function="gelu_new")).eval()
    extra = {
        "structure_embed_tokens": torch.nn.Embedding(4101, 24),
        "sequence_adapation_layer": torch.nn.Linear(COND, 32, bias=False),
        "structure_adapation_layer": torch.nn.Linear(24, 32, bias=False),
        "sequence_head": torch.nn.Linear(32, 33, bias=False),
        "structure_head": torch.nn.Linear(32, 4101, bias=False),
    }
    sd = dict(gpt.state_dict())
    sd.update({f"{k}.weight": m.weight.detach() for k, m in extra.items()})
    sd["sep_token"] = torch.randn(32)
    return gpt, extra, sd


def _port_jlm(sep, n_layers=2):
    return tjlm.JLM(tjlm.JLMConfig(
        n_embd=32, n_layers=n_layers, n_heads=4, n_positions=64,
        cond_dim=COND, struct_embed_dim=24, sep_strategy=sep,
        dtype="float32"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sep", ["sentence", "position"])
def test_jlm_matches_hf_gpt2(sep, layout, tmp_path):
    gpt, extra, sd = _jlm_hf(sep)
    model = load_ar_params(_save(sd, layout, tmp_path / "jlm.pt"),
                           _port_jlm(sep))
    rng = np.random.RandomState(3)
    emb = torch.from_numpy(rng.randn(B, L, COND).astype(np.float32))
    st = torch.from_numpy(rng.randint(0, 4096, (B, LS)))
    with torch.no_grad():
        seq_part = extra["sequence_adapation_layer"](emb)
        str_part = extra["structure_adapation_layer"](
            extra["structure_embed_tokens"](st))
        if sep == "sentence":
            x = torch.cat([seq_part, str_part], 1)
            types = torch.cat([torch.zeros(B, L), torch.ones(B, LS)],
                              1).long()
            pos = torch.arange(L + LS)[None].expand(B, -1)
            h = gpt(inputs_embeds=x, position_ids=pos,
                    token_type_ids=types).last_hidden_state
        else:
            x = torch.cat([seq_part, sd["sep_token"].expand(B, 1, 32),
                           str_part], 1)
            pos = torch.cat([torch.arange(L), torch.zeros(1).long(),
                             torch.arange(LS)])[None].expand(B, -1)
            h = gpt(inputs_embeds=x, position_ids=pos).last_hidden_state
        off = 0 if sep == "sentence" else 1
        got = model(emb, st)
    np.testing.assert_allclose(
        to_np(got["sequence_logits"]),
        to_np(extra["sequence_head"](h[:, :L])), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        to_np(got["structure_logits"]),
        to_np(extra["structure_head"](h[:, L + off:])), atol=2e-5,
        rtol=2e-5)


def test_jlm_checkpoint_fills_every_port_tensor(tmp_path):
    """The JAX CLI converts any --ckpt with the CLM rules for 12 layers
    unless told otherwise (load_ar_params' defaults): on a JLM checkpoint
    its report lists every leaf of the JLM as unmapped, so every weight
    stays random.  The port takes the JLM's rules from the model and
    fills every tensor with the checkpoint's value."""
    _, _, sd = _jlm_hf("position")
    jmodel = jjlm.JLM(jjlm.JLMConfig(n_embd=32, n_layers=2, n_heads=4,
                                     n_positions=64, struct_embed_dim=24,
                                     sep_strategy="position",
                                     dtype="float32"))
    template = jmodel.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 4, COND)),
                           jnp.zeros((1, 4), jnp.int32))["params"]
    n_leaves = len(jax.tree_util.tree_leaves(template))
    _, report = convert_clm(template, {k: v.numpy() for k, v in sd.items()},
                            strict=False)
    assert len(report["unmapped"]) == n_leaves

    model = load_ar_params(_save(sd, "bare", tmp_path / "jlm.pt"),
                           _port_jlm("position"))
    rules = jlm_rules(2)
    own = model.state_dict()
    assert set(own) <= set(rules)
    for name, value in own.items():
        key, transform = rules[name]
        torch.testing.assert_close(value, transform(sd[key]), rtol=0, atol=0)


def test_incomplete_checkpoint_raises(tmp_path):
    """A missing key, a model deeper than the checkpoint, a checkpoint of
    the other model type and a directory that is neither a run nor an
    orbax checkpoint all raise."""
    _, _, sd = _clm_hf()
    sd.pop("decoder.block.1.layer.2.DenseReluDense.wo.weight")
    with pytest.raises(KeyError, match="1 missing"):
        load_ar_params(_save(sd, "bare", tmp_path / "a.pt"), _port_clm())
    _, _, sd = _clm_hf()
    with pytest.raises(KeyError, match="missing"):
        load_ar_params(_save(sd, "bare", tmp_path / "b.pt"), _port_clm(3))
    with pytest.raises(KeyError, match="missing"):
        load_ar_params(tmp_path / "b.pt", _port_jlm("sentence"))
    with pytest.raises(FileNotFoundError, match="orbax.*_METADATA"):
        load_ar_params(tmp_path, _port_clm())
