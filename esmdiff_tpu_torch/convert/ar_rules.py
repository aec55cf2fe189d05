"""HF checkpoint rules for the AR nets: port of
``esmdiff_tpu/convert/ar_rules.py``.

The reference's CLM and JLM checkpoints are state dicts of HF modules
(``CustomedT5``, ``CustomedGPT2``).  ``clm_rules`` and ``jlm_rules`` map
each of the port's parameter names (``models/clm.py``, ``models/jlm.py``)
to its HF key and a layout transform:

  - T5 ``Linear`` weights are (out, in), as the port's: kept;
  - GPT-2 ``Conv1D`` weights are (in, out): transposed (the opposite of
    the flax rules, whose kernels are (in, out));
  - T5's relative-attention table lives in block 0 of each stack;
  - GPT-2's token-type embeddings are rows 0 and 1 of ``wte``.

``load_torch_state_dict`` and ``strip_prefix`` live in
``convert/torch_ckpt.py`` and are re-exported here.
"""

from __future__ import annotations

from typing import Callable

from esmdiff_tpu_torch.convert.torch_ckpt import (  # noqa: F401
    load_torch_state_dict, strip_prefix)


def _id(x):
    return x


def _t(x):  # GPT-2 Conv1D (in, out) -> the port's (out, in)
    return x.t().contiguous()


Rules = dict[str, tuple[str, Callable]]


def clm_rules(n_layers: int) -> Rules:
    rules: Rules = {
        "adapter.weight": ("adapation_layer.weight", _id),
        "token_embed.weight": ("decoder.embed_tokens.weight", _id),
        "lm_head.weight": ("lm_head.weight", _id),
        "enc_norm.scale": ("encoder.final_layer_norm.weight", _id),
        "dec_norm.scale": ("decoder.final_layer_norm.weight", _id),
        "enc_relpos.weight": ("encoder.block.0.layer.0.SelfAttention."
                              "relative_attention_bias.weight", _id),
        "dec_relpos.weight": ("decoder.block.0.layer.0.SelfAttention."
                              "relative_attention_bias.weight", _id),
    }
    for i in range(n_layers):
        e, enc = f"encoder.block.{i}", f"enc_blocks.{i}"
        for nm in ("q", "k", "v", "o"):
            rules[f"{enc}.attn.{nm}.weight"] = (
                f"{e}.layer.0.SelfAttention.{nm}.weight", _id)
        rules[f"{enc}.ln1.scale"] = (f"{e}.layer.0.layer_norm.weight", _id)
        for nm in ("wi_0", "wi_1", "wo"):
            rules[f"{enc}.ffn.{nm}.weight"] = (
                f"{e}.layer.1.DenseReluDense.{nm}.weight", _id)
        rules[f"{enc}.ln2.scale"] = (f"{e}.layer.1.layer_norm.weight", _id)

        d, dec = f"decoder.block.{i}", f"dec_blocks.{i}"
        for nm in ("q", "k", "v", "o"):
            rules[f"{dec}.self_attn.{nm}.weight"] = (
                f"{d}.layer.0.SelfAttention.{nm}.weight", _id)
            rules[f"{dec}.cross_attn.{nm}.weight"] = (
                f"{d}.layer.1.EncDecAttention.{nm}.weight", _id)
        rules[f"{dec}.ln1.scale"] = (f"{d}.layer.0.layer_norm.weight", _id)
        rules[f"{dec}.ln2.scale"] = (f"{d}.layer.1.layer_norm.weight", _id)
        for nm in ("wi_0", "wi_1", "wo"):
            rules[f"{dec}.ffn.{nm}.weight"] = (
                f"{d}.layer.2.DenseReluDense.{nm}.weight", _id)
        rules[f"{dec}.ln3.scale"] = (f"{d}.layer.2.layer_norm.weight", _id)
    return rules


def jlm_rules(n_layers: int) -> Rules:
    rules: Rules = {
        "structure_embed.weight": ("structure_embed_tokens.weight", _id),
        "seq_adapter.weight": ("sequence_adapation_layer.weight", _id),
        "struct_adapter.weight": ("structure_adapation_layer.weight", _id),
        "sequence_head.weight": ("sequence_head.weight", _id),
        "structure_head.weight": ("structure_head.weight", _id),
        "wpe.weight": ("wpe.weight", _id),
        "ln_f.scale": ("ln_f.weight", _id),
        "ln_f.bias": ("ln_f.bias", _id),
        "sep_token": ("sep_token", _id),
        "token_type.weight": ("wte.weight", lambda w: w[:2]),
    }
    for i in range(n_layers):
        h, blk = f"h.{i}", f"blocks.{i}"
        for ln, hf in (("ln1", "ln_1"), ("ln2", "ln_2")):
            rules[f"{blk}.{ln}.scale"] = (f"{h}.{hf}.weight", _id)
            rules[f"{blk}.{ln}.bias"] = (f"{h}.{hf}.bias", _id)
        for nm, hf in (("qkv", "attn.c_attn"), ("attn_out", "attn.c_proj"),
                       ("mlp_up", "mlp.c_fc"), ("mlp_down", "mlp.c_proj")):
            rules[f"{blk}.{nm}.weight"] = (f"{h}.{hf}.weight", _t)
            rules[f"{blk}.{nm}.bias"] = (f"{h}.{hf}.bias", _id)
    return rules
