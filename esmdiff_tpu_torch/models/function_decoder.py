"""Function-token decoder (the ESM3 ``ESM3_function_decoder_v0`` slot):
port of ``esmdiff_tpu/models/function_decoder.py``.

A residue's depth-8 function-token group is embedded (per-depth
vocabulary offsets), contextualized by a small transformer over the depth
positions, mean-pooled, and projected to InterPro classification and
keyword (TF-IDF) logits.  The reference imports the decoder
(slm/models/net.py:27,350) but conformation generation never calls it.

Its stack takes the plain attention path (``attn_backend="xla"``), as the
structure encoder's does, and launches no kernel: at the default geometry
(d 1024, 8 heads) a head is Dh 128 in float32 over 8 positions, and the
flash kernel takes only Dh 64 in bf16 (JAX's "auto" sends L 8 to its
plain path too).  Head sizes of a real checkpoint are read from its state
dict (``convert/verify.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import torch_dtype
from esmdiff_tpu_torch.nn.layers import Embed, RegressionHead
from .esm3 import ESM3Config, TransformerStack


@dataclasses.dataclass(frozen=True)
class FunctionDecoderConfig:
    d_model: int = 1024
    n_heads: int = 8
    n_layers: int = 3
    function_token_depth: int = C.FUNCTION_TOKEN_DEPTH   # 8
    function_token_vocab: int = C.FUNCTION_VOCAB_SIZE    # 260
    interpro_classes: int = 29026
    keyword_vocab: int = 58641
    dtype: str = "float32"

    def stack_config(self) -> ESM3Config:
        return ESM3Config(d_model=self.d_model, n_heads=self.n_heads,
                          v_heads=0, n_layers=self.n_layers, n_layers_geom=0,
                          dtype=self.dtype, remat=False, attn_backend="xla")


class FunctionTokenDecoder(nn.Module):
    def __init__(self, cfg: FunctionDecoderConfig = FunctionDecoderConfig()):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.embed = Embed(cfg.function_token_depth * cfg.function_token_vocab,
                           cfg.d_model, dtype=dt)
        self.decoder = TransformerStack(cfg.stack_config())
        self.interpro_head = RegressionHead(cfg.d_model, cfg.interpro_classes,
                                            dtype=dt)
        self.keyword_head = RegressionHead(cfg.d_model, cfg.keyword_vocab,
                                           dtype=dt)

    def forward(self, function_tokens):
        """function_tokens: (B, depth) int, one residue group a row ->
        dict(interpro_logits (B, interpro_classes), keyword_logits (B,
        keyword_vocab)), float32."""
        cfg = self.cfg
        if function_tokens.shape[-1] != cfg.function_token_depth:
            raise ValueError(f"function_tokens: last axis must be "
                             f"{cfg.function_token_depth}, got "
                             f"{function_tokens.shape[-1]}")
        offsets = torch.arange(cfg.function_token_depth,
                               device=function_tokens.device) \
            * cfg.function_token_vocab
        x, _ = self.decoder(self.embed(function_tokens + offsets))
        pooled = x.mean(dim=-2)
        return {"interpro_logits": self.interpro_head(pooled),
                "keyword_logits": self.keyword_head(pooled)}
