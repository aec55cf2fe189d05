"""Geometric attention of ESM3 block 0 — parameters only, for now.

``esmdiff_tpu/nn/geometric.py::GeometricAttention`` runs only when input
coordinates are given (the encode path, a later slice of the port).  With no
coordinates every frame is masked and its contribution is exactly zero, so
the trunk skips it.  This module owns the same parameters, so a carried-over
checkpoint loads strictly, and raises if its compute is asked for.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Dense, LayerNorm


class GeometricAttention(nn.Module):
    def __init__(self, d_model: int, v_heads: int,
                 num_vector_messages: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.ln = LayerNorm(d_model)
        self.proj = Dense(d_model, v_heads * (12 + 3 * num_vector_messages),
                          use_bias=False, dtype=dtype)
        self.rotation_scale = nn.Parameter(torch.empty(v_heads))
        self.distance_scale = nn.Parameter(torch.empty(v_heads))
        self.out = Dense(v_heads * 3 * num_vector_messages, d_model,
                         use_bias=False, dtype=dtype)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "geometric attention (structure coordinates as trunk input) is "
            "not ported yet")
