"""Tensor helpers: masked mean, batched gather, chunked apply, distogram,
pseudo-beta.

Port of ``esmdiff_tpu/utils/tensor.py`` (the OpenFold-derived helpers the
reference vendors, slm/utils/tensor_utils.py:24-283).  ``chunk_apply``
maps a function over leading-axis chunks of a nested dict, list or tuple
of tensors to bound peak memory: full chunks of ``chunk_size`` and one
remainder, as JAX's ``lax.map`` over the reshaped chunks and its call on
the rest.
"""

from __future__ import annotations

from typing import Callable

import torch


def masked_mean(mask, value, dim=None, eps: float = 1e-4):
    """sum(mask * value) / (sum(mask) + eps) over ``dim`` (all dims when
    None)."""
    mask = mask.to(value.dtype)
    if dim is None:
        return (mask * value).sum() / (mask.sum() + eps)
    return (mask * value).sum(dim=dim) / (mask.sum(dim=dim) + eps)


def batched_gather(data, inds, dim: int = 0):
    """Gather along ``dim`` with per-batch indices (leading dims shared):
    ``take_along_axis``."""
    return torch.take_along_dim(data, inds.long(), dim=dim)


def _map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _zip_cat(outs: list):
    """The leaves of same-structured trees concatenated on dim 0."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _zip_cat([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_cat([o[i] for o in outs])
                           for i in range(len(first)))
    return torch.cat(outs, dim=0)


def chunk_apply(fn: Callable, x, chunk_size: int):
    """``fn`` over leading-axis chunks of ``x`` (a tensor, or a nested
    dict/list/tuple of tensors sharing dim 0), the outputs concatenated:
    full chunks of ``chunk_size``, then the remainder in one call."""
    n = _leaves(x)[0].shape[0]
    if n <= chunk_size:
        return fn(x)
    outs = [fn(_map(lambda a, s=s: a[s:s + chunk_size], x))
            for s in range(0, n - chunk_size + 1, chunk_size)]
    n_full = len(outs) * chunk_size
    if n_full < n:
        outs.append(fn(_map(lambda a: a[n_full:], x)))
    return _zip_cat(outs)


def distogram(ca_coords, min_bin: float = 2.3125, max_bin: float = 21.6875,
              n_bins: int = 64):
    """(..., L, 3) -> (..., L, L) int32 distance-bin indices."""
    d = torch.sqrt(((ca_coords[..., :, None, :] - ca_coords[..., None, :, :])
                    ** 2).sum(-1) + 1e-12)
    edges = torch.linspace(min_bin, max_bin, n_bins - 1,
                           dtype=d.dtype, device=d.device)
    return (d[..., None] > edges).sum(-1).int()


def pseudo_beta(atom37_positions, aatype, gly_index: int = 7):
    """CB coordinates with the CA fallback for glycine (atom37 layout)."""
    ca = atom37_positions[..., 1, :]
    cb = atom37_positions[..., 3, :]
    return torch.where((aatype == gly_index)[..., None], ca, cb)
