"""Weight carry-over between the JAX package's parameter trees and the
port's modules.

Takes a flax parameter tree as nested dicts of numpy arrays (e.g.
``jax.device_get(params)``) and loads it strictly into the port's trunk,
sigma embedder, VQ decoder or encoder, or, as a whole MDLM params tree
``{"net": ..., "sigma_embedder": ...}``, into the trainer's modules
(``train.loop.mdlm_modules``).
``flax_names`` maps each of the port's parameter names to its leaf in the
tree, and ``state_dict_to_flax`` goes back, so that gradients and optimizer
steps can be compared leaf by leaf.  numpy in, nothing else: this package
imports neither JAX nor the JAX package (``checkpoints`` loads the port's
own training runs and reference PyTorch files, whose rule tables are
``torch_ckpt``'s and whose oracles are ``verify``'s).

Mapping (the port's modules use the flax names, so only leaves change):
  - a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), and a
    ``QuantDense`` ``kernel_q`` (in, out) int8 (``quantize_trunk_params``'s
    layout) becomes ``kernel_q`` (out, in), beside its ``scale`` (out,);
  - an Embed ``embedding`` becomes ``weight``; every other leaf keeps its
    name (``scale``, ``bias``, ``rotation_scale``, ...);
  - the ``nn.scan``-stacked layers ``<stack>/blocks/block/...`` (leading
    axis = layer) are unstacked into ``<stack>.blocks.<n_geom + i>``, where
    n_geom counts the unscanned ``block<j>`` layers beside them, which map
    to ``<stack>.blocks.<j>``;
  - the CLM's ``enc<j>``/``dec<j>`` layers map to ``enc_blocks.<j>``/
    ``dec_blocks.<j>`` (the port's ``ModuleList``s).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"block(\d+)$")
# unscanned layer lists: flax's "<prefix><j>" -> the port's "<list>.<j>"
_LAYERS = re.compile(r"(block|enc|dec)(\d+)$")
_LAYER_LISTS = {"block": "blocks", "enc": "enc_blocks", "dec": "dec_blocks"}


def _leaf_name(name: str) -> str:
    return {"kernel": "weight", "embedding": "weight"}.get(name, name)


@dataclasses.dataclass(frozen=True)
class FlaxLeaf:
    """Where a port parameter lives in a flax tree: the key path, the layer
    of a scan-stacked leaf (None if unstacked), and whether the last two
    axes are swapped (Dense kernels)."""

    path: tuple
    layer: Optional[int]
    transposed: bool


def flax_names(tree: Mapping, prefix: str = "") -> dict:
    """Nested flax param dict -> {torch name: FlaxLeaf}."""
    out: dict = {}
    n_geom = sum(1 for k in tree if _BLOCK.match(k))
    for key, val in tree.items():
        m = _LAYERS.match(key)
        if key == "blocks" and isinstance(val, Mapping) and "block" in val:
            # nn.scan-stacked layers: one torch name per layer
            stacked = flax_names(val["block"])
            n = np.shape(_get(val["block"], next(iter(stacked.values())).path))[0]
            for i in range(n):
                for name, leaf in stacked.items():
                    out[f"{prefix}blocks.{n_geom + i}.{name}"] = FlaxLeaf(
                        (key, "block", *leaf.path), i, leaf.transposed)
        elif isinstance(val, Mapping):
            sub = f"{_LAYER_LISTS[m.group(1)]}.{m.group(2)}" if m else key
            for name, leaf in flax_names(val, f"{prefix}{sub}.").items():
                out[name] = FlaxLeaf((key, *leaf.path), leaf.layer,
                                     leaf.transposed)
        else:
            out[prefix + _leaf_name(key)] = FlaxLeaf(
                (key,), None, key in ("kernel", "kernel_q"))
    return out


def _get(tree: Mapping, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def flax_to_state_dict(tree: Mapping, prefix: str = "") -> dict:
    """Nested flax param dict -> flat {torch name: numpy array}."""
    out = {}
    for name, leaf in flax_names(tree, prefix).items():
        arr = np.asarray(_get(tree, leaf.path))
        if leaf.layer is not None:
            arr = arr[leaf.layer]
        out[name] = np.swapaxes(arr, -1, -2) if leaf.transposed else arr
    return out


def state_dict_to_flax(state_dict: Mapping, template: Mapping) -> dict:
    """{torch name: tensor or array} -> a nested numpy tree shaped like the
    flax ``template`` (scan-stacked leaves restacked along axis 0, kernels
    transposed back): the inverse of ``flax_to_state_dict``.  Every leaf of
    the template must have its torch name in ``state_dict``."""
    layers: dict = {}
    for name, leaf in flax_names(template).items():
        t = state_dict[name]
        arr = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
               else np.asarray(t))
        if leaf.transposed:
            arr = np.swapaxes(arr, -1, -2)
        layers.setdefault(leaf.path, {})[leaf.layer] = arr
    out: dict = {}
    for path, by_layer in layers.items():
        arr = (by_layer[None] if None in by_layer
               else np.stack([by_layer[i] for i in sorted(by_layer)]))
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Load a flax param tree into ``module`` strictly (every parameter
    present, no extra key, same shapes), keeping each parameter's dtype and
    device."""
    sd = flax_to_state_dict(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"carry-over mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    for name, arr in sd.items():
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: flax shape {arr.shape} vs port "
                             f"{tuple(own[name].shape)}")
    module.load_state_dict(
        {k: numpy_to_torch(v).to(dtype=own[k].dtype, device=own[k].device)
         for k, v in sd.items()}, strict=True)
    return module


def numpy_to_torch(arr) -> torch.Tensor:
    """A CPU tensor copy of a numpy array; ml_dtypes' bfloat16 (which
    ``torch.from_numpy`` refuses) through a uint16 view, bit for bit."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)
