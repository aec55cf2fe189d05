"""Weight carry-over: JAX package parameter trees -> the port's modules.

Takes a flax parameter tree as nested dicts of numpy arrays (e.g.
``jax.device_get(params)``) and loads it strictly into the port's trunk,
sigma embedder or VQ decoder.  numpy in, nothing else: this module imports
neither JAX nor the JAX package.

Mapping (the port's modules use the flax names, so only leaves change):
  - a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), and a
    ``QuantDense`` ``kernel_q`` (in, out) int8 (``quantize_trunk_params``'s
    layout) becomes ``kernel_q`` (out, in), beside its ``scale`` (out,);
  - an Embed ``embedding`` becomes ``weight``; every other leaf keeps its
    name (``scale``, ``bias``, ``rotation_scale``, ...);
  - the ``nn.scan``-stacked layers ``<stack>/blocks/block/...`` (leading
    axis = layer) are unstacked into ``<stack>.blocks.<n_geom + i>``, where
    n_geom counts the unscanned ``block<j>`` layers beside them, which map
    to ``<stack>.blocks.<j>``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

_BLOCK = re.compile(r"block(\d+)$")


def _leaf_name(name: str) -> str:
    return {"kernel": "weight", "embedding": "weight"}.get(name, name)


def flax_to_state_dict(tree: Mapping, prefix: str = "") -> dict:
    """Nested flax param dict -> flat {torch name: numpy array}."""
    out: dict = {}
    n_geom = sum(1 for k in tree if _BLOCK.match(k))
    for key, val in tree.items():
        m = _BLOCK.match(key)
        if key == "blocks" and isinstance(val, Mapping) and "block" in val:
            # nn.scan-stacked layers: unstack along axis 0
            stacked = flax_to_state_dict(val["block"])
            n = next(iter(stacked.values())).shape[0]
            for i in range(n):
                for name, arr in stacked.items():
                    out[f"{prefix}blocks.{n_geom + i}.{name}"] = arr[i]
        elif isinstance(val, Mapping):
            sub = f"blocks.{m.group(1)}" if m else key
            out.update(flax_to_state_dict(val, f"{prefix}{sub}."))
        else:
            arr = np.asarray(val)
            if key in ("kernel", "kernel_q"):
                # a stacked kernel (layer, in, out) stays stacked until the
                # caller above unstacks it
                arr = np.swapaxes(arr, -1, -2)
            out[prefix + _leaf_name(key)] = arr
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
        {k: torch.from_numpy(np.array(v)).to(
            dtype=own[k].dtype, device=own[k].device)
         for k, v in sd.items()}, strict=True)
    return module
