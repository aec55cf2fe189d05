"""A reader of the JAX package's orbax checkpoints, without orbax or JAX.

An orbax ``StandardCheckpointer`` directory (the JAX package's
``CheckpointManager`` steps, ``save_vqvae``'s ``params/``, an AR run's
TrainState) holds ``_METADATA``, whose JSON ``tree_metadata`` maps each
leaf's path, such as ``('params', 'net', ...)``, to its ``key_metadata``
(the keys, each a dict key or a sequence index) and ``value_metadata``
(empty leaves, ``None`` or ``()``, are skipped), and whose ``use_zarr3``
names the array format.  The arrays live in an OCDBT key-value store at
the directory's root, each a zarr (v2, or v3) array named by the dotted
path (``params.net.encoder.kernel/``).  ``read_tree`` opens each one with
tensorstore and builds the nested tree of numpy arrays: dicts for dict
keys, lists for sequence indices, None for an empty leaf.  bfloat16
arrays come back as ml_dtypes' bfloat16, which ``load_flax_params``
carries into torch through a uint16 view.

tensorstore is imported inside the reader; without it the reader raises
ImportError naming it (the card's machine has none: this path is
host-side).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

METADATA = "_METADATA"
_SEQUENCE_KEY = 1


def is_orbax_dir(path) -> bool:
    """``path`` is an orbax checkpoint directory (it holds
    ``_METADATA``)."""
    return (Path(path) / METADATA).is_file()


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX package's orbax checkpoints needs the "
            "'tensorstore' package (pip install tensorstore)") from e
    return tensorstore


def read_tree(path) -> dict:
    """The tree of the orbax checkpoint at ``path``: nested dicts (and
    lists, for sequence indices) of numpy arrays.  Raises
    FileNotFoundError when ``path`` holds no ``_METADATA``."""
    path = Path(path).absolute()
    if not is_orbax_dir(path):
        raise FileNotFoundError(
            f"{path} is not an orbax checkpoint: no {METADATA}")
    meta = json.loads((path / METADATA).read_text())
    ts = _tensorstore()
    array_format = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()
    root: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize"):
            leaf = None
        else:
            name = ".".join(str(k["key"]) for k in keys)
            leaf = np.asarray(ts.open({
                "driver": array_format,
                "kvstore": {"driver": "ocdbt", "base": f"file://{path}/",
                            "path": f"{name}/"}},
                context=context, open=True).result().read().result())
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k["key"], {})
        node[keys[-1]["key"]] = leaf
    return _sequences(root, meta["tree_metadata"])


def _sequences(tree, tree_metadata: dict):
    """The dicts of ``tree`` whose keys are sequence indices as lists."""
    seq_paths = set()
    for entry in tree_metadata.values():
        keys = entry["key_metadata"]
        for i, k in enumerate(keys):
            if k["key_type"] == _SEQUENCE_KEY:
                seq_paths.add(tuple(str(x["key"]) for x in keys[:i]))

    def walk(node, at):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v, at + (str(k),)) for k, v in node.items()}
        if at in seq_paths:
            return [out[k] for k in sorted(out, key=int)]
        return out

    return walk(tree, ())


def params_of(tree: dict) -> dict:
    """The parameters of a restored tree: a TrainState's (``step``,
    ``params``, ``opt_state``) ``params``, else the tree itself."""
    if isinstance(tree, dict) and "params" in tree and "opt_state" in tree:
        return tree["params"]
    return tree
