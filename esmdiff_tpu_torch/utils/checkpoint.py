"""Checkpointing: top-k by validation loss, and resume.

Port of ``esmdiff_tpu/utils/checkpoint.py`` with ``torch.save`` in place of
orbax.  ``save`` writes the whole train state into ``step_N/``: the
parameters (``params.pt``, the model's state dict in float32), the
optimizer state (``optimizer.pt``) and the step (``state.json``), in
separate files so that a sampler loads the parameters alone
(``load_params``, memory-mapped; ``save_params`` writes such a file on its
own, as the VQ-VAE export does).  ``index.json`` keeps the JAX layout: a
list of {"step", "metric", "path"}, best metric first, at most
``save_top_k`` entries; a pruned entry's directory is deleted.

Checkpoints are strategy-portable: under a ``train/state.py::distribute``
layout every rank takes part in gathering whole tensors and rank 0 (the
``writer``) writes them in the one-device layout (FSDP's full state dict,
ZeRO's consolidated optimizer state, tensor-parallel shards joined), so a
sampler loads them unchanged and any strategy resumes from them.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

PARAMS, OPTIMIZER, STATE = "params.pt", "optimizer.pt", "state.json"


def save_params(directory: str | Path, state_dict) -> Path:
    """Write ``state_dict`` (CPU copies, as held) to ``directory/params.pt``
    and return the file's path."""
    path = Path(directory) / PARAMS
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_params(step_dir: str | Path) -> dict:
    """The saved parameters of ``step_dir`` as a state dict of CPU tensors,
    memory-mapped from the file."""
    return torch.load(Path(step_dir) / PARAMS, map_location="cpu",
                      mmap=True, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str | Path, save_top_k: int = 1,
                 writer: bool = True):
        """writer: this process writes (rank 0); the others only take
        part in ``save``'s gathers."""
        self.dir = Path(directory).absolute()
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.save_top_k = save_top_k
        self._index_path = self.dir / "index.json"
        self._index = []
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def save(self, state, step: int, metric: float):
        """Write ``state`` as ``step_<step>``.  Under a ``distribute``
        layout every rank calls it, and none returns before the writer's
        files are complete, so any rank may restore them next."""
        if getattr(state, "layout", None) is None:
            params = state.model.state_dict()
            optimizer = state.optimizer.adamw.state_dict()
        else:
            # imported here: train.state imports this package's siblings
            from esmdiff_tpu_torch.train import state as tstate

            params = tstate.full_model_state(state)
            optimizer = tstate.full_optimizer_state(state)
        if self.writer:
            self._write(params, optimizer, state.step, step, metric)
        if getattr(state, "layout", None) is not None \
                and torch.distributed.is_initialized():
            torch.distributed.barrier()

    def _write(self, params, optimizer, state_step: int, step: int,
               metric: float):
        path = self.dir / f"step_{step}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save(params, path / PARAMS)
        torch.save(optimizer, path / OPTIMIZER)
        (path / STATE).write_text(json.dumps({"step": state_step}))
        self._index = [e for e in self._index if e["step"] != step]
        self._index.append({"step": step, "metric": metric,
                            "path": str(path)})
        self._index.sort(key=lambda e: e["metric"])
        while len(self._index) > self.save_top_k:
            worst = self._index.pop()
            shutil.rmtree(worst["path"], ignore_errors=True)
        self._index_path.write_text(json.dumps(self._index, indent=2))

    def best_path(self) -> str | None:
        return self._index[0]["path"] if self._index else None

    def restore(self, path: str | Path, state):
        """Load ``path``'s parameters, optimizer state and step into
        ``state`` (in place, onto its devices) and return it."""
        path = Path(path)
        from esmdiff_tpu_torch.train import state as tstate

        dev = next(state.model.parameters()).device
        tstate.load_full_state(state, load_params(path), torch.load(
            path / OPTIMIZER, map_location=dev, weights_only=True))
        state.step = json.loads((path / STATE).read_text())["step"]
        return state
