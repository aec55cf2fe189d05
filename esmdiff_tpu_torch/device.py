"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  With no card
and no explicit CPU request they raise: nothing falls back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a card raises.  A
    CUDA device comes back with its index, so work issued from any thread
    (the server's handler threads) names the card explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name) -> torch.dtype:
    """'bfloat16' / 'float32' (the JAX configs' dtype strings) -> torch."""
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(name)]
