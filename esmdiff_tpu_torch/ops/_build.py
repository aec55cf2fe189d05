"""Builds and calls the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers: seconds per
build), at first use, into ``build/torch_ext/`` (git-ignored), keyed by a
hash of the source, the shared headers and the flags.  ``nvcc``'s output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library and in ``logs``.  Libraries are loaded with ctypes.

Every C entry point launches on the given stream, does not synchronise and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

logs: dict[str, str] = {}   # source name -> nvcc output
_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # the server's threads may reach a first use


def _library(name: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(*names: str) -> None:
    """Compile the named sources that are not built yet, one ``nvcc`` each,
    all started together; raise if any fails."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    jobs = {}
    for name in names:
        so = _library(name)
        if so.exists():
            logs.setdefault(name, so.with_suffix(".log").read_text())
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        jobs[name] = (so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc exit code {proc.returncode}:\n"
                          f"{logs[name]}")
            continue
        so.with_suffix(".log").write_text(logs[name])
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def _load(name: str) -> ctypes.CDLL:
    with _load_lock:
        if name not in _libs:
            build(name)
            lib = ctypes.CDLL(str(_library(name)))
            lib.esmdiff_cuda_error_string.restype = ctypes.c_char_p
            lib.esmdiff_cuda_error_string.argtypes = [INT]
            _libs[name] = lib
        return _libs[name]


def launch(name: str, entry: str, argtypes: list, device: torch.device,
           *args) -> None:
    """Call C entry point ``entry`` of ``csrc/<name>.cu`` with ``args``
    followed by PyTorch's current stream on ``device``, and raise if the
    launch failed."""
    fn = getattr(_load(name), entry)
    fn.restype = INT
    fn.argtypes = [*argtypes, PTR]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _libs[name].esmdiff_cuda_error_string(err).decode())
