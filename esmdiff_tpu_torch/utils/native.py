"""Builds and loads the port's host C++ libraries: the TM-score search (the
port's own copy, ``esmdiff_tpu_torch/csrc/host/tmscore.cpp``, whose
superposition is repaired) and the PDB parser (``native/pdbio/pdbio.cpp``).

``native/`` lies outside the JAX package (``esmdiff_tpu/``): compiling its
sources with ``g++`` imports nothing of that package.  Each source is
compiled at first use with the flags of the ``native/*/Makefile``s
(``-O3 -fPIC -std=c++17 -march=native -shared``) into the port's own
``build/torch_ext/`` (git-ignored; ``native/*/build/`` is never written).
The library's name carries a hash of the source, the flags and the host:
``-march=native`` ties a library to its CPU, so one built on another
machine is not loaded.  A missing ``g++`` or a failed compile raises, with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
# sources the port keeps its own copy of: name -> path
PORT_SOURCES = {"tmscore": ROOT / "esmdiff_tpu_torch" / "csrc" / "host"
                / "tmscore.cpp"}
BUILD_DIR = ROOT / "build" / "torch_ext"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-march=native", "-shared"]

build_seconds: dict[str, float] = {}   # source name -> seconds of its g++
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _host() -> str:
    """The machine and its CPU model: what ``-march=native`` resolves
    against."""
    model = platform.processor()
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text(errors="replace").splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    return f"{platform.machine()} {model}"


def source(name: str) -> Path:
    """The C++ source of library ``name``: the port's own copy, else
    ``native/<name>/<name>.cpp``."""
    return PORT_SOURCES.get(name) or NATIVE / name / f"{name}.cpp"


def library_path(name: str) -> Path:
    """``build/torch_ext/lib<name>_<hash>.so`` for ``source(name)``."""
    src = source(name)
    digest = hashlib.sha1(" ".join([*CXX_FLAGS, _host()]).encode())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>/<name>.cpp``, compiled first
    if this host has not built it yet."""
    with _lock:
        if name in _libs:
            return _libs[name]
        so = library_path(name)
        if not so.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"g++ not found: it builds {source(name)}")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            t0 = time.time()
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(source(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{source(name)}: g++ exit code "
                                   f"{proc.returncode}:\n{proc.stdout}")
            os.replace(tmp, so)
            build_seconds[name] = time.time() - t0
        _libs[name] = ctypes.CDLL(str(so))
        return _libs[name]
