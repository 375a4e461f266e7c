"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host code)
has a plain C interface and is compiled on first use into
``basic_pitch_torch/build/`` (listed in ``.gitignore``), then loaded with
ctypes: a ``.cu`` with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC``, a ``.cpp`` with ``g++ -O3 -shared -fPIC`` (no
``-march=native``: a build directory shared between machines must not hold
another host's instructions, and the packer's float rounding must be the
JAX package's). The library name carries a hash of the source, of every
``csrc/`` header it includes (``#include "..."``, followed recursively) and
of the flags, so an edited source or header is rebuilt and concurrent
builders never see a half-written file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-shared", "-fPIC")  # the JAX package's native build

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates: List[str] = []
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH")


def cxx_path() -> str:
    """The host C++ compiler: g++ on PATH."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host libraries need a C++ compiler on PATH")
    return found


def source(name: str) -> pathlib.Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _is_cuda(name: str) -> bool:
    return source(name).suffix == ".cu"


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> List[pathlib.Path]:
    """`source(name)` and the ``csrc/`` files it includes, recursively."""
    found: List[pathlib.Path] = []
    pending = [source(name)]
    while pending:
        path = pending.pop()
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            pending.append(path.parent / inc.decode())
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the built library for `source(name)` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS if _is_cuda(name) else HOST_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile `source(name)` unless its library is already built."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        if _is_cuda(name):
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source(name))]
        else:
            cmd = [cxx_path(), *HOST_FLAGS, "-o", tmp, str(source(name))]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {source(name).name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load `source(name)`'s library (once per process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
