"""Builds the package's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<digest>.so csrc/<name>.cu

``<digest>`` hashes the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  No ``--use_fast_math``:
the kernels rely on IEEE division and on accurate ``exp2f``/``logf``.
Builds happen at first use, never at import, and several sources build
in parallel through `build_all`.

The build directory ``_build/`` sits in the package and is git-ignored.
``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: kernel library name -> source, relative to the package
SOURCES: Dict[str, str] = {
    "int8_blockwise": os.path.join("csrc", "int8_blockwise.cu"),
    "flash_attention": os.path.join("csrc", "flash_attention.cu"),
}

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared",
                           "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(name: str) -> str:
    """Where `name`'s library lives for the current source and flags."""
    with open(os.path.join(_PKG_DIR, SOURCES[name]), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def nvcc_command(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(_PKG_DIR, SOURCES[name])]


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (final path, tmp path, process) with process None when up to date."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    proc = subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(rc={proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all(names: Sequence[str] = ()) -> Dict[str, str]:
    """Build every named library (default: all) with one nvcc each, all
    started together; returns {name: library path}."""
    names = list(names) or list(SOURCES)
    started = {n: _start(n) for n in names}
    for n, (out, tmp, proc) in started.items():
        _finish(n, out, tmp, proc)
    return {n: started[n][0] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            _LIBS[name] = lib
        return lib
