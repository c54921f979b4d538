"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/<name>-<hash>.so`` (git-ignored),
then loaded with ``ctypes``.  The hash covers the source, every file it
includes by a quoted path (``#include "x.cuh"``, followed recursively) and
the flags, so an edited kernel or header rebuilds and an unchanged one is
reused.  Building happens at first use, never at import: machines without
``nvcc`` (the CPU test hosts) import every module and run the kernels'
plain versions instead.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def build_inputs(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every file it includes by a quoted path,
    recursively (paths relative to the including file, as ``nvcc`` looks
    them up first)."""
    seen: list[str] = []
    todo = [source_path(name)]
    while todo:
        path = os.path.normpath(todo.pop())
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as fh:
            text = fh.read()
        todo += [os.path.join(os.path.dirname(path), inc.decode())
                 for inc in _INCLUDE.findall(text)]
    return seen


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> str:
    """Where ``name``'s shared library lives once built (content-keyed)."""
    h = hashlib.sha256()
    for path in build_inputs(name):
        h.update(os.path.relpath(path, CSRC_DIR).encode() + b"\x00")
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built; the
    compiler's register/spill report lands in ``<library>.log``.  Returns
    the library path.  The build writes a private temp file and renames it
    into place, so no process ever loads a half-written library."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source_path(name)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        with open(so + ".log", "w") as fh:
            fh.write(proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(build(name))
        return lib
