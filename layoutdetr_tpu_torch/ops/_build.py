"""Build the port's native sources and load them with ctypes.

Each CUDA source under ``ops/csrc/`` has a plain C interface and is
compiled on first use into a shared library for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so <src>.cu

A host C++ source (``data/csrc/fastdata.cpp``) goes through the same
steps with the host compiler (``g++ -O3 -shared -fPIC``, ``CXX`` if set):
``build_host``.

The library lands in ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and the
command's flags, so an edited source is rebuilt and an unchanged one is
reused. The compiler's report (for nvcc: registers, shared memory,
spills) is kept beside it as ``<lib>.log``. Nothing is compiled or loaded
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC")

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def host_compiler() -> str:
    """``CXX`` if set, else ``g++`` on PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or put g++ on PATH")
    return cxx


def _library_path(src: str, flags: Sequence[str]) -> str:
    name = os.path.splitext(os.path.basename(src))[0]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile(src: str, compiler: str, flags: Sequence[str], libs: Sequence[str] = ()) -> str:
    """``compiler flags -o <lib> src libs`` unless the library exists;
    return its path."""
    out = _library_path(src, (*flags, *libs))
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, "-o", tmp, src, *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    with open(tmp + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp + ".log", out + ".log")
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {os.path.basename(src)}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    return _compile(os.path.join(CSRC, f"{name}.cu"), _nvcc(), NVCC_FLAGS)


def build_host(src: str, libs: Sequence[str] = ()) -> str:
    """Compile the host C++ source ``src`` (linked with ``libs``) unless its
    library exists; return its path."""
    return _compile(src, host_compiler(), HOST_FLAGS, libs)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(build(name))
    return lib
